"""bf16 mixed precision for the decoder Trainer (`use_amp`).

Counterpart of fresnel_tpu/utils/precision.py.  The parameters and the
optimizer state stay float32 (the master weights); inside the loss a
module runs on bf16 copies of its parameters and of its positional
inputs, and its float outputs come back as float32, so SAAG, the render
and the losses stay float32.  The casts are differentiable: autograd
returns the gradient of a bf16 copy to its float32 parameter as float32,
as `convert_element_type`'s transpose does in JAX.  bf16 keeps float32's
exponent range, so no loss scaling is needed.

Not `torch.autocast`, which picks per op which ops run in bf16: here
every parameter and every input is rounded, and each op runs in the dtype
its operands give it, as JAX's promotion rules do (a bf16 tensor meeting
a float32 one of one dimension or more becomes float32; the modules cast
explicitly where a 0-d float32 tensor would promote in JAX and not in
torch).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.func import functional_call


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating-point tensor of a nest of dicts, lists and tuples
    cast to `dtype`; other leaves (integer and bool tensors, Python
    scalars, None) as they are."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def to_bf16(tree: Any) -> Any:
    """Float leaves to bfloat16 (the compute precision)."""
    return cast_floats(tree, torch.bfloat16)


def to_f32(tree: Any) -> Any:
    """Float leaves back to float32 (the loss and master precision)."""
    return cast_floats(tree, torch.float32)


def amp_apply(module: torch.nn.Module, params: dict, *args: Any,
              use_amp: bool = True, **kwargs: Any) -> Any:
    """`module(*args, **kwargs)` with `params` ({name: tensor}, through
    `torch.func.functional_call`), in bf16: the parameters and the
    positional arguments cast to bf16, the keyword arguments as they are,
    every float output cast back to float32.  With use_amp False, the
    plain call."""
    if not use_amp:
        return functional_call(module, params, args, kwargs)
    return to_f32(functional_call(module, to_bf16(params), to_bf16(args),
                                  kwargs))
