"""PyTorch/CUDA port of fresnel_tpu for one NVIDIA H100.

Mirrors the layout of `fresnel_tpu` (core/, render/, models/) so each
module's counterpart is easy to find.  Hand-written Hopper kernels live
under `csrc/` and are built at first use; plain PyTorch versions of each
kernel serve CPU tensors (the tests) and the on-card comparisons.

The package imports torch and numpy only: never jax, flax or fresnel_tpu.
"""

from fresnel_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
