"""LPIPS perceptual distance (AlexNet trunk), float32.

Counterpart of fresnel_tpu/losses/lpips.py: the AlexNet feature stack of
`lpips.LPIPS(net='alex', spatial=False)`, the ScalingLayer's shift and
scale, per layer the channel unit-normalisation x / (||x|| + 1e-10), the
squared difference, the non-negative 1x1 `lin{i}` weights and the spatial
mean, summed over the five layers.

Weights come from a file (`load_lpips`: strict, None when there is no
file): a torch checkpoint in the lpips package's naming
(`net.slice{s}.{j}.weight`, `lin{i}.model.1.weight`) or torchvision's
(`features.{j}.weight`, `lins.{i}` / `lin{i}`), convs ordered by their
numeric torchvision index (0, 3, 6, 8, 10), `lin` clamped to >= 0; or an
`.npz` of the JAX package's Flax names (`trunk/conv{i}/kernel` as (kH,
kW, I, O), `trunk/conv{i}/bias`, `lin{i}`).  `random_lpips(seed)` builds
the same stack with fixed random filters, for runs without a file.

The module's parameters never train (`requires_grad` False, eval mode):
the training step differentiates through it into the render only.  The
convolutions are `F.conv2d` through `core.ops.Conv2d`; on the card they
follow the caller's TF32 flags, which the package does not set.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.core.ops import Conv2d

# AlexNet conv stages: (out_channels, kernel, stride, padding), torchvision
# alexnet.features convs at global indices 0, 3, 6, 8, 10.
_ALEX_CFG = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = (0, 1)   # 3x3 stride-2 VALID max-pool after stages 0 and 1

# lpips ScalingLayer constants (fixed buffers, not trained).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class AlexFeatures(nn.Module):
    """AlexNet conv trunk: (B, 3, H, W) -> the five ReLU activations."""

    def __init__(self):
        super().__init__()
        in_c = 3
        for i, (c, k, s, p) in enumerate(_ALEX_CFG):
            self.add_module(f"conv{i}", Conv2d(in_c, c, k, stride=s,
                                               padding=p))
            in_c = c

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i in range(len(_ALEX_CFG)):
            x = F.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, stride=2)
        return feats


class LPIPS(nn.Module):
    """img1, img2: (B, 3, H, W) in [-1, 1] -> (B,) distances."""

    def __init__(self):
        super().__init__()
        self.trunk = AlexFeatures()
        for i, (c, _, _, _) in enumerate(_ALEX_CFG):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).reshape(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).reshape(
            1, 3, 1, 1), persistent=False)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor
                ) -> torch.Tensor:
        f1 = self.trunk((img1 - self.shift) / self.scale)
        f2 = self.trunk((img2 - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(f1, f2)):
            a = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True))
                     + 1e-10)
            b = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True))
                     + 1e-10)
            diff = (a - b) ** 2                              # (B, C, h, w)
            lin = torch.einsum("bchw,c->bhw", diff, getattr(self, f"lin{i}"))
            total = total + lin.mean(dim=(1, 2))
        return total


def _ready(model: LPIPS, device) -> LPIPS:
    from fresnel_tpu_torch.device import resolve_device
    return model.to(resolve_device(device)).eval().requires_grad_(False)


def random_lpips(seed: int = 0, device=None) -> LPIPS:
    """LPIPS with fixed random filters (conv kernels lecun-normal from a
    torch generator seeded with `seed`, biases zero, `lin` one, as the JAX
    package's Flax init lays them out), on `device` (CUDA when None)."""
    from fresnel_tpu_torch.weights import init_flax_like_
    model = LPIPS()
    init_flax_like_(model, torch.Generator().manual_seed(seed))
    return _ready(model, device)


def load_lpips(weights_path: Optional[str] = None, device=None
               ) -> Optional[LPIPS]:
    """LPIPS with the file's weights on `device` (CUDA when None), or None
    when `weights_path` is None or does not exist.  An `.npz` holds the
    JAX package's flat Flax names; any other file is a torch checkpoint
    (`convert_torch_lpips`).  Strict: every parameter filled and nothing
    left over, else ValueError."""
    from fresnel_tpu_torch.models.vit import load_state_dict_strict
    from fresnel_tpu_torch.weights import lpips_state_dict

    if weights_path is None or not os.path.exists(weights_path):
        return None
    if weights_path.endswith(".npz"):
        with np.load(weights_path) as z:
            flat = {k: z[k] for k in z.files}
    else:
        flat = convert_torch_lpips(weights_path)
    model = LPIPS()
    load_state_dict_strict(model, lpips_state_dict(flat))
    return _ready(model, device)


def convert_torch_lpips(path: str) -> Dict[str, np.ndarray]:
    """A torch LPIPS (alex) state dict -> the JAX package's flat Flax
    names: `trunk/conv{i}/kernel` (kH, kW, I, O), `trunk/conv{i}/bias`,
    `lin{i}` (C,) clamped to >= 0.  Reads the lpips package's naming
    (`net.slice{s}.{j}.weight`, `lin{i}.model.1.weight` of shape (1, C, 1,
    1)) and torchvision's (`features.{j}.weight`, with `lins.{i}` or
    `lin{i}` in the same dict); convs ordered by their numeric torchvision
    index, not by string.  Raises ValueError unless there are five convs
    with AlexNet's channel counts and lin0..lin4."""
    from fresnel_tpu_torch.models.vit import load_torch_state_dict

    sd = load_torch_state_dict(path)
    convs: Dict[int, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        m = re.match(r"^(?:net\.slice\d+|features)\.(\d+)\.(weight|bias)$", k)
        if m and (m.group(2) == "bias" or v.ndim == 4):
            convs.setdefault(int(m.group(1)), {})[m.group(2)] = v
    if len(convs) != 5:
        raise ValueError(
            f"expected 5 AlexNet convs in {path}, found indices "
            f"{sorted(convs)} — not an lpips-alex checkpoint")
    flat: Dict[str, np.ndarray] = {}
    for i, j in enumerate(sorted(convs)):
        entry = convs[j]
        kernel = entry["weight"].transpose(2, 3, 1, 0)
        if kernel.shape[-1] != _ALEX_CFG[i][0]:
            raise ValueError(
                f"conv{i} has {kernel.shape[-1]} channels, expected "
                f"{_ALEX_CFG[i][0]}")
        flat[f"trunk/conv{i}/kernel"] = kernel
        flat[f"trunk/conv{i}/bias"] = entry["bias"]

    lins: Dict[int, np.ndarray] = {}
    for k, v in sd.items():
        m = re.match(r"^lins?\.?(\d+)(?:\.model\.1)?\.weight$", k)
        if m:
            lins[int(m.group(1))] = v.reshape(-1)
    if sorted(lins) != [0, 1, 2, 3, 4]:
        raise ValueError(
            f"expected lin0..lin4 in {path}, found {sorted(lins)}")
    for i in range(5):
        flat[f"lin{i}"] = np.maximum(lins[i], 0.0)
    return flat
