"""Learned Fresnel edge detector: depth-discontinuity strength in [0, 1].

Counterpart of fresnel_tpu/physics/edge_detector.py::FresnelEdgeDetector:
the depth and, with `use_depth_gradients`, its Sobel x / y gradients as
channels, then three 3x3 SAME convolutions (ReLU, ReLU, none) and a
sigmoid.  Channels-last in and out, NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.core.ops import Conv2d
from fresnel_tpu_torch.physics.fresnel_zones import sobel_gradients


class FresnelEdgeDetector(nn.Module):
    """depth (B, H, W) or (B, H, W, 1) -> edge strength (B, H, W, 1).
    `conv0`..`conv2` are Flax's `Conv_0`..`Conv_2`."""

    def __init__(self, hidden_channels: int = 16,
                 use_depth_gradients: bool = True):
        super().__init__()
        self.use_depth_gradients = use_depth_gradients
        c_in = 3 if use_depth_gradients else 1
        self.conv0 = Conv2d(c_in, hidden_channels, 3, padding=1)
        self.conv1 = Conv2d(hidden_channels, hidden_channels, 3, padding=1)
        self.conv2 = Conv2d(hidden_channels, 1, 3, padding=1)

    def forward(self, depth: torch.Tensor) -> torch.Tensor:
        if depth.dim() == 4:
            depth = depth[..., 0]
        x = depth[:, None]
        if self.use_depth_gradients:
            gx, gy = sobel_gradients(depth)
            x = torch.cat([x, gx[:, None], gy[:, None]], dim=1)
        x = F.relu(self.conv0(x))
        x = F.relu(self.conv1(x))
        return torch.sigmoid(self.conv2(x)).permute(0, 2, 3, 1)
