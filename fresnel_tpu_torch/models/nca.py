"""NCAGaussianDecoder (experiment 5): neural-cellular-automaton
refinement of spiral-placed Gaussians.

Counterpart of fresnel_tpu/models/nca.py: an init-state net over the
features sampled at the Fibonacci spiral (the spiral and its samples as
models.fibonacci rounds them), then `n_steps` of {kNN perceive (the k
nearest other points) -> update MLP -> a stochastic residual update with a
learned step size}, parsed into [pos 3, scale 3, rot6d 6, colour 3,
opacity 1] with Z locked to the depth.  The submodules carry the Flax
names (`init_state_net.layers_0` is `init_state_net.0`).

The stochastic update masks are an argument: with deterministic=False the
caller passes `masks` (steps, B, N, 1), or they are drawn from
`generator` (p = update_prob; a `parallel.mesh.RowGenerator` draws a
data-parallel step's global masks and keeps this rank's rows); the tests
hand both sides the JAX package's draws.  The neighbours come from a stable ascending sort of the
distances, which breaks ties toward the lower index as `lax.top_k` does
(`torch.topk` promises no order for ties); the distances are computed
without gradient, as top_k's indices carry none.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.core.gaussians import rotation_6d_to_quaternion
from fresnel_tpu_torch.models.blocks import Linear, ZeroInitLinear, spiral_table
from fresnel_tpu_torch.models.fibonacci import _spiral_samples
from fresnel_tpu_torch.parallel.mesh import rand_rows


def knn_indices(pos: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, 3) positions -> (B, N, k) indices of each point's k nearest
    other points, nearest first, ties to the lower index (the point
    itself, at distance sqrt(1e-12), is dropped)."""
    with torch.no_grad():
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        dists = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        order = torch.sort(dists, dim=-1, stable=True).indices
    return order[..., 1:k + 1]


class NCAGaussianDecoder(nn.Module):
    def __init__(self, feature_dim: int = 384, n_points: int = 377,
                 n_steps: int = 16, k_neighbors: int = 6,
                 hidden_dim: int = 128, update_prob: float = 0.5,
                 state_dim: int = 16, step_size: float = 0.1):
        super().__init__()
        h, d = hidden_dim, state_dim
        self.n_points, self.n_steps = n_points, n_steps
        self.k_neighbors, self.update_prob = k_neighbors, update_prob
        self.init_state_net = nn.Sequential(
            Linear(feature_dim, h * 2), nn.ReLU(), Linear(h * 2, h),
            nn.ReLU(), Linear(h, d))
        self.perception = nn.Sequential(
            Linear(d * (k_neighbors + 1), h * 2), nn.ReLU(),
            Linear(h * 2, h), nn.ReLU())
        # The update rule's output starts at zero: residual learning.
        self.update_hidden = Linear(h, h)
        self.update_out = ZeroInitLinear(h, d)
        self.step_size = nn.Parameter(torch.tensor(float(step_size)))
        self.depth_offset = nn.Parameter(torch.tensor(-2.0))

    def _nca_step(self, state: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
        """state (B, N, D); mask (B, N, 1) the stochastic update gate."""
        B, N, D = state.shape
        idx = knn_indices(state[..., :3], self.k_neighbors)    # (B, N, k)
        b = torch.arange(B, device=state.device)[:, None, None]
        neighbors = state[b, idx]                               # (B, N, k, D)
        perceived = self.perception(
            torch.cat([state, neighbors.reshape(B, N, -1)], -1))
        delta = self.update_out(F.relu(self.update_hidden(perceived)))
        return state + self.step_size * (delta * mask)

    def forward(self, features: torch.Tensor,             # (B, 37, 37, C)
                depth: Optional[torch.Tensor] = None,
                num_gaussians: Optional[int] = None,
                elevation: Optional[torch.Tensor] = None,
                azimuth: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                n_steps: Optional[int] = None,
                masks: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """`num_gaussians`, `elevation` and `azimuth` are accepted and
        ignored, as in the JAX module.  The update masks apply only with
        deterministic=False."""
        steps = self.n_steps if n_steps is None else n_steps
        B = features.shape[0]
        N = self.n_points
        state = self.init_state_net(_spiral_samples(features, N))

        if depth is not None:
            d = depth[..., 0] if depth.dim() == 4 else depth
            d_sampled = _spiral_samples(d[..., None], N)[..., 0]
        else:
            d_sampled = torch.zeros((B, N), device=features.device)
        table = spiral_table(N, features.device)
        base_z = self.depth_offset + d_sampled * (-2.0)
        state = torch.cat([
            (table[0] + state[..., 0].detach() * 0.15)[..., None],
            (table[1] + state[..., 1].detach() * 0.15)[..., None],
            base_z[..., None],                       # Z locked to the depth
            state[..., 3:]], -1)

        if deterministic:
            masks = torch.ones((steps, B, N, 1), device=state.device)
        elif masks is None:
            masks = (rand_rows((steps, B, N, 1), generator, state.device,
                               batch_dim=1)
                     < self.update_prob).to(state.dtype)
        for s in range(steps):
            state = self._nca_step(state, masks[s])

        scales = torch.clamp(
            F.softplus(torch.clamp(state[..., 3:6], -10.0, 20.0) + 1.0)
            * 0.15, 1e-6, 2.0)
        return {"positions": state[..., 0:3], "scales": scales,
                "rotations": rotation_6d_to_quaternion(state[..., 6:12]),
                "colors": torch.sigmoid(state[..., 12:15]),
                "opacities": torch.sigmoid(state[..., 15])}
