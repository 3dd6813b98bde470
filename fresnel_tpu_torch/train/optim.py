"""The decoder trainer's optimizer: global-norm clip, AdamW, cosine decay.

Counterpart of the JAX trainer's
`optax.chain(clip_by_global_norm(1.0), adamw(schedule, weight_decay))`
(fresnel_tpu/train/harness.py:209-217), as functions over a dict of
tensors {name: parameter}, with the rules of optax 0.2:
* clip: the gradients are left alone while their global norm is below
  `MAX_NORM`, else scaled by MAX_NORM / norm (torch's clip_grad_norm_
  always scales, by max_norm / (norm + 1e-6), so it is not used);
* AdamW: b1 0.9, b2 0.999, eps 1e-8; bias correction from the incremented
  count; every leaf decays, biases and norms included;
* the cosine schedule is closed form, lr * 0.5 * (1 + cos(pi * min(c, n) /
  n)), read at the count before the increment (step 0 takes the full lr);
* the guard: a step whose loss or any gradient is not finite leaves the
  parameters, the moments and the count (so the schedule) as they were.

Everything stays on the parameters' device: the guard is a `torch.where`
over the update, never a host read.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_NORM = 1.0


def cosine_lr(count: torch.Tensor, lr: float, decay_steps: int
              ) -> torch.Tensor:
    """optax.cosine_decay_schedule(lr, decay_steps) at `count`."""
    c = torch.clamp(count, max=decay_steps).to(torch.float32)
    return lr * (0.5 * (1.0 + torch.cos(math.pi * c / decay_steps)))


class AdamWClip:
    """clip_by_global_norm(MAX_NORM) then adamw(schedule, weight_decay).

    `init(params)` gives the state {"count": int32 scalar, "mu": {...},
    "nu": {...}}; `update(params, grads, state, loss)` returns the new
    (params, state), both dicts of fresh tensors."""

    def __init__(self, lr: float, total_steps: int, weight_decay: float,
                 schedule: str = "cosine"):
        self.lr = lr
        self.total_steps = max(int(total_steps), 1)
        self.weight_decay = weight_decay
        self.schedule = schedule

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        dev = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        if self.schedule == "constant":
            return torch.full((), self.lr, dtype=torch.float32,
                              device=count.device)
        return cosine_lr(count, self.lr, self.total_steps)

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, Optional[torch.Tensor]], state: Dict,
               loss: Optional[torch.Tensor] = None):
        names = list(params)
        g = [grads[k] if grads.get(k) is not None
             else torch.zeros_like(params[k]) for k in names]
        finite = torch.stack([torch.isfinite(x).all() for x in g]).all()
        if loss is not None:
            finite = finite & torch.isfinite(loss)
        g = [torch.where(finite, x, torch.zeros_like(x)) for x in g]
        norm = torch.sqrt(sum((x * x).sum() for x in g))
        keep = norm < MAX_NORM
        g = [torch.where(keep, x, x / norm * MAX_NORM) for x in g]

        count = state["count"]
        count_inc = count + 1
        c = count_inc.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(B1, device=c.device), c)
        bc2 = 1.0 - torch.pow(torch.tensor(B2, device=c.device), c)
        step = -self.learning_rate(count)
        new_params, mu, nu = {}, {}, {}
        for k, x in zip(names, g):
            p = params[k]
            m = (1 - B1) * x + B1 * state["mu"][k]
            v = (1 - B2) * (x * x) + B2 * state["nu"][k]
            u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            u = u + self.weight_decay * p
            new_params[k] = torch.where(finite, p + u * step, p)
            mu[k] = torch.where(finite, m, state["mu"][k])
            nu[k] = torch.where(finite, v, state["nu"][k])
        new_count = torch.where(finite, count_inc, count)
        return new_params, {"count": new_count, "mu": mu, "nu": nu}
