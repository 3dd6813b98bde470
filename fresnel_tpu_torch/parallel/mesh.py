"""Device mesh and data-parallel helpers on torch.distributed.

Counterpart of fresnel_tpu/parallel/mesh.py, one process per device: a
`DeviceMesh` over the process group (1-D "data" by default, 2-D for
tensor parallelism), this rank's rows of a global batch, a broadcast from
rank 0, and one all-reduce-average of a gradient dict through a flat
buffer.  The JAX package lets XLA partition a global step; here each rank
runs the step on its rows, so what couples the batch is made global by
hand.  `data_parallel_step` runs a step under `batch_shard`, which names
the step's `Shard` (its group, this rank, the world), as shard_map names
the axis of JAX's per-shard step.  `step_shard()` reads it; the Trainer
reads it and hands it down explicitly:

* draws with a batch axis go through `RowGenerator` (the decoders'
  dropout masks, experiment 5's update masks: `rand_rows`), which draws
  the global shape from a generator identically seeded on every rank and
  keeps the rank's rows, so they equal world 1's draws;
* batch-coupled reductions go through `global_sum` (differentiable: the
  backward sums the cotangent over ranks, which with the gradient average
  gives the global batch's gradient), `global_max` and `batch_mean`;
* `pmean_gradients` averages the gradients (and the loss terms handed in
  with them) over the running step's ranks.

Given no shard (None) every helper is the identity or the plain draw.
The process group is joined by `parallel.launch.init_distributed`: NCCL
for CUDA tensors, gloo for CPU tensors (or CUDA tensors through host
copies, as when two ranks share one card).  `ALLREDUCE_STATS` counts the
calls and bytes of `pmean_gradients` and, with `ALLREDUCE_STATS["timed"]`
set, the seconds of each (the device synchronised around it).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from fresnel_tpu_torch.device import resolve_device

ALLREDUCE_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "timed": False}


class Shard(NamedTuple):
    """The ranks a data-parallel step's batch is split over."""
    group: object           # the process group of the mesh axis
    rank: int               # this rank's place in it
    world: int              # its size


# The running data-parallel step's Shard (`batch_shard`), else None.
_SHARD: Optional[Shard] = None


def get_mesh(num_devices: Optional[int] = None,
             axis_names: Sequence[str] = ("data",),
             shape: Optional[Sequence[int]] = None,
             device_type: Optional[str] = None):
    """A DeviceMesh over the ranks of the joined process group.

    Default: 1-D data-parallel mesh over every rank.  Pass shape +
    axis_names for 2-D meshes (e.g. shape=(2, 2), axis_names=("data",
    "model")).  `num_devices` must be the world size (one process per
    device); more devices than ranks raises ValueError, as JAX's
    get_mesh fails for more devices than it has.  `device_type` is
    resolved as the entry points resolve a device: None means "cuda"
    (an error where CUDA is absent), "cpu" must be asked for."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("get_mesh needs a process group: call "
                           "parallel.launch.init_distributed first")
    world = dist.get_world_size()
    if num_devices is None:
        num_devices = world
    if num_devices != world:
        raise ValueError(f"a mesh of {num_devices} devices needs {num_devices}"
                         f" ranks; this process group has {world}")
    if shape is None:
        shape = (num_devices,)
    if int(np.prod(shape)) != num_devices or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} with axes "
                         f"{tuple(axis_names)} does not cover {num_devices} "
                         "devices")
    return init_device_mesh(resolve_device(device_type).type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def _axis(mesh, axis: str) -> Shard:
    """The Shard of one mesh axis."""
    group = mesh.get_group(axis)
    return Shard(group, dist.get_rank(group), dist.get_world_size(group))


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's rows of a global batch: every array or tensor of one or
    more dimensions keeps rows [rank * B / n, (rank + 1) * B / n) of its
    leading axis, over the n ranks of `axis`.  Scalars (e.g. the
    distill_scale knob) pass through.  A leading axis that n does not
    divide raises ValueError, as jax.device_put refuses it.  Dicts,
    tuples and lists keep their type."""
    _, rank, n = _axis(mesh, axis)

    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(rows(v) for v in x)
        if not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim == 0:
            return x
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch axis {B} is not divisible by the "
                             f"{n} devices of mesh axis '{axis}'")
        b = B // n
        return x[rank * b:(rank + 1) * b]

    return rows(batch)


def replicate(tree, mesh, axis: Optional[str] = None):
    """Every tensor of a nested dict broadcast from the mesh's first rank
    (of `axis`, or of the whole mesh), in place; the tree is returned."""
    group = mesh.get_group(axis) if axis else None
    src = dist.get_global_rank(group, 0) if group is not None else 0

    def bcast(x):
        if isinstance(x, dict):
            for v in x.values():
                bcast(v)
        elif isinstance(x, torch.Tensor):
            dist.broadcast(x, src, group=group)

    with torch.no_grad():
        bcast(tree)
    return tree


@contextlib.contextmanager
def batch_shard(mesh, axis: str = "data"):
    """Run a per-shard step as part of a data-parallel step over `axis`:
    `step_shard()` returns its Shard while the step runs."""
    global _SHARD
    prev = _SHARD
    _SHARD = _axis(mesh, axis)
    try:
        yield _SHARD
    finally:
        _SHARD = prev


def step_shard() -> Optional[Shard]:
    """The running data-parallel step's Shard; None outside one."""
    return _SHARD


class RowGenerator:
    """Uniform draws for this rank's `rows` rows of a batch split over
    `shard`: `rand` draws the global shape (the batch axis times the
    world) from `generator`, identically seeded on every rank, and keeps
    this rank's slice, so every rank's generator advances as world 1's
    does and the rows equal world 1's.  The batch axis may fold further
    axes after the batch (batch-major, as (B * H * W, C) rows do): a
    size that `rows` does not divide is not the batch's, and raises."""

    def __init__(self, generator: Optional[torch.Generator], shard: Shard,
                 rows: int):
        self.generator, self.shard, self.rows = generator, shard, rows

    def rand(self, shape, device=None, batch_dim: int = 0) -> torch.Tensor:
        shape = list(shape)
        b = shape[batch_dim]
        if b % self.rows:
            raise ValueError(
                f"a draw of shape {tuple(shape)} has {b} rows on axis "
                f"{batch_dim}, not batch-major over the step's {self.rows}"
                " batch rows")
        shape[batch_dim] = b * self.shard.world
        full = torch.rand(shape, generator=self.generator, device=device)
        return full.narrow(batch_dim, self.shard.rank * b, b)


def rand_rows(shape, generator=None, device=None,
              batch_dim: int = 0) -> torch.Tensor:
    """torch.rand(shape) from `generator`, a torch.Generator (or None, the
    device's default one) or a `RowGenerator` (this rank's rows of the
    global draw, `batch_dim` being the batch's axis)."""
    if isinstance(generator, RowGenerator):
        return generator.rand(shape, device, batch_dim)
    return torch.rand(shape, generator=generator, device=device)


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the
    cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The sum of `x` over the ranks of `shard` (x itself for None);
    differentiable."""
    if shard is None:
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x, shard.group)
    y = x.clone()
    dist.all_reduce(y, group=shard.group)
    return y


def global_max(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The elementwise max of `x` over the ranks of `shard`; not
    differentiable."""
    if shard is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=shard.group)
    return y


def batch_mean(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """x.mean(dim=0) over the global batch: the local rows' sum, summed
    over the ranks of `shard` (None: this process's rows alone), over the
    global row count."""
    n = x.shape[0] * (1 if shard is None else shard.world)
    return global_sum(x.sum(dim=0), shard) / n


def pmean_gradients(grads, axis: str = "data"):
    """The average over the running step's ranks of a {name: tensor or
    None} dict, through one all-reduce of a flat float32 buffer (None
    stays None).  Identity outside a data-parallel step.  `axis` is
    accepted for JAX's signature: the step's axis is the one
    `batch_shard` was given."""
    if _SHARD is None:
        return grads
    group, _, n = _SHARD
    names = [k for k, v in grads.items() if v is not None]
    flat = torch.cat([grads[k].detach().reshape(-1).to(torch.float32)
                      for k in names])
    timed = ALLREDUCE_STATS["timed"]
    if timed:
        _sync(flat)
        t0 = time.perf_counter()
    dist.all_reduce(flat, group=group)
    if timed:
        _sync(flat)
        ALLREDUCE_STATS["seconds"] += time.perf_counter() - t0
    ALLREDUCE_STATS["calls"] += 1
    ALLREDUCE_STATS["bytes"] += flat.numel() * flat.element_size()
    flat = flat / n
    out = dict(grads)
    i = 0
    for k in names:
        v = grads[k]
        out[k] = flat[i:i + v.numel()].view(v.shape).to(v.dtype)
        i += v.numel()
    return out


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def data_parallel_step(step_fn: Callable, mesh, axis: str = "data"
                       ) -> Callable:
    """Wrap a per-shard train step into a data-parallel one: the step runs
    on this rank's batch rows under `batch_shard(mesh, axis)`, where it
    performs its own `pmean_gradients` (as JAX's per-shard step performs
    its own pmean under shard_map)."""
    @functools.wraps(step_fn)
    def step(*args, **kwargs):
        with batch_shard(mesh, axis):
            return step_fn(*args, **kwargs)
    return step


def jit_data_parallel(step_fn: Callable, donate_state: bool = True,
                      mesh=None, axis: str = "data") -> Callable:
    """JAX's signature shim: there the step is jitted and XLA reads the
    mesh from the inputs' placement; here the mesh is given, and the step
    is `data_parallel_step(step_fn, mesh, axis)` (step_fn itself without
    one).  `donate_state` is accepted and unused (the step returns fresh
    tensors either way)."""
    if mesh is None:
        return step_fn
    return data_parallel_step(step_fn, mesh, axis)
