"""Tensor parallelism: weight sharding over a 2-D ("data", "model") mesh.

Counterpart of fresnel_tpu/parallel/tp.py, on DTensor: each large leaf of
a train state is laid out over the "model" axis along its largest
divisible dimension (`Shard(dim)`), and replicated over every other axis;
leaves too small to matter (scalars, small biases, step counters) stay
replicated.  DTensor's operators then insert the all-gathers and
reductions that XLA's partitioner inserts in the JAX package.  Specs are
per-dimension tuples of axis names or None, in the order of JAX's
`PartitionSpec` (`()` for replicated), so the two compare directly.

As in the JAX package, nothing trains on this path: the Trainer and the
rasterizer's hand-written autograd Functions (K1 / K2) take plain
tensors; the tests and the card's smoke take a gradient step of a small
network through it.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist


# Leaves smaller than this stay replicated: sharding tiny tensors buys no
# memory and costs a collective per use.  16 KiB f32 = 4096 elements.
_MIN_SHARD_ELEMS = 4096


def infer_leaf_spec(shape: tuple, tp: int, axis: str = "model",
                    min_elems: int = _MIN_SHARD_ELEMS) -> Tuple:
    """Megatron-style "largest divisible axis" rule for one tensor: the
    largest dimension that `tp` divides is sharded over `axis` (the
    first of equal ones); `()` (replicated) for scalars, leaves under
    `min_elems` and leaves with no divisible dimension."""
    shape = tuple(shape)
    size = 1
    for d in shape:
        size *= d
    if not shape or size < min_elems:
        return ()
    for dim in sorted(range(len(shape)), key=lambda d: shape[d],
                      reverse=True):
        if shape[dim] % tp == 0:
            spec = [None] * len(shape)
            spec[dim] = axis
            return tuple(spec)
    return ()


def _tree_map(fn, tree):
    """fn over the leaves of nested dicts, lists, tuples and named
    tuples (such as optax's states)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def infer_state_specs(state: Any, mesh, axis: str = "model",
                      min_elems: int = _MIN_SHARD_ELEMS) -> Any:
    """The spec of every leaf of a train state (params and optimizer
    moments), a tree of the state's structure.  `mesh` is a DeviceMesh or
    a {axis name: size} mapping."""
    tp = (mesh[axis] if isinstance(mesh, dict)
          else mesh.size(mesh.mesh_dim_names.index(axis)))
    return _tree_map(
        lambda x: infer_leaf_spec(tuple(getattr(x, "shape", ())), tp, axis,
                                  min_elems), state)


def _placements(spec: Tuple, mesh, axis: str = "model"):
    """DTensor placements of a spec on `mesh`: Shard(dim) on `axis` where
    the spec names it, Replicate on every other mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    if axis in spec:
        out[mesh.mesh_dim_names.index(axis)] = Shard(spec.index(axis))
    return out


def shard_state(state: Any, mesh, axis: str = "model",
                min_elems: int = _MIN_SHARD_ELEMS) -> Any:
    """The state's tensors as DTensors on `mesh` with the inferred specs
    (every rank passes the same full tensors, as `distribute_tensor`
    needs).  Batches still go through mesh.shard_batch over "data"."""
    from torch.distributed.tensor import distribute_tensor

    specs = infer_state_specs(state, mesh, axis, min_elems)

    def place(x, spec):
        if isinstance(x, dict):
            return {k: place(v, spec[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v, s) for v, s in zip(x, spec))
        if not isinstance(x, torch.Tensor):
            return x
        t = distribute_tensor(x.detach(), mesh,
                              _placements(spec, mesh, axis))
        return t.requires_grad_(x.requires_grad)

    return place(state, specs)


def full_tensor(x):
    """The whole tensor of a DTensor (anything else as it is), assembled
    with the list all_gather and the all_reduce of its mesh's groups.
    DTensor's own `full_tensor` gathers with all_gather_into_tensor,
    which crashes the process under gloo with CUDA tensors (torch 2.11),
    as when two ranks share one card."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    if not isinstance(x, DTensor):
        return x
    t = x.to_local().detach()
    for i, p in enumerate(x.placements):
        group = x.device_mesh.get_group(i)
        if isinstance(p, Partial):
            op = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
                  "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
            t = t.clone()
            dist.all_reduce(t, op=op[p.reduce_op], group=group)
            if p.reduce_op == "avg":
                t = t / dist.get_world_size(group)
        elif isinstance(p, Shard):
            parts = [torch.empty_like(t)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, dim=p.dim)
    return t


def sharded_fraction(state: Any, axis: str = "model") -> float:
    """Fraction of state elements actually distributed over `axis`
    (diagnostic: ~0 means the rule found nothing divisible)."""
    from torch.distributed.tensor import DTensor, Shard

    tot = 0
    sharded = 0
    for leaf in _leaves(state):
        n = leaf.numel() if isinstance(leaf, torch.Tensor) else 0
        tot += n
        if isinstance(leaf, DTensor):
            names = leaf.device_mesh.mesh_dim_names or ()
            if any(isinstance(p, Shard) and names[i] == axis
                   for i, p in enumerate(leaf.placements)):
                sharded += n
    return sharded / max(tot, 1)
