"""Rank programs of `parallel.launch.run_job`.

Each takes its task dict and the rank's device, runs on every rank of the
joined process group, and returns what this rank computed (tensors on the
CPU); the parent that started the ranks compares them.  They drive the
parallel layer through its public entry points:

* `mesh_units`: `shard_batch`, `replicate` and `pmean_gradients` on
  rank-dependent inputs.
* `train_steps`: data-parallel (or single-process) `Trainer.train_step`s
  from given parameters on given global host batches, with given draws
  (poses, stochastic-K indices) where the task hands them in.
* `fit`: `Trainer.fit(..., mesh=get_mesh())` on a dataset, each step's
  loss and time recorded.
* `gradients`: `Trainer.gradients` of a dataset's first batch at the
  Trainer's init, data-parallel or not.
* `render`: one of the three sharded renders.
* `tp_step`: a gradient step of a small network with its weights sharded
  by `tp.shard_state` over a ("data", "model") mesh; optionally the
  sharded fraction of a Trainer's initial state.
* `raises`: another program's ValueError, as a result.

Launch counts are the kernels' own counters (`render.raster`,
`render.binning`, `render.stream_binning`), read around the run.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from fresnel_tpu_torch.parallel import mesh as pmesh


def _counts() -> Dict[str, int]:
    from fresnel_tpu_torch.render import binning, raster, stream_binning

    return {"k1": raster.launches, "k2": raster.launches_bwd,
            "k3": binning.launches, "k4": stream_binning.launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _counts().items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def params_sha256(params: Dict[str, torch.Tensor]) -> str:
    """sha256 over the parameters' bytes in name order."""
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def mesh_units(task: Dict, dev: torch.device) -> Dict:
    """shard_batch of a global batch (and of an indivisible one),
    replicate of a rank-valued tree, pmean_gradients of rank-seeded
    gradients (a None entry kept), a RowGenerator's draw (and its refusal
    of a draw that is not batch-major), global_sum, and the world a step
    sees under jit_data_parallel (with a mesh and without) and
    data_parallel_step."""
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = pmesh.get_mesh(device_type=dev.type)
    B = task["batch"]
    batch = {"image": torch.arange(B * 3, dtype=torch.float32,
                                   device=dev).reshape(B, 3),
             "rows": np.arange(B), "distill_scale": 0.5}
    local = pmesh.shard_batch(batch, mesh)
    try:
        pmesh.shard_batch({"x": np.zeros(B + 1)}, mesh)
        indivisible = None
    except ValueError as e:
        indivisible = str(e)
    tree = {"a": torch.full((4,), float(rank + 1), device=dev),
            "b": {"c": torch.full((2, 2), float(10 * rank), device=dev)}}
    rep = pmesh.replicate(tree, mesh)
    g = torch.Generator().manual_seed(rank)
    grads = {"w": torch.randn(3, 5, generator=g).to(dev), "none": None,
             "s": torch.randn((), generator=g).to(dev)}
    with pmesh.batch_shard(mesh) as shard:
        avg = pmesh.pmean_gradients(grads)
        rows = pmesh.RowGenerator(torch.Generator(dev).manual_seed(7), shard,
                                  B // n)
        drawn = pmesh.rand_rows((2, B // n, 3), rows, dev, batch_dim=1)
        try:
            pmesh.rand_rows((B // n + 1, 3), rows, dev)
            not_rows = None
        except ValueError as e:
            not_rows = str(e)
        gs = pmesh.global_sum(torch.tensor([float(rank)], device=dev), shard)

    def world():
        shard = pmesh.step_shard()
        return 1 if shard is None else shard.world

    worlds = {"jit_mesh": pmesh.jit_data_parallel(world, mesh=mesh)(),
              "jit_plain": pmesh.jit_data_parallel(world)(),
              "step": pmesh.data_parallel_step(world, mesh)()}
    return {"rank": rank, "world": n, "local": _cpu(local),
            "worlds": worlds, "local_type": type(local).__name__,
            "indivisible": indivisible, "not_rows": not_rows,
            "replicated": _cpu(rep), "grads": _cpu(grads),
            "pmean": _cpu(avg), "rand_rows": drawn.cpu(),
            "global_sum": gs.cpu()}


def _trainer(task: Dict, dev: torch.device):
    from fresnel_tpu_torch.train import config as tconfig
    from fresnel_tpu_torch.train.harness import Trainer, build_decoder

    c = task["configs"]
    trainer = Trainer(tconfig.TrainingConfig(**c["config"]),
                      tconfig.PhysicsConfig(**c.get("physics", {})),
                      tconfig.HFGSConfig(**c.get("hfgs", {})),
                      tconfig.HFTSConfig(**c.get("hfts", {})), device=dev)
    if task.get("dropout") is not None:
        trainer.model = build_decoder(trainer.config, trainer.physics_config,
                                      dropout=task["dropout"])
    return trainer


def train_steps(task: Dict, dev: torch.device) -> Dict:
    """`Trainer.train_step` on each of task["batches"] (global host
    batches) from task["params"]: data-parallel over every rank with
    task["mesh"], else this rank alone on the whole batch.  Each step's
    draws come from task["draws"][i] ({"K", "sk", "poses", "topk"}), the
    rest from a generator seeded task["gen_seed"]."""
    trainer = _trainer(task, dev)
    trainer._make_optimizer(task["total_steps"])
    params = {k: torch.as_tensor(v).to(dev) for k, v in
              task["params"].items()}
    state = {"params": params, "opt_state": trainer.optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    mesh = pmesh.get_mesh(device_type=dev.type) if task["mesh"] else None
    step = (trainer.train_step if mesh is None
            else pmesh.data_parallel_step(trainer.train_step, mesh))
    gen = torch.Generator(device=dev).manual_seed(task["gen_seed"])
    losses = []
    for batch, d in zip(task["batches"], task["draws"]):
        jb = trainer.device_batch(batch)
        poses = d.get("poses")
        if mesh is not None:
            jb, poses = pmesh.shard_batch(jb, mesh), pmesh.shard_batch(
                poses, mesh)
        topk = d.get("topk")
        if topk is not None:
            topk = torch.as_tensor(np.array(topk), device=dev)
        state, ld = step(state, jb, d["K"], d.get("sk"), gen, poses,
                         topk_indices=topk)
        losses.append({k: float(v) for k, v in ld.items()})
    return {"losses": losses, "params": _cpu(state["params"]),
            "sha256": params_sha256(state["params"])}


def gradients(task: Dict, dev: torch.device) -> Dict:
    """`Trainer.gradients` of the first global batch of task["dataset"]
    at the Trainer's init (depth_offset_init applied, as `fit` applies
    it), its generator seeded as `fit` seeds it: data-parallel with
    task["mesh"]."""
    trainer = _trainer(task, dev)
    cfg = trainer.config
    dataset = _dataset(task["dataset"], dev)
    params = trainer.init_state()["params"]
    if cfg.depth_offset_init is not None:
        params["model.depth_offset"] = torch.tensor(
            float(cfg.depth_offset_init), device=dev)
    batch = trainer.device_batch(next(iter(dataset.batches(
        cfg.batch_size, np.random.default_rng(cfg.seed)))))
    mesh = pmesh.get_mesh(device_type=dev.type) if task["mesh"] else None
    grad_fn = trainer.gradients
    if mesh is not None:
        grad_fn = pmesh.data_parallel_step(grad_fn, mesh)
        batch = pmesh.shard_batch(batch, mesh)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    grads, ld = grad_fn(params, batch, cfg.gaussians_per_patch, None, gen)
    return {"grads": _cpu({k: g for k, g in grads.items()
                           if g is not None}),
            "losses": {k: float(v) for k, v in ld.items()}}


def _dataset(spec: Dict, dev: torch.device):
    spec = dict(spec)
    kind = spec.pop("kind")
    if kind == "synthetic":
        from fresnel_tpu_torch.data.dataset import SyntheticGaussianDataset
        return SyntheticGaussianDataset(device=dev, **spec)
    from fresnel_tpu_torch.data.dataset import ImageDataset
    return ImageDataset(device=dev, **spec)


def fit(task: Dict, dev: torch.device) -> Dict:
    """`Trainer.fit` over task["dataset"] ({"kind": "image" | "synthetic",
    dataset arguments}), data-parallel with task["mesh"].  Each step is
    timed on the device (synchronised around it) and its global loss
    read; with task["allreduce_timed"] the gradient all-reduce is timed
    alone."""
    trainer = _trainer(task, dev)
    dataset = _dataset(task["dataset"], dev)
    mesh = pmesh.get_mesh(device_type=dev.type) if task["mesh"] else None
    plain_step = trainer.train_step
    step_ms, step_loss = [], []

    def timed_step(*args, **kwargs):
        _sync(dev)
        t0 = time.perf_counter()
        out = plain_step(*args, **kwargs)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_loss.append(float(out[1]["total"]))
        return out

    trainer.train_step = timed_step
    stats = pmesh.ALLREDUCE_STATS
    stats.update(calls=0, bytes=0, seconds=0.0,
                 timed=bool(task.get("allreduce_timed")))
    before = _counts()
    state = trainer.fit(dataset, mesh=mesh, log_fn=lambda *a: None)
    _sync(dev)
    return {"rank": dist.get_rank() if dist.is_initialized() else 0,
            "history": trainer.history, "step_ms": step_ms,
            "step_loss": step_loss, "launches": _since(before),
            "allreduce": dict(stats), "params": _cpu(state["params"]),
            "sha256": params_sha256(state["params"])}


def render(task: Dict, dev: torch.device) -> Dict:
    """One sharded render (task["kind"]: "batch", "gaussian" or "pixel")
    of task["fields"] (positions, scales, rotations, colours, opacities)
    through task["camera"] with task["config"]; the image, its launches
    and its time (the median of task["repeats"] calls after one)."""
    from fresnel_tpu_torch.parallel import render as prender

    fn = {"batch": prender.render_batch_sharded,
          "gaussian": prender.render_gaussian_sharded,
          "pixel": prender.render_pixel_sharded}[task["kind"]]
    mesh = pmesh.get_mesh(device_type=dev.type)
    fields = [torch.as_tensor(f).to(dev) for f in task["fields"]]
    cam = task["camera"].to(dev)
    kw = {"config": task["config"]}
    if task["kind"] != "batch":
        kw["background"] = tuple(task.get("background", (0.0, 0.0, 0.0)))
    before = _counts()
    img = fn(*fields, cam, mesh, **kw)
    launches = _since(before)
    ms = []
    for _ in range(task.get("repeats", 0)):
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        fn(*fields, cam, mesh, **kw)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"kind": task["kind"], "image": img.cpu(), "launches": launches,
            "ms": ms}


def tp_step(task: Dict, dev: torch.device) -> Dict:
    """The loss mean((tanh(x @ w1 + b1) @ w2)^2) and its gradient with the
    weights sharded by `tp.shard_state` (min_elems task["min_elems"])
    over a task["shape"] ("data", "model") mesh and x's rows over
    "data"; the full loss and gradients, the specs, and the sharded
    fraction.  With task["trainer"] (a `train_steps`-style task), also
    the sharded fraction of that Trainer's initial state."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from fresnel_tpu_torch.parallel import tp

    mesh = pmesh.get_mesh(axis_names=("data", "model"),
                          shape=tuple(task["shape"]), device_type=dev.type)
    params = {k: torch.as_tensor(v).to(dev) for k, v in
              task["params"].items()}
    tp_params = tp.shard_state(params, mesh, min_elems=task["min_elems"])
    frac = tp.sharded_fraction(tp_params)
    x_local = pmesh.shard_batch({"x": torch.as_tensor(task["x"]).to(dev)},
                                mesh)["x"]
    x = DTensor.from_local(x_local, mesh, [Shard(0), Replicate()])
    leaves = [tp_params[k].requires_grad_() for k in ("w1", "b1", "w2")]
    h = torch.tanh(x @ leaves[0] + leaves[1])
    loss = torch.mean((h @ leaves[2]) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    out = {"loss": float(tp.full_tensor(loss)),
           "grads": {k: tp.full_tensor(g).cpu()
                     for k, g in zip(("w1", "b1", "w2"), grads)},
           "grad_placements": {k: str(g.placements)
                               for k, g in zip(("w1", "b1", "w2"), grads)},
           "specs": tp.infer_state_specs(params, mesh,
                                         min_elems=task["min_elems"]),
           "fraction": frac}
    if task.get("trainer"):
        trainer = _trainer(task["trainer"], dev)
        state = trainer.init_state()
        sharded = tp.shard_state(state, mesh)
        out["trainer_fraction"] = tp.sharded_fraction(sharded)
        out["trainer_specs"] = tp.infer_state_specs(state["params"], mesh)
    return out


def raises(task: Dict, dev: torch.device):
    """The message of the ValueError that task["inner"] (another rank
    program, which must raise on every rank alike) raises; None if it
    returns."""
    try:
        globals()[task["inner"]["task"]](task["inner"], dev)
    except ValueError as e:
        return str(e)
    return None
