"""CVS trainer: consistency training for one-step novel-view synthesis.

Counterpart of fresnel_tpu/train/train_cvs.py:
  * the loss: L1 reconstruction (quality-masked with `use_quality_aware`)
    + an untrained random-conv perceptual term + EMA self-consistency
    (the model's x0 against the EMA model's x0 from x_{t-1}, one Euler
    step back, with no gradient through the EMA branch);
  * `clip_by_global_norm(1.0)` + AdamW at optax's defaults (weight decay
    1e-4 on every leaf) at a constant rate, and the EMA update;
  * the non-finite guard of the JAX step: the gradients are zeroed and the
    optimizer still steps (the moments decay, the count advances), then
    the parameters are kept; the EMA still moves toward them;
  * the consistency ramp (the staircase schedule with use_quality_aware)
    and segmented runs (`start_epoch` / `stop_epoch`);
  * three datasets of (input view, its features, relative pose, target
    view, target depth) pairs: orbit renders of random Gaussian clouds
    (`GaussianBootstrapDataset`), of the experiment-2 teacher fits
    (`TeacherMultiviewDataset`), and corpus_v2's raytraced views
    (`GTMultiviewDataset`).  On the card the renders composite through
    K1.

Differences from the JAX trainer: the timesteps and the noise come from a
`torch.Generator` (`draw`) and are arguments of `loss` / `train_step`, so
a caller can hand both packages the same draws; `use_amp` sets the model's
compute dtype to bfloat16 (models/cvs.py).  Checkpoints are `.pt`
(`cvs.pt`, `cvs_final.pt`) with the JAX package's `.json` sidecar
({"epoch", "config"}); `load_checkpoint` and `--resume` also read the JAX
package's `.msgpack` (train/flax_msgpack.py).

Run:  python -m fresnel_tpu_torch.train.train_cvs --synthetic --epochs 2 \\
          --image_size 32 --base_channels 32 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.device import resolve_device
from fresnel_tpu_torch.losses.quality_aware import (
    consistency_weight_schedule, quality_mask)
from fresnel_tpu_torch.models.cvs import CVSConfig, ConsistencyViewSynthesizer
from fresnel_tpu_torch.models.encoders import (
    create_feature_extractor, resize_linear)
from fresnel_tpu_torch.render.tile import TileRendererConfig, render_tiled
from fresnel_tpu_torch.train.flax_msgpack import read_flat
from fresnel_tpu_torch.train.optim import AdamWClip
from fresnel_tpu_torch.weights import cvs_state, init_flax_like_

SAMPLE_KEYS = ("input_image", "features", "R_rel", "t_rel", "target_image",
               "target_depth")
WEIGHT_DECAY = 1e-4          # optax.adamw's default


def _pose_mats(cam: Camera) -> Tuple[np.ndarray, np.ndarray]:
    view = cam.view.cpu().numpy()
    return view[:3, :3], view[:3, 3]


def _relative(mats_i, mats_0) -> Tuple[np.ndarray, np.ndarray]:
    """R_i R_0^T and t_i - R_rel t_0 in numpy float32, as the JAX datasets
    compute them."""
    R_rel = mats_i[0] @ mats_0[0].T
    t_rel = mats_i[1] - R_rel @ mats_0[1]
    return R_rel.astype(np.float32), t_rel.astype(np.float32)


class PairDataset:
    """A list of sample dicts (SAMPLE_KEYS, numpy) and the JAX package's
    `batches`: the same generator calls, so a seed gives the same
    batches.  `cache`: an npz of the stacked samples, read if it exists
    (either package's) and written after a build."""

    image_size: int
    _samples: list

    def _read_cache(self, cache: Optional[str], image_size: int) -> bool:
        if not (cache and Path(cache).exists()):
            return False
        with np.load(cache) as z:
            arrs = {k: z[k] for k in SAMPLE_KEYS}
        n = arrs["input_image"].shape[0]
        self._samples = [{k: arrs[k][i] for k in SAMPLE_KEYS}
                         for i in range(n)]
        self.image_size = image_size
        return True

    def _write_cache(self, cache: Optional[str]) -> None:
        if cache:
            np.savez(cache, **{k: np.stack([s[k] for s in self._samples])
                               for k in SAMPLE_KEYS})

    def __len__(self):
        return len(self._samples)

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self._samples))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i: i + batch_size]
            yield {k: np.stack([self._samples[j][k] for j in idx])
                   for k in SAMPLE_KEYS}


def _features(extractor, view_chw: np.ndarray, dev) -> np.ndarray:
    img = torch.from_numpy(np.ascontiguousarray(
        np.transpose(view_chw, (1, 2, 0)))).to(dev)
    return extractor(img).cpu().numpy()


class GaussianBootstrapDataset(PairDataset):
    """Multi-view pairs rendered from random Gaussian clouds: each scene's
    frontal view and `views_per_scene - 1` random orbit views (M 256)."""

    def __init__(self, n_scenes: int = 8, views_per_scene: int = 4,
                 image_size: int = 64, n_gaussians: int = 120, seed: int = 0,
                 feature_dim: int = 384, device=None):
        from fresnel_tpu_torch.core.gaussians import GaussianCloud

        dev = resolve_device(device)
        self.image_size = image_size
        rng = np.random.default_rng(seed)
        extractor = create_feature_extractor(dim=feature_dim, device=dev)
        self._samples = []
        for s in range(n_scenes):
            cloud = GaussianCloud.test_cloud(
                n_gaussians, seed=seed * 997 + s, spread=0.45, z_offset=0.0,
                scale=0.1).to(dev)
            poses = [(0.0, 0.0)] + [
                (rng.uniform(-0.4, 0.6), rng.uniform(0, 2 * np.pi))
                for _ in range(views_per_scene - 1)]
            views, depths, mats = [], [], []
            for el, az in poses:
                cam = Camera.from_pose(el, az, image_size, distance=2.0)
                with torch.no_grad():
                    img, dep = render_tiled(
                        cloud.positions, cloud.scales, cloud.rotations,
                        cloud.colors, cloud.opacities, cam.to(dev),
                        return_depth=True)
                views.append(img.cpu().numpy())
                depths.append(dep.cpu().numpy())
                mats.append(_pose_mats(cam))
            feats = _features(extractor, views[0], dev)
            for i in range(1, views_per_scene):
                R_rel, t_rel = _relative(mats[i], mats[0])
                self._samples.append({
                    "input_image": views[0], "features": feats,
                    "R_rel": R_rel, "t_rel": t_rel,
                    "target_image": views[i], "target_depth": depths[i]})


class TeacherMultiviewDataset(PairDataset):
    """Photo-like pairs from the experiment-2 teacher fits
    (`train/fit_teacher.py` sidecars `{stem}_teacher.npz`): each teacher
    cloud (`head_transform` of its raw values on the scene's depth cache)
    rendered at M 1 024 from the frontal pose and `views_per_scene - 1`
    poses drawn in `el_range` x `az_range`."""

    def __init__(self, data_dir: str = "data/corpus_v1",
                 image_size: int = 256, views_per_scene: int = 4,
                 max_scenes: Optional[int] = None, seed: int = 0,
                 el_range=(-0.15, 0.3), az_range=(-0.4, 0.4),
                 feature_dim: int = 384, cache: Optional[str] = None,
                 device=None):
        if self._read_cache(cache, image_size):
            return
        from fresnel_tpu_torch.models.decoders import head_transform
        from fresnel_tpu_torch.train.fit_teacher import teacher_path

        dev = resolve_device(device)
        self.image_size = image_size
        rng = np.random.default_rng(seed)
        extractor = create_feature_extractor(dim=feature_dim, device=dev)
        rcfg = TileRendererConfig(max_per_tile=1024)

        pngs = sorted(Path(data_dir).glob("*.png"))
        scenes = [p for p in pngs if teacher_path(p).exists()]
        if max_scenes:
            scenes = scenes[:max_scenes]
        if not scenes:
            raise FileNotFoundError(
                f"no *_teacher.npz sidecars under {data_dir} - run "
                "python -m fresnel_tpu_torch.train.fit_teacher first")

        self._samples = []
        for p in scenes:
            with np.load(teacher_path(p)) as t:
                raw, do = t["raw"], float(t["depth_offset"])
            d = np.fromfile(p.with_name(p.stem + "_depth.bin"), np.float32)
            side = int(round(len(d) ** 0.5))
            depth = torch.from_numpy(d.reshape(side, side)).to(dev)
            with torch.no_grad():
                out = head_transform(torch.from_numpy(raw).to(dev)[None],
                                     depth[None],
                                     torch.tensor(do, device=dev))
            cloud = [out[k][0] for k in ("positions", "scales", "rotations",
                                         "colors", "opacities")]
            poses = [(0.0, 0.0)] + [
                (rng.uniform(*el_range), rng.uniform(*az_range))
                for _ in range(views_per_scene - 1)]
            views, depths, mats = [], [], []
            for el, az in poses:
                cam = Camera.from_pose(el, az, image_size, distance=2.0)
                with torch.no_grad():
                    img, dep = render_tiled(*cloud, cam.to(dev), config=rcfg,
                                            return_depth=True)
                views.append(img.cpu().numpy())
                depths.append(dep.cpu().numpy())
                mats.append(_pose_mats(cam))
            feats = _features(extractor, views[0], dev)
            for i in range(1, views_per_scene):
                R_rel, t_rel = _relative(mats[i], mats[0])
                self._samples.append({
                    "input_image": views[0], "features": feats,
                    "R_rel": R_rel, "t_rel": t_rel,
                    "target_image": views[i], "target_depth": depths[i]})
        self._write_cache(cache)


class GTMultiviewDataset(PairDataset):
    """Exact-GT pairs from corpus_v2's raytraced orbit views
    (`{scene}_views.npz`: 8 views on the el 0, distance 2 orbit): the
    frontal view against `views_per_scene - 1` others drawn without
    replacement.  Views of another size are resized as
    `jax.image.resize(..., "linear")` does (antialiased when shrinking);
    features come from the scene's `_dinov2` cache when it exists;
    target_depth is zeros (no per-view GT depth)."""

    def __init__(self, data_dir: str = "data/corpus_v2",
                 image_size: int = 256, views_per_scene: int = 4,
                 max_scenes: Optional[int] = None, seed: int = 0,
                 feature_dim: int = 384, cache: Optional[str] = None,
                 device=None):
        if self._read_cache(cache, image_size):
            return
        from fresnel_tpu_torch.data.dataset import cache_paths

        dev = resolve_device(device)
        self.image_size = image_size
        rng = np.random.default_rng(seed)
        extractor = None
        scenes = [p for p in sorted(Path(data_dir).glob("*.png"))
                  if p.with_name(p.stem + "_views.npz").exists()]
        if max_scenes:
            scenes = scenes[:max_scenes]
        if not scenes:
            raise FileNotFoundError(
                f"no *_views.npz sidecars under {data_dir} - generate "
                "corpus_v2 (python -m fresnel_tpu_torch.data."
                "raytrace_corpus) first")

        zdepth = np.zeros((image_size, image_size), np.float32)
        self._samples = []
        for p in scenes:
            with np.load(p.with_name(p.stem + "_views.npz")) as z:
                views = z["images"].astype(np.float32) / 255.0  # (V,S,S,3)
                az_deg = z["azimuths_deg"].astype(np.float32)
            if views.shape[1] != image_size:
                chw = torch.from_numpy(views).permute(0, 3, 1, 2)
                views = resize_linear(chw, image_size, image_size).permute(
                    0, 2, 3, 1).contiguous().numpy()
            frontal = int(np.argmin(np.abs(az_deg)))
            inp_hwc = views[frontal]

            feat_path = cache_paths(p, image_size, feature_dim)[1]
            if feat_path.exists():
                feats = np.fromfile(feat_path, np.float32).reshape(
                    37, 37, feature_dim)
            else:
                if extractor is None:
                    extractor = create_feature_extractor(
                        dim=feature_dim, device=dev)
                feats = _features(extractor, inp_hwc.transpose(2, 0, 1), dev)

            mats = [_pose_mats(Camera.from_pose(
                0.0, float(np.radians(a)), image_size, distance=2.0))
                for a in az_deg]
            others = [i for i in range(len(az_deg)) if i != frontal]
            picks = rng.choice(len(others), size=min(views_per_scene - 1,
                                                     len(others)),
                               replace=False)
            for j in (others[k] for k in picks):
                R_rel, t_rel = _relative(mats[j], mats[frontal])
                self._samples.append({
                    "input_image": inp_hwc.transpose(2, 0, 1),
                    "features": feats, "R_rel": R_rel, "t_rel": t_rel,
                    "target_image": views[j].transpose(2, 0, 1),
                    "target_depth": zdepth})
        self._write_cache(cache)


@dataclasses.dataclass
class CVSTrainConfig:
    output_dir: str = "checkpoints_cvs"
    epochs: int = 50
    batch_size: int = 2
    lr: float = 1e-4
    image_size: int = 64
    base_channels: int = 64
    lambda_consistency: float = 1.0
    lambda_reconstruction: float = 1.0
    lambda_perceptual: float = 0.5
    consistency_ramp_epochs: int = 10   # progressive consistency weight ramp
    use_quality_aware: bool = False     # depth-Laplacian quality masking
    use_amp: bool = False               # bf16 U-Net compute (fp32 master)
    concat_input_view: bool = False     # input view as extra U-Net channels
    ema_decay: float = 0.9999
    save_interval: int = 10
    seed: int = 0


class PerceptualNet(nn.Module):
    """The untrained conv feature stack of the loss (the reference's):
    (B, 3, H, W) -> (B, 256, H / 4, W / 4), float32.  Flax names."""

    def __init__(self):
        super().__init__()
        from fresnel_tpu_torch.models.cvs import Conv
        for i, (a, b) in enumerate(((3, 64), (64, 64), (64, 128),
                                    (128, 128), (128, 256))):
            self.add_module(f"Conv_{i}", Conv(a, b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        x = F.max_pool2d(x, 2)
        x = F.relu(self.Conv_3(F.relu(self.Conv_2(x))))
        x = F.max_pool2d(x, 2)
        return F.relu(self.Conv_4(x))


class _Method(nn.Module):
    """`model.<name>(...)` as a forward, for functional_call."""

    def __init__(self, model: nn.Module, name: str):
        super().__init__()
        self.model, self.name = model, name

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.name)(*args, **kwargs)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.detach().to(device)


class CVSTrainer:
    """State: {"params", "ema_params", "perc_params" (flat {name: tensor}
    dicts, Flax names), "opt_state": {"count", "mu", "nu"}, "step"}."""

    def __init__(self, cfg: CVSTrainConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model_config = CVSConfig(
            image_size=cfg.image_size, base_channels=cfg.base_channels,
            ema_decay=cfg.ema_decay, concat_input_view=cfg.concat_input_view,
            dtype=torch.bfloat16 if cfg.use_amp else None)
        self.model = ConsistencyViewSynthesizer(self.model_config).to(
            self.device)
        self.perceptual = PerceptualNet().to(self.device)
        self.optimizer = AdamWClip(cfg.lr, 1, WEIGHT_DECAY,
                                   schedule="constant")
        self.history: Dict[str, list] = {}

    # ------------------------------------------------------------------
    def init_state(self, batch=None) -> Dict:
        """Flax-like init from CPU generators (seed for the model, 1 for
        the perceptual stack, as the JAX trainer's PRNGKey(1)), moved to
        the device.  `batch` is accepted for the JAX signature."""
        params = {}
        for name, module, seed in (("params", self.model, self.cfg.seed),
                                   ("perc_params", self.perceptual, 1)):
            module.to("cpu")
            init_flax_like_(module, torch.Generator().manual_seed(seed))
            module.to(self.device)
            params[name] = {k: v.detach().clone()
                            for k, v in module.named_parameters()}
        p = params["params"]
        return {"params": p,
                "ema_params": {k: v.clone() for k, v in p.items()},
                "opt_state": self.optimizer.init(p),
                "perc_params": params["perc_params"],
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def apply(self, params: Dict[str, torch.Tensor], method: str, *args,
              **kwargs):
        """`self.model.<method>(*args, **kwargs)` with `params`."""
        module = (self.model if method == "forward"
                  else _Method(self.model, method))
        if module is not self.model:
            params = {f"model.{k}": v for k, v in params.items()}
        return functional_call(module, params, args, kwargs)

    def device_batch(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in batch.items()}

    def draw(self, batch: Dict[str, torch.Tensor],
             generator: torch.Generator
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(timestep (B,) in [0, T), noise like the target) from
        `generator`."""
        tgt = batch["target_image"]
        t = torch.randint(0, self.model_config.num_timesteps,
                          (tgt.shape[0],), generator=generator,
                          device=generator.device).to(self.device)
        noise = torch.randn(tuple(tgt.shape), generator=generator,
                            device=generator.device).to(self.device)
        return t, noise

    def loss(self, params, ema_params, perc_params, batch, timestep, noise,
             consistency_weight: float):
        """(total, loss dict) of one batch of device tensors."""
        cfg = self.cfg
        args = (batch["input_image"], batch["features"], batch["R_rel"],
                batch["t_rel"])
        out = self.apply(params, "forward", *args,
                         target_image=batch["target_image"],
                         timestep=timestep, noise=noise)
        x0, target = out["x0_pred"], out["target"]
        ld = {}
        if cfg.use_quality_aware and "target_depth" in batch:
            qm = quality_mask(batch["target_depth"])
            l1 = torch.mean(torch.abs(x0 - target) * qm[:, None])
        else:
            l1 = torch.mean(torch.abs(x0 - target))
        ld["l1"] = l1 * cfg.lambda_reconstruction
        pf = functional_call(self.perceptual, perc_params, (x0,))
        tf = functional_call(self.perceptual, perc_params, (target,))
        ld["perceptual"] = torch.mean(torch.abs(pf - tf)) * cfg.lambda_perceptual

        # Consistency: the EMA model's x0 at the previous timestep, from
        # x_{t-1} itself (no re-noising), with no gradient.
        sch = self.model.schedule(x0.device)["sqrt_alphas_cumprod"]
        t_prev = torch.clamp(timestep - 1, min=0)
        a_t = sch[timestep][:, None, None, None]
        a_p = sch[t_prev][:, None, None, None]
        with torch.no_grad():
            x0d = x0.detach()
            x_t_prev = torch.clamp(
                a_p * x0d + (1 - a_p) / (1 - a_t + 1e-8)
                * (out["noisy"] - a_t * x0d), -1.0, 1.0)
            x0_ema = self.apply(ema_params, "predict_x0", *args, x_t_prev,
                                t_prev)
        ld["consistency"] = (torch.mean((x0 - x0_ema) ** 2)
                             * cfg.lambda_consistency * consistency_weight)
        total = ld["l1"] + ld["perceptual"] + ld["consistency"]
        ld["total"] = total
        return total, ld

    def train_step(self, state: Dict, batch: Dict, consistency_weight: float,
                   timestep: torch.Tensor, noise: torch.Tensor
                   ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        """One step of the JAX trainer's: a non-finite loss or gradient
        zeroes the gradients, the optimizer steps on them (moments decay,
        the count advances), the parameters are kept, and the EMA moves
        toward them."""
        names = list(state["params"])
        params = {k: v.detach().requires_grad_()
                  for k, v in state["params"].items()}
        with torch.enable_grad():
            total, ld = self.loss(params, state["ema_params"],
                                  state["perc_params"], batch, timestep,
                                  noise, consistency_weight)
            grads = torch.autograd.grad(total, [params[k] for k in names],
                                        allow_unused=True)
        with torch.no_grad():
            old = state["params"]
            g = [torch.zeros_like(old[k]) if x is None else x
                 for k, x in zip(names, grads)]
            finite = torch.isfinite(total.detach()) & torch.stack(
                [torch.isfinite(x).all() for x in g]).all()
            g = {k: torch.where(finite, x, torch.zeros_like(x))
                 for k, x in zip(names, g)}
            new, opt = self.optimizer.update(old, g, state["opt_state"])
            new = {k: torch.where(finite, new[k], old[k]) for k in names}
            a = 1.0 - self.cfg.ema_decay
            ema = {k: new[k] * a + state["ema_params"][k] * (1.0 - a)
                   for k in names}
        return ({"params": new, "ema_params": ema, "opt_state": opt,
                 "perc_params": state["perc_params"],
                 "step": state["step"] + 1},
                {k: v.detach() for k, v in ld.items()})

    def consistency_weight(self, epoch: int, epochs: int) -> float:
        if self.cfg.use_quality_aware:
            return consistency_weight_schedule(epoch, epochs)
        return min(1.0, (epoch + 1) / max(self.cfg.consistency_ramp_epochs, 1))

    # ------------------------------------------------------------------
    def fit(self, dataset, epochs: Optional[int] = None,
            state: Optional[Dict] = None, log_fn: Callable = print,
            start_epoch: int = 0, stop_epoch: Optional[int] = None) -> Dict:
        """start_epoch continues the consistency ramp of a segmented run;
        stop_epoch ends the segment (exclusive) with a resume point."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        nprng = np.random.default_rng(cfg.seed + start_epoch)
        gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1 + start_epoch)
        first = next(iter(dataset.batches(cfg.batch_size, nprng)))
        if state is None:
            state = self.init_state(first)

        out_dir = Path(cfg.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        last_epoch = epochs if stop_epoch is None else min(stop_epoch, epochs)
        for epoch in range(start_epoch, last_epoch):
            cw = self.consistency_weight(epoch, epochs)
            t0 = time.perf_counter()
            losses: Dict[str, list] = {}
            for batch in dataset.batches(cfg.batch_size, nprng):
                jb = self.device_batch(batch)
                ts, noise = self.draw(jb, gen)
                state, ld = self.train_step(state, jb, cw, ts, noise)
                for k, v in ld.items():
                    losses.setdefault(k, []).append(v)
            keys = list(losses)
            vals = torch.stack([torch.stack(losses[k]).mean()
                                for k in keys]).cpu().tolist()
            means = dict(zip(keys, vals))
            for k, v in means.items():
                self.history.setdefault(k, []).append(v)
            log_fn(f"epoch {epoch + 1}/{epochs} cw={cw:.2f} "
                   f"total={means['total']:.4f} l1={means['l1']:.4f} "
                   f"cons={means['consistency']:.4f} "
                   f"({time.perf_counter() - t0:.1f}s)")
            if (epoch + 1) % cfg.save_interval == 0:
                self.save_checkpoint(out_dir / "cvs.pt", state, epoch)
        if last_epoch >= epochs:
            self.save_checkpoint(out_dir / "cvs_final.pt", state, epochs - 1)
        else:      # segment boundary: a resume point
            self.save_checkpoint(out_dir / "cvs.pt", state, last_epoch - 1)
        (out_dir / "loss_history.json").write_text(json.dumps(self.history))
        return state

    def save_checkpoint(self, path, state: Dict, epoch: int) -> None:
        torch.save(_to(state, "cpu"), str(path))
        Path(str(path) + ".json").write_text(json.dumps(
            {"epoch": epoch, "config": dataclasses.asdict(self.cfg)}))

    def load_checkpoint(self, path, batch=None) -> Tuple[Dict, int]:
        """(state, epoch) from a `.pt` of `save_checkpoint` or the JAX
        package's `.msgpack` (every leaf carried over: params, EMA, the
        perceptual stack, Adam's moments and count, step); the epoch from
        the `.json` sidecar (-1 without one).  Names and shapes must be
        this trainer's."""
        if str(path).endswith(".msgpack"):
            state = cvs_state(read_flat(path))
        else:
            state = torch.load(str(path), map_location="cpu",
                               weights_only=True)
        template = self.init_state(batch)
        for group in ("params", "ema_params", "perc_params"):
            want = {k: tuple(v.shape) for k, v in template[group].items()}
            got = {k: tuple(v.shape) for k, v in state[group].items()}
            if want != got:
                bad = sorted(set(want.items()) ^ set(got.items()))[:6]
                raise ValueError(f"{path}: {group} do not fit this model "
                                 f"({bad} ...)")
        meta_path = Path(str(path) + ".json")
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
        return _to(state, self.device), meta.get("epoch", -1)

    def generate(self, state: Dict, features, R_rel, t_rel,
                 noise: torch.Tensor, num_steps: int = 1,
                 input_image=None) -> torch.Tensor:
        """The EMA model's generation from `noise` (B, 3, S, S)."""
        def dev(x):
            return None if x is None else torch.as_tensor(
                np.asarray(x) if not torch.is_tensor(x) else x,
                dtype=torch.float32, device=self.device)
        with torch.no_grad():
            return self.apply(state["ema_params"], "generate", dev(features),
                              dev(R_rel), dev(t_rel), dev(noise), num_steps,
                              input_image=dev(input_image))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CVS consistency training")
    p.add_argument("--output_dir", default="checkpoints_cvs")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--base_channels", type=int, default=64)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--data_dir", default=None,
                   help="corpus dir with *_teacher.npz sidecars -> train "
                        "on TeacherMultiviewDataset orbit pairs instead "
                        "of the synthetic bootstrap clouds")
    p.add_argument("--gt_multiview", action="store_true",
                   help="train on corpus_v2's raytraced exact-GT orbit "
                        "pairs ({scene}_views.npz) instead of teacher-fit "
                        "renders")
    p.add_argument("--views_per_scene", type=int, default=4)
    p.add_argument("--max_scenes", type=int, default=None)
    p.add_argument("--dataset_cache", default=None,
                   help="npz path to save/load the built multiview pairs")
    p.add_argument("--use_quality_aware", action="store_true")
    p.add_argument("--use_amp", action="store_true",
                   help="bf16 U-Net compute (fp32 master weights)")
    p.add_argument("--concat_input_view", action="store_true",
                   help="feed the input view as 3 extra U-Net input "
                        "channels")
    p.add_argument("--n_scenes", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint (.pt, or the JAX package's .msgpack) to "
                        "continue from; the epoch schedule resumes after "
                        "the saved epoch")
    p.add_argument("--stop_epoch", type=int, default=None,
                   help="run only up to this epoch (exclusive)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv=None) -> Tuple[CVSTrainer, Dict]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = CVSTrainConfig(
        output_dir=args.output_dir, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr, image_size=args.image_size,
        base_channels=args.base_channels,
        use_quality_aware=args.use_quality_aware, use_amp=args.use_amp,
        concat_input_view=args.concat_input_view, seed=args.seed)
    if args.gt_multiview:
        dataset = GTMultiviewDataset(
            args.data_dir or "data/corpus_v2", image_size=cfg.image_size,
            views_per_scene=args.views_per_scene,
            max_scenes=args.max_scenes, seed=cfg.seed,
            cache=args.dataset_cache, device=dev)
    elif args.data_dir:
        dataset = TeacherMultiviewDataset(
            args.data_dir, image_size=cfg.image_size,
            views_per_scene=args.views_per_scene,
            max_scenes=args.max_scenes, seed=cfg.seed,
            cache=args.dataset_cache, device=dev)
    else:
        dataset = GaussianBootstrapDataset(
            n_scenes=args.n_scenes, image_size=cfg.image_size, seed=cfg.seed,
            device=dev)
    print(f"dataset: {len(dataset)} view pairs")

    trainer = CVSTrainer(cfg, device=dev)
    state, start_epoch = None, 0
    if args.resume:
        first = next(iter(dataset.batches(cfg.batch_size,
                                          np.random.default_rng(cfg.seed))))
        state, epoch = trainer.load_checkpoint(args.resume, first)
        start_epoch = epoch + 1
        print(f"resumed from {args.resume} (continuing at {start_epoch})")
    state = trainer.fit(dataset, state=state, start_epoch=start_epoch,
                        stop_epoch=args.stop_epoch)
    print("cvs training complete")
    return trainer, state


if __name__ == "__main__":
    main()
