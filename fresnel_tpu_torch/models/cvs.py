"""Consistency View Synthesizer (CVS): one-step novel-view generation.

Counterpart of fresnel_tpu/models/cvs.py: a U-Net (base channels x (1, 2,
3, 4), two residual blocks per level, attention at the 16 and 8 spatial
sizes, GroupNorm(32) + SiLU, a time-embedding MLP, the pose injected in the
middle), `FresnelWaveAttention` (self-attention plus a cosine interference
bias over pairwise pixel distances with a learned wavelength),
`PluckerPoseEncoder` (16 query tokens from a relative pose),
`ImageFeatureAdapter` (the (37, 37, C) feature grid compressed to 256
tokens by multi-head attention), the cosine DDPM schedule, x0 prediction
and 1-to-4-step generation.  Images are NCHW at the API boundary and
inside.

Every submodule carries the name Flax gives it (`Dense_0`, `Conv_3`,
`ResBlock_5`, `MultiHeadDotProductAttention_0/query`, ...), registered in
the order the Flax module creates it, so the state dict's keys are the
Flax parameter paths with "." and `weights.cvs_params` only changes
layouts.

What the Flax modules do and PyTorch's defaults do not:
* "SAME" padding: the stride-2 3x3 convolution pads (0, 1) on an even
  size (`image_encoder.SameConv2d`);
* GroupNorm and LayerNorm use epsilon 1e-6, statistics in float32;
* `config.dtype` (bfloat16 under `use_amp`) is a compute dtype: every
  layer casts its float32 parameters and its input to it, norms compute in
  float32 and round their output to it, the softmaxes run on scores of
  that dtype, the interference bias is cast to it, and the output head
  stays float32.  The attention is written out (matmul and softmax, not
  `scaled_dot_product_attention`) so the bias and the roundings follow
  the JAX package's;
* the adapter's attention divides the query by sqrt(48) rounded to the
  compute dtype, as `flax.linen.dot_product_attention_weights` does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.models.blocks import LayerNorm, Linear
from fresnel_tpu_torch.models.image_encoder import (
    GroupNorm as _GroupNorm, SameConv2d)


@dataclasses.dataclass(frozen=True)
class CVSConfig:
    image_size: int = 256
    base_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (16, 8)
    pose_embed_dim: int = 256
    image_embed_dim: int = 384
    cross_attention_dim: int = 384
    time_embed_dim: int = 256
    num_timesteps: int = 1000
    ema_decay: float = 0.9999
    num_image_tokens: int = 256
    # The input view as 3 more U-Net input channels (the JAX package's
    # stronger-conditioning arm; off is the reference's design).
    concat_input_view: bool = False
    # Compute dtype (None: float32); parameters stay float32.
    dtype: Optional[torch.dtype] = None

    @property
    def channels(self):
        return tuple(self.base_channels * m for m in self.channel_mult)


def _cumprod_xla(x: np.ndarray, block: int = 16) -> np.ndarray:
    """float32 cumulative product of a 1-D array rounded as XLA:CPU's
    (jax 0.9): its reduce_window becomes a scan over blocks of 16 (each
    block's sequential prefix products, the blocks' totals scanned the
    same way, then each prefix times the product of the blocks before
    it)."""
    n = len(x)
    nb = -(-n // block)
    pad = np.ones(nb * block, np.float32)
    pad[:n] = x
    within = np.cumprod(pad.reshape(nb, block), axis=1, dtype=np.float32)
    totals = within[:, -1]
    scanned = (_cumprod_xla(totals, block) if nb > block
               else np.cumprod(totals, dtype=np.float32))
    before = np.concatenate([[np.float32(1.0)], scanned[:-1]])
    return (before[:, None] * within).astype(np.float32).reshape(-1)[:n]


@functools.lru_cache(maxsize=None)
def _schedule_host(num_timesteps: int) -> Dict[str, torch.Tensor]:
    betas = cosine_beta_schedule(num_timesteps).numpy()
    ac = _cumprod_xla(np.float32(1.0) - betas)
    # numpy's float32 sqrt is correctly rounded, as XLA's is; torch's
    # vectorised CPU sqrt is 1 ulp off at a few entries.
    tables = {"betas": betas, "alphas_cumprod": ac,
              "sqrt_alphas_cumprod": np.sqrt(ac),
              "sqrt_one_minus_alphas_cumprod": np.sqrt(np.float32(1.0) - ac)}
    return {k: torch.from_numpy(v) for k, v in tables.items()}


@functools.lru_cache(maxsize=None)
def schedule_tables(num_timesteps: int, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """The schedule's float32 tables, computed once on the host (the
    cumulative product in XLA:CPU's order) and moved to `device`, so the
    card and the CPU read the JAX package's bits."""
    return {k: v.to(device) for k, v in _schedule_host(num_timesteps).items()}


def cosine_beta_schedule(num_timesteps: int) -> torch.Tensor:
    """Improved-DDPM cosine schedule: float64 on the host, clipped to
    [1e-4, 0.9999], then float32."""
    s = 0.008
    t = np.linspace(0, num_timesteps, num_timesteps + 1)
    ac = np.cos((t / num_timesteps + s) / (1 + s) * np.pi / 2) ** 2
    ac = ac / ac[0]
    betas = 1 - ac[1:] / ac[:-1]
    return torch.from_numpy(np.clip(betas, 0.0001, 0.9999).astype(np.float32))


def sinusoidal_embed(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _dtype(dtype: Optional[torch.dtype]) -> torch.dtype:
    return torch.float32 if dtype is None else dtype


class Dense(Linear):
    """Flax `nn.Dense(dtype=...)`: input and parameters in the compute
    dtype."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_dim, out_dim, bias=bias)
        self.compute_dtype = _dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.compute_dtype))


class Conv(SameConv2d):
    """Flax `nn.Conv(padding="SAME", dtype=...)` on NCHW."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, k, stride=stride)
        self.compute_dtype = _dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.compute_dtype))


class GroupNorm(_GroupNorm):
    """Flax `nn.GroupNorm(num_groups=32, dtype=...)`: float32 statistics,
    epsilon 1e-6, the output rounded to the compute dtype."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__(32, channels)
        self.compute_dtype = _dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(self.compute_dtype)


class FlaxNamed(nn.Module):
    """A module whose submodules are named as Flax names them: the kind
    and a per-kind counter, in creation order."""

    def add(self, kind: str, module: nn.Module) -> nn.Module:
        counts = self.__dict__.setdefault("_flax_counts", {})
        n = counts.get(kind, 0)
        counts[kind] = n + 1
        self.add_module(f"{kind}_{n}", module)
        return module


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H * W, C), the NHWC reshape."""
    B, C = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(B, -1, C)


def _image(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, H * W, C) -> (B, C, H, W)."""
    return x.reshape(x.shape[0], H, W, -1).permute(0, 3, 1, 2)


class ResBlock(FlaxNamed):
    def __init__(self, in_ch: int, out_ch: int, time_embed_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.add("GroupNorm", GroupNorm(in_ch, dtype))
        self.add("Conv", Conv(in_ch, out_ch, 3, dtype=dtype))
        self.add("Dense", Dense(time_embed_dim, out_ch, dtype=dtype))
        self.add("GroupNorm", GroupNorm(out_ch, dtype))
        self.add("Conv", Conv(out_ch, out_ch, 3, dtype=dtype))
        if in_ch != out_ch:                          # Conv_2: the 1x1 skip
            self.add("Conv", Conv(in_ch, out_ch, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(F.silu(self.GroupNorm_0(x)))
        h = h + self.Dense_0(F.silu(t_emb))[:, :, None, None]
        h = self.Conv_1(F.silu(self.GroupNorm_1(h)))
        skip = getattr(self, "Conv_2", None)
        return h + (x if skip is None else skip(x))


def _softmax_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q (B, N, h, d), k / v (B, M, h, d) -> (B, N, h, d): scores times
    `scale` (and + bias) in the inputs' dtype, softmax over M."""
    dots = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    if bias is not None:
        dots = dots + bias
    attn = torch.softmax(dots, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v)


class CrossAttention2D(FlaxNamed):
    """Spatial queries attend to a token context (8 heads x 64, no bias on
    q / k / v)."""

    def __init__(self, channels: int, context_dim: int, heads: int = 8,
                 dim_head: int = 64, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.add("Dense", Dense(channels, inner, False, dtype))      # q
        self.add("Dense", Dense(context_dim, inner, False, dtype))   # k
        self.add("Dense", Dense(context_dim, inner, False, dtype))   # v
        self.add("Dense", Dense(inner, channels, dtype=dtype))       # out

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        h, d = self.heads, self.dim_head
        q = self.Dense_0(_tokens(x)).reshape(B, H * W, h, d)
        k = self.Dense_1(context).reshape(B, -1, h, d)
        v = self.Dense_2(context).reshape(B, -1, h, d)
        o = _softmax_attend(q, k, v, d ** -0.5).reshape(B, H * W, h * d)
        return _image(self.Dense_3(o), H, W)


@functools.lru_cache(maxsize=None)
def pixel_distances(H: int, W: int, device: torch.device) -> torch.Tensor:
    """(H W, H W) float32 distances between the pixels of an H x W grid,
    sqrt(|p - q|^2 + 1e-8), made once per size and device."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    pos = torch.stack([ys.reshape(-1), xs.reshape(-1)], -1)
    diff = pos[:, None, :] - pos[None, :, :]
    return torch.sqrt(torch.sum(diff * diff, -1) + 1e-8).to(device)


class FresnelWaveAttention(FlaxNamed):
    """Self-attention plus the bias 0.1 cos(2 pi dist / (|wavelength| H +
    1e-6)) over pairwise pixel distances, the wavelength learned."""

    def __init__(self, channels: int, heads: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads = heads
        self.add("Dense", Dense(channels, 3 * channels, False, dtype))  # qkv
        self.wavelength = nn.Parameter(torch.tensor(0.1))
        self.add("Dense", Dense(channels, channels, dtype=dtype))      # out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        dh = C // self.heads
        q, k, v = (t.reshape(B, H * W, self.heads, dh)
                   for t in torch.chunk(self.Dense_0(_tokens(x)), 3, dim=-1))
        dist = pixel_distances(H, W, x.device)
        phase = 2.0 * math.pi * dist / (torch.abs(self.wavelength) * H + 1e-6)
        bias = (torch.cos(phase)[None, None] * 0.1).to(q.dtype)
        o = _softmax_attend(q, k, v, dh ** -0.5, bias).reshape(B, H * W, C)
        return _image(self.Dense_1(o), H, W)


class AttentionBlock(FlaxNamed):
    def __init__(self, channels: int, context_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.add("GroupNorm", GroupNorm(channels, dtype))
        self.add("FresnelWaveAttention",
                 FresnelWaveAttention(channels, dtype=dtype))
        self.add("GroupNorm", GroupNorm(channels, dtype))
        self.add("CrossAttention2D",
                 CrossAttention2D(channels, context_dim, dtype=dtype))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.FresnelWaveAttention_0(self.GroupNorm_0(x))
        return x + self.CrossAttention2D_0(self.GroupNorm_1(x), context)


class PluckerPoseEncoder(FlaxNamed):
    """(B, 3, 3), (B, 3) relative pose -> (B, 16, cross_attention_dim):
    6D rotation, translation and its Plücker ray through an MLP, added to
    16 learned query tokens."""

    def __init__(self, embed_dim: int = 256, cross_attention_dim: int = 384,
                 num_queries: int = 16, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.add("Dense", Dense(15, 128, dtype=dtype))
        self.add("Dense", Dense(128, 256, dtype=dtype))
        # LayerNorm's input is a Dense output, already in the compute
        # dtype, which blocks.LayerNorm keeps.
        self.add("LayerNorm", LayerNorm(embed_dim))
        self.add("Dense", Dense(256, embed_dim, dtype=dtype))
        self.add("Dense", Dense(embed_dim, cross_attention_dim, dtype=dtype))
        self.pose_queries = nn.Parameter(
            torch.zeros(num_queries, cross_attention_dim))

    def forward(self, R_rel: torch.Tensor, t_rel: torch.Tensor
                ) -> torch.Tensor:
        B = R_rel.shape[0]
        r6d = R_rel[:, :, :2].reshape(B, 6)
        d = t_rel / torch.clamp(torch.linalg.norm(t_rel, dim=-1,
                                                  keepdim=True), min=1e-8)
        m = torch.linalg.cross(torch.zeros_like(t_rel), d)
        raw = torch.cat([r6d, t_rel, d, m], -1)                  # (B, 15)
        h = F.silu(self.Dense_0(raw))
        h = F.silu(self.Dense_1(h))
        pose = self.Dense_3(self.LayerNorm_0(self.Dense_2(h)))
        return self.pose_queries.to(pose.dtype)[None] + pose[:, None, :]


class MultiHeadAttention(nn.Module):
    """Flax `nn.MultiHeadDotProductAttention`: biased q / k / v / out
    projections (here Linear(C, C)), the query divided by sqrt(head_dim)
    rounded to the compute dtype."""

    def __init__(self, dim: int, heads: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads = heads
        self.query = Dense(dim, dim, dtype=dtype)
        self.key = Dense(dim, dim, dtype=dtype)
        self.value = Dense(dim, dim, dtype=dtype)
        self.out = Dense(dim, dim, dtype=dtype)

    def forward(self, q_in: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        B, Lq, C = q_in.shape
        h, d = self.heads, C // self.heads
        q = self.query(q_in).reshape(B, Lq, h, d)
        q = q / torch.tensor(math.sqrt(d), dtype=torch.float32).to(q.dtype)
        k = self.key(kv).reshape(B, -1, h, d)
        v = self.value(kv).reshape(B, -1, h, d)
        return self.out(_softmax_attend(q, k, v, 1.0).reshape(B, Lq, C))


class ImageFeatureAdapter(FlaxNamed):
    """(B, 37, 37, C) features -> (B, num_tokens, out_dim): a learned
    positional embedding, Dense + SiLU, Dense + LayerNorm, then learned
    queries attend to the tokens."""

    def __init__(self, in_dim: int = 384, out_dim: int = 384,
                 num_tokens: int = 256, grid_tokens: int = 1369,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros(grid_tokens, in_dim))
        self.add("Dense", Dense(in_dim, out_dim, dtype=dtype))
        self.add("LayerNorm", LayerNorm(out_dim))
        self.add("Dense", Dense(out_dim, out_dim, dtype=dtype))
        self.compress_queries = nn.Parameter(torch.zeros(num_tokens, out_dim))
        self.add("MultiHeadDotProductAttention",
                 MultiHeadAttention(out_dim, 8, dtype))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        B = features.shape[0]
        x = features.reshape(B, -1, features.shape[-1])
        x = x + self.pos_embed[: x.shape[1]][None]
        x = F.silu(self.Dense_0(x))
        x = self.LayerNorm_0(self.Dense_1(x))
        q = self.compress_queries.to(x.dtype)[None].expand(
            B, *self.compress_queries.shape)
        return self.MultiHeadDotProductAttention_0(q, x)


class ConsistencyUNet(FlaxNamed):
    """(B, C, H, W) noisy image (C 3, or 6 with concat_input_view), (B,)
    timesteps, image and pose tokens -> (B, 3, H, W) x0 prediction, in
    float32."""

    def __init__(self, config: CVSConfig):
        super().__init__()
        cfg = self.config = config
        dt, td = cfg.dtype, cfg.time_embed_dim
        chans = cfg.channels
        ctx = cfg.cross_attention_dim
        self.add("Dense", Dense(td, td * 4, dtype=dt))          # time MLP
        self.add("Dense", Dense(td * 4, td, dtype=dt))
        in_ch = 6 if cfg.concat_input_view else 3
        self.add("Conv", Conv(in_ch, cfg.base_channels, dtype=dt))

        # Plain lists (not registered again): each encoder level's res
        # blocks, its attention block or None, its downsampling conv or
        # None; then the middle; then each decoder level's.
        self.down = []
        res, ch_in = cfg.image_size, cfg.base_channels
        for i, ch in enumerate(chans):
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(self.add("ResBlock",
                                       ResBlock(ch_in, ch, td, dt)))
                ch_in = ch
            attn = (self.add("AttentionBlock", AttentionBlock(ch, ctx, dt))
                    if res in cfg.attention_resolutions else None)
            down = None
            if i < len(chans) - 1:
                down = self.add("Conv", Conv(ch, ch, 3, stride=2, dtype=dt))
                res //= 2
            self.down.append((blocks, attn, down))

        mid = chans[-1]
        self.mid = [self.add("ResBlock", ResBlock(mid, mid, td, dt)),
                    self.add("AttentionBlock", AttentionBlock(mid, ctx, dt)),
                    self.add("Dense", Dense(ctx, mid, dtype=dt)),
                    self.add("AttentionBlock", AttentionBlock(mid, ctx, dt)),
                    self.add("ResBlock", ResBlock(mid, mid, td, dt))]

        self.up = []
        for i, ch in enumerate(reversed(chans)):
            blocks = []
            for j in range(cfg.num_res_blocks):
                blocks.append(self.add("ResBlock", ResBlock(
                    ch_in + ch if j == 0 else ch, ch, td, dt)))
            ch_in = ch
            attn = (self.add("AttentionBlock", AttentionBlock(ch, ctx, dt))
                    if res in cfg.attention_resolutions else None)
            up = None
            if i < len(chans) - 1:
                up = self.add("Conv", Conv(ch, ch, 3, dtype=dt))
                res *= 2
            self.up.append((blocks, attn, up))

        self.out = [self.add("Conv", Conv(ch_in, cfg.base_channels,
                                          dtype=dt)),
                    self.add("GroupNorm", GroupNorm(cfg.base_channels, dt)),
                    # The head in float32: the x0 prediction feeds float32
                    # loss math.
                    self.add("Conv", Conv(cfg.base_channels, 3))]

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                image_cond: torch.Tensor, pose_cond: torch.Tensor
                ) -> torch.Tensor:
        cfg = self.config
        t_emb = sinusoidal_embed(t, cfg.time_embed_dim)
        t_emb = self.Dense_1(F.silu(self.Dense_0(t_emb)))

        h = self.Conv_0(x)
        skips = []
        for blocks, attn, down in self.down:
            for block in blocks:
                h = block(h, t_emb)
            if attn is not None:
                h = attn(h, image_cond)
            skips.append(h)
            if down is not None:
                h = down(h)

        res1, attn1, pose_proj, attn2, res2 = self.mid
        h = attn1(res1(h, t_emb), image_cond)
        h = h + pose_proj(torch.mean(pose_cond, dim=1))[:, :, None, None]
        h = res2(attn2(h, pose_cond), t_emb)

        for blocks, attn, up in self.up:
            h = torch.cat([h, skips.pop()], dim=1)
            for block in blocks:
                h = block(h, t_emb)
            if attn is not None:
                h = attn(h, image_cond)
            if up is not None:                     # nearest x2, then conv
                h = up(torch.repeat_interleave(
                    torch.repeat_interleave(h, 2, dim=2), 2, dim=3))

        conv, norm, head = self.out
        h = F.silu(norm(conv(h)))
        return head(h.float())


class ConsistencyViewSynthesizer(nn.Module):
    def __init__(self, config: CVSConfig = CVSConfig()):
        super().__init__()
        cfg = self.config = config
        self.image_adapter = ImageFeatureAdapter(
            in_dim=cfg.image_embed_dim, out_dim=cfg.cross_attention_dim,
            num_tokens=cfg.num_image_tokens, dtype=cfg.dtype)
        self.pose_encoder = PluckerPoseEncoder(
            embed_dim=cfg.pose_embed_dim,
            cross_attention_dim=cfg.cross_attention_dim, dtype=cfg.dtype)
        self.unet = ConsistencyUNet(cfg)

    def schedule(self, device="cpu") -> Dict[str, torch.Tensor]:
        return schedule_tables(self.config.num_timesteps,
                               torch.device(device))

    def add_noise(self, x: torch.Tensor, t: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
        sch = self.schedule(x.device)
        sa = sch["sqrt_alphas_cumprod"][t][:, None, None, None]
        so = sch["sqrt_one_minus_alphas_cumprod"][t][:, None, None, None]
        return sa * x + so * noise

    def _unet_in(self, x_t: torch.Tensor,
                 input_image: Optional[torch.Tensor]) -> torch.Tensor:
        if self.config.concat_input_view:
            return torch.cat([x_t, input_image], dim=1)
        return x_t

    def forward(self, input_image: torch.Tensor, input_features: torch.Tensor,
                R_rel: torch.Tensor, t_rel: torch.Tensor,
                target_image: Optional[torch.Tensor] = None,
                timestep: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """Training mode (target_image given): noise the target at
        `timestep` with `noise` and predict x0.  Inference mode: predict
        x0 from `noise` at the last timestep."""
        B = input_image.shape[0]
        image_cond = self.image_adapter(input_features)
        pose_cond = self.pose_encoder(R_rel, t_rel)
        if target_image is not None:
            if timestep is None or noise is None:
                raise ValueError("training mode needs an explicit timestep "
                                 "and noise (the caller draws them)")
            noisy = self.add_noise(target_image, timestep, noise)
            x0 = self.unet(self._unet_in(noisy, input_image),
                           timestep.to(torch.float32), image_cond, pose_cond)
            return {"x0_pred": x0, "target": target_image, "noisy": noisy,
                    "noise": noise, "timestep": timestep}
        if noise is None:
            raise ValueError("inference needs a noise sample")
        t = torch.full((B,), float(self.config.num_timesteps - 1),
                       device=noise.device)
        return {"generated": self.unet(self._unet_in(noise, input_image), t,
                                       image_cond, pose_cond)}

    def predict_x0(self, input_image: torch.Tensor,
                   input_features: torch.Tensor, R_rel: torch.Tensor,
                   t_rel: torch.Tensor, x_t: torch.Tensor,
                   timestep: torch.Tensor) -> torch.Tensor:
        """The U-Net on an already noisy x_t, with no re-noising: the
        consistency branch's EMA target."""
        image_cond = self.image_adapter(input_features)
        pose_cond = self.pose_encoder(R_rel, t_rel)
        return self.unet(self._unet_in(x_t, input_image),
                         timestep.to(torch.float32), image_cond, pose_cond)

    def generate(self, input_features: torch.Tensor, R_rel: torch.Tensor,
                 t_rel: torch.Tensor, noise: torch.Tensor,
                 num_steps: int = 1,
                 extra_noise: Optional[torch.Tensor] = None,
                 input_image: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Multi-step refinement from noise (B, 3, S, S) at the timesteps
        linspace(T - 1, 0, num_steps + 1); extra_noise (num_steps - 1, B,
        3, S, S) perturbs the intermediate steps.  input_image is needed
        with concat_input_view."""
        B = noise.shape[0]
        if self.config.concat_input_view and input_image is None:
            raise ValueError("concat_input_view model: generate() needs "
                             "the input view image")
        image_cond = self.image_adapter(input_features)
        pose_cond = self.pose_encoder(R_rel, t_rel)
        scale = self.schedule(noise.device)["sqrt_one_minus_alphas_cumprod"]
        nt = self.config.num_timesteps
        ts = np.linspace(nt - 1, 0, num_steps + 1).astype(np.int32)
        z = noise
        for i in range(num_steps):
            t = torch.full((B,), float(ts[i]), device=noise.device)
            z = self.unet(self._unet_in(z, input_image), t, image_cond,
                          pose_cond)
            if i < num_steps - 1 and extra_noise is not None:
                z = z + scale[int(ts[i + 1])] * extra_noise[i] * 0.5
        return z


def get_relative_pose(R_source: torch.Tensor, t_source: torch.Tensor,
                      R_target: torch.Tensor, t_target: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relative camera pose from source to target."""
    R_rel = torch.einsum("bij,bkj->bik", R_target, R_source)
    t_rel = t_target - torch.einsum("bij,bj->bi", R_rel, t_source)
    return R_rel, t_rel
