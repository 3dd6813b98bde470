"""Random DINOv2, Depth-Anything and LPIPS checkpoints in the published
layouts.

The published files (`facebook/dinov2-small`, the facebook-research
`dinov2_vits14_pretrain.pth`, `Depth-Anything-V2-Small-hf`) are not in
the repository.  These functions write files with the same names, key
sets and shapes, filled from a numpy seed, so the loaders
(models/vit.py) and every entry point that probes for weights can run the
real ViT-S/14 trunks end to end:

  * `dinov2_checkpoint("hf" | "facebook", ...)`: HF-transformers naming
    (`embeddings.*`, `encoder.layer.i.attention.attention.{query,key,
    value}`, `layernorm`) or facebook-research naming (`blocks.i.attn.qkv`
    fused, `ls1.gamma`, `norm`), each with its mask token;
  * `depth_anything_checkpoint(...)`: `DepthAnythingForDepthEstimation`'s
    HF naming (`backbone.*` as above, `neck.reassemble_stage`,
    `neck.convs`, `neck.fusion_stage` with level 0's dead
    `residual_layer1`, `head.conv1..3`);
  * `lpips_checkpoint("lpips" | "torchvision", ...)`: an lpips-alex
    state dict (the AlexNet trunk's five convs and the five 1x1 `lin`
    heads, non-negative) in the lpips package's naming
    (`net.slice{s}.{j}`, `lin{i}.model.1.weight`, the scaling layer's
    buffers) or torchvision's (`features.{j}`, `lins.{i}.model.1.weight`);
  * `save_checkpoint(path, sd)`: `.pth` by torch.save, `.safetensors` by
    the port's own writer.

The defaults are ViT-S/14 at 518^2 (a 37^2 position grid, as both
published models ship): 22.1 M parameters for DINOv2 and 24.8 M for
Depth-Anything-V2-Small.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from fresnel_tpu_torch.losses.lpips import _ALEX_CFG, _SCALE, _SHIFT
from fresnel_tpu_torch.models.vit import (
    DA_FUSION, DA_HEAD_HIDDEN, DA_NECK_CHANNELS)


class _Draw:
    """Seeded float32 draws: weights ~ N(0, 1 / fan_in), biases and
    LayerScale small, LayerNorm scales near 1."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def weight(self, *shape, fan_in: int) -> np.ndarray:
        return (self.rng.standard_normal(shape)
                / np.sqrt(fan_in)).astype(np.float32)

    def small(self, *shape, scale: float = 0.02) -> np.ndarray:
        return (self.rng.standard_normal(shape) * scale).astype(np.float32)

    def norm(self, n: int) -> np.ndarray:
        return (1.0 + self.small(n, scale=0.1)).astype(np.float32)


def dinov2_checkpoint(naming: str = "hf", width: int = 384, depth: int = 12,
                      heads: int = 6, grid: int = 37, patch: int = 14,
                      seed: int = 0, prefix: str = ""
                      ) -> Dict[str, np.ndarray]:
    """A DINOv2 state dict in `naming` ("hf" or "facebook"), every key
    prefixed with `prefix`.  `heads` does not change a shape; it is
    accepted to name the configuration."""
    if naming not in ("hf", "facebook"):
        raise ValueError(f"unknown naming {naming!r}")
    d = _Draw(seed)
    W, hf = width, naming == "hf"
    sd: Dict[str, np.ndarray] = {}
    emb = "embeddings." if hf else ""
    sd[emb + ("patch_embeddings.projection.weight" if hf
              else "patch_embed.proj.weight")] = d.weight(
        W, 3, patch, patch, fan_in=3 * patch * patch)
    sd[emb + ("patch_embeddings.projection.bias" if hf
              else "patch_embed.proj.bias")] = d.small(W)
    sd[emb + "cls_token"] = d.small(1, 1, W)
    sd[emb + "mask_token"] = d.small(1, W)
    sd[emb + ("position_embeddings" if hf else "pos_embed")] = d.small(
        1, grid * grid + 1, W)
    for i in range(depth):
        p = f"encoder.layer.{i}." if hf else f"blocks.{i}."
        sd[p + "norm1.weight"] = d.norm(W)
        sd[p + "norm1.bias"] = d.small(W)
        if hf:
            for name in ("query", "key", "value"):
                sd[p + f"attention.attention.{name}.weight"] = d.weight(
                    W, W, fan_in=W)
                sd[p + f"attention.attention.{name}.bias"] = d.small(W)
            sd[p + "attention.output.dense.weight"] = d.weight(W, W,
                                                               fan_in=W)
            sd[p + "attention.output.dense.bias"] = d.small(W)
            sd[p + "layer_scale1.lambda1"] = d.small(W, scale=0.1)
        else:
            sd[p + "attn.qkv.weight"] = d.weight(3 * W, W, fan_in=W)
            sd[p + "attn.qkv.bias"] = d.small(3 * W)
            sd[p + "attn.proj.weight"] = d.weight(W, W, fan_in=W)
            sd[p + "attn.proj.bias"] = d.small(W)
            sd[p + "ls1.gamma"] = d.small(W, scale=0.1)
        sd[p + "norm2.weight"] = d.norm(W)
        sd[p + "norm2.bias"] = d.small(W)
        sd[p + "mlp.fc1.weight"] = d.weight(4 * W, W, fan_in=W)
        sd[p + "mlp.fc1.bias"] = d.small(4 * W)
        sd[p + "mlp.fc2.weight"] = d.weight(W, 4 * W, fan_in=4 * W)
        sd[p + "mlp.fc2.bias"] = d.small(W)
        sd[p + ("layer_scale2.lambda1" if hf else "ls2.gamma")] = d.small(
            W, scale=0.1)
    sd["layernorm.weight" if hf else "norm.weight"] = d.norm(W)
    sd["layernorm.bias" if hf else "norm.bias"] = d.small(W)
    return {prefix + k: v for k, v in sd.items()}


def depth_anything_checkpoint(width: int = 384, depth: int = 12,
                              heads: int = 6, grid: int = 37,
                              neck: Sequence[int] = DA_NECK_CHANNELS,
                              fusion: int = DA_FUSION,
                              head_hidden: int = DA_HEAD_HIDDEN,
                              seed: int = 0) -> Dict[str, np.ndarray]:
    """A Depth-Anything-V2 state dict in HF naming: the DINOv2 backbone
    under `backbone.`, the DPT neck and the head.  The last conv's bias
    is 1, so the ReLU'd relative depth is not all zero."""
    sd = dinov2_checkpoint("hf", width, depth, heads, grid, seed=seed,
                           prefix="backbone.")
    d = _Draw(seed + 1)

    def conv(key, c_out, c_in, k, bias=True):
        sd[key + ".weight"] = d.weight(c_out, c_in, k, k, fan_in=c_in * k * k)
        if bias:
            sd[key + ".bias"] = d.small(c_out)

    for i, ch in enumerate(neck):
        r = f"neck.reassemble_stage.layers.{i}."
        conv(r + "projection", ch, width, 1)
        if i in (0, 1):          # ConvTranspose2d: (in, out, k, k)
            k = 4 if i == 0 else 2
            sd[r + "resize.weight"] = d.weight(ch, ch, k, k, fan_in=ch)
            sd[r + "resize.bias"] = d.small(ch)
        elif i == 3:
            conv(r + "resize", ch, ch, 3)
        conv(f"neck.convs.{i}", fusion, ch, 3, bias=False)
    for i in range(len(neck)):
        f = f"neck.fusion_stage.layers.{i}."
        conv(f + "projection", fusion, fusion, 1)
        for res in ("residual_layer1", "residual_layer2"):
            conv(f + res + ".convolution1", fusion, fusion, 3)
            conv(f + res + ".convolution2", fusion, fusion, 3)
    conv("head.conv1", fusion // 2, fusion, 3)
    conv("head.conv2", head_hidden, fusion // 2, 3)
    conv("head.conv3", 1, head_hidden, 1)
    sd["head.conv3.bias"] = np.ones(1, np.float32)
    return sd


# The AlexNet convs' indices in torchvision's `features`; the lpips
# package holds them in slices 1-5.
_ALEX_INDICES = (0, 3, 6, 8, 10)


def lpips_checkpoint(naming: str = "lpips", seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    """An lpips-alex state dict in `naming` ("lpips": the lpips package's
    `LPIPS(net='alex')`, or "torchvision": `alexnet.features` with the
    heads as `lins.{i}`), at the published shapes, random from `seed`;
    the `lin` heads (1, C, 1, 1) are non-negative, as published."""
    if naming not in ("lpips", "torchvision"):
        raise ValueError(f"unknown naming {naming!r}")
    d = _Draw(seed)
    sd: Dict[str, np.ndarray] = {}
    if naming == "lpips":
        sd["scaling_layer.shift"] = _SHIFT.reshape(1, 3, 1, 1)
        sd["scaling_layer.scale"] = _SCALE.reshape(1, 3, 1, 1)
    c_in = 3
    for s, (j, (c, k, _, _)) in enumerate(zip(_ALEX_INDICES, _ALEX_CFG),
                                          start=1):
        pre = f"net.slice{s}.{j}." if naming == "lpips" else f"features.{j}."
        sd[pre + "weight"] = d.weight(c, c_in, k, k, fan_in=c_in * k * k)
        sd[pre + "bias"] = d.small(c, scale=0.05)
        c_in = c
    for i, (c, _, _, _) in enumerate(_ALEX_CFG):
        key = (f"lin{i}" if naming == "lpips" else f"lins.{i}")
        sd[key + ".model.1.weight"] = np.abs(d.small(
            1, c, 1, 1, scale=0.1)).astype(np.float32)
    return sd


def save_checkpoint(path: str, sd: Dict[str, np.ndarray]) -> None:
    """Write a state dict as `.safetensors` (the port's writer) or, for
    any other suffix, a torch `.pth` of tensors."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in sd.items()}
    if str(path).endswith(".safetensors"):
        from fresnel_tpu_torch.train.safetensors_file import (
            write_safetensors)
        write_safetensors(path, tensors)
    else:
        torch.save(tensors, path)


def n_params(sd: Dict[str, np.ndarray]) -> int:
    return int(sum(v.size for v in sd.values()))
