"""Decoder export: npz weights, and the decoder as an ONNX file (or a
TorchScript module where the ONNX serializer is missing), every family.

Counterpart of fresnel_tpu/export/export_decoder.py:
  * `export_npz` writes the same framework-neutral `.npz` as the JAX
    module: the decoder's Flax parameter paths joined by "/" (the
    `params` root dropped) in Flax layouts, and the sidecar's training
    config as `.json` beside it.  A Flax msgpack's own leaves are written
    as they are; a port `.pt` checkpoint's through
    `weights.decoder_flax_flat`, the inverse of
    `weights.decoder_state_dict`.
  * `export_onnx` wraps the port's decoder (already a torch module: no
    mirror is built) in the reference's input convention (`ExportWrapper`:
    features (1, C, 37, 37) channels first, depth (1, 1, H, W)), traces it
    on `device`, holds the traced module against the eager one on the
    dummy inputs and on a second seeded draw (a value baked into the trace
    shows there), and only then writes it: `torch.onnx.export` (opset 16),
    else `torch.jit.trace`'s module to OUT + ".pt".  The trace's device
    arguments are rewritten to follow the first input's device, so a
    module traced on the card loads with `torch.jit.load(...,
    map_location="cpu")` and runs on the CPU.

Differences from the JAX module: the dummy inputs come from a
`torch.Generator` seeded here (the JAX module draws its features from
torch's global generator), and on a mismatch nothing is written and
`main` exits 1 (the JAX module writes the file and exits 0).

Run:  python -m fresnel_tpu_torch.export.export_decoder CKPT \\
          [--npz out.npz] [--onnx out.onnx] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import warnings
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fresnel_tpu_torch.device import resolve_device
from fresnel_tpu_torch.train.flax_msgpack import read_flat
from fresnel_tpu_torch.weights import decoder_flax_flat

# Each output field's error relative to its largest value, traced against
# eager (float32, the same ops; a fuser may round an op differently).
EXPORT_TOL = 1e-5
GAUSSIAN_FIELDS = ("positions", "scales", "rotations", "colors", "opacities")
SAAG_MAPS = ("aspect_ratio_mult", "edge_threshold_add", "edge_shrink_mult",
             "normal_strength_mult", "base_size_mult", "opacity_mult")
# (input names, output names) per experiment; every other family takes
# (features, depth) and returns one (N, 14 [+ phases]) tensor.
FAMILY_IO = {
    1: (["features", "saag_positions", "saag_scales", "saag_rotations",
         "saag_colors", "saag_opacities"], list(GAUSSIAN_FIELDS)),
    3: (["features"], list(SAAG_MAPS)),
}
DEFAULT_IO = (["features", "depth"], ["gaussians"])
# Column slices of the (N, 14 [+ phases]) output, one per field.
COLUMNS = ((0, 3), (3, 6), (6, 10), (10, 13), (13, 14), (14, None))


def decoder_flat(checkpoint, params: Mapping[str, torch.Tensor]
                 ) -> Dict[str, np.ndarray]:
    """The decoder's params, flat in Flax names and layouts: a Flax
    msgpack's own model leaves, or the port Trainer's `model.*` params
    through `weights.decoder_flax_flat`."""
    if str(checkpoint).endswith(".msgpack"):
        pre = "params/model/params/"
        return {k[len(pre):]: v for k, v in read_flat(checkpoint).items()
                if k.startswith(pre)}
    return decoder_flax_flat({k[len("model."):]: v for k, v in params.items()
                              if k.startswith("model.")})


def export_npz(flat: Mapping[str, np.ndarray], config: dict, out_path) -> int:
    np.savez(out_path, **flat)
    Path(str(out_path) + ".json").write_text(json.dumps(config, indent=2))
    return len(flat)


class ExportWrapper(nn.Module):
    """A decoder in the reference's convention, in inference mode:
    experiment 1 (features, the five SAAG prior tensors) -> the five
    refined fields, batched; experiment 3 (features) -> the six modulation
    maps; every other family (features, depth) -> (N, 14 [+ phases])
    [pos3, scale3, quat_wxyz4, rgb3, opacity1, phases] of the first
    sample."""

    def __init__(self, decoder: nn.Module, experiment: int):
        super().__init__()
        self.decoder = decoder
        self.experiment = experiment

    def forward(self, features: torch.Tensor, *rest: torch.Tensor):
        feats = features.permute(0, 2, 3, 1)
        if self.experiment == 1:
            out = self.decoder(feats, *rest)
            return tuple(out[k] for k in GAUSSIAN_FIELDS)
        if self.experiment == 3:
            out = self.decoder(feats)
            return tuple(out[k] for k in SAAG_MAPS)
        out = self.decoder(feats, rest[0][:, 0])
        cols = [out[k][0] for k in GAUSSIAN_FIELDS[:4]]
        cols.append(out["opacities"][0][:, None])
        if "phases" in out:
            ph = out["phases"][0]
            cols.append(ph[:, None] if ph.dim() == 1 else ph)
        return torch.cat(cols, -1)


def _dummy_inputs(config: dict, feature_dim: int, seed: int = 0,
                  device=None) -> Tuple[torch.Tensor, ...]:
    """The reference convention's inputs of the config's family, the
    shapes of the JAX module's, drawn from a generator seeded with `seed`
    (never torch's global one) and moved to `device`."""
    g = torch.Generator().manual_seed(seed)
    exp = int(config.get("experiment", 2))
    feats = torch.randn(1, feature_dim, 37, 37, generator=g)
    if exp == 1:
        n = 200
        pos = torch.randn(1, n, 3, generator=g)
        pos[..., 2] = pos[..., 2].abs() + 0.5
        rot = torch.zeros(1, n, 4)
        rot[..., 0] = 1.0
        inputs = (feats, pos, torch.rand(1, n, 3, generator=g) * 0.1, rot,
                  torch.rand(1, n, 3, generator=g),
                  torch.rand(1, n, generator=g))
    elif exp == 3:
        inputs = (feats,)
    else:
        inputs = (feats, torch.rand(1, 1, 256, 256, generator=g))
    return tuple(t.to(device) for t in inputs)


def _outputs(out) -> Sequence[torch.Tensor]:
    return list(out) if isinstance(out, tuple) else [out]


def field_errors(got, want) -> float:
    """The largest error of any output field relative to that field's
    largest value: each output of a tuple is a field; an (N, 14+) tensor
    holds one field per `COLUMNS` slice."""
    errs = []
    for g, w in zip(_outputs(got), _outputs(want)):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        if g.shape != w.shape:
            raise ValueError(f"output shape mismatch {tuple(g.shape)} vs "
                             f"{tuple(w.shape)}")
        parts = ([(g[:, a:b], w[:, a:b]) for a, b in COLUMNS]
                 if g.dim() == 2 and g.shape[1] >= 14 else [(g, w)])
        for gp, wp in parts:
            if wp.numel():
                scale = max(wp.abs().max().item(), 1e-12)
                errs.append((gp - wp).abs().max().item() / scale)
    return max(errs)


def _follow_input_device(traced: torch.jit.ScriptModule,
                         device: torch.device) -> None:
    """Inline `traced`'s forward and replace each constant device argument
    of `device`'s type (the tracing device's, any index) by the first
    input's device (`prim::device`), so the module runs where its inputs
    are."""
    graph = traced.graph
    torch._C._jit_pass_inline(graph)
    first = list(graph.inputs())[1]                  # after `self`
    for node in list(graph.nodes()):
        if (node.kind() == "prim::Constant"
                and node.output().type().kind() == "DeviceObjType"
                and node.output().toIValue().type == device.type):
            dev = graph.create("prim::device", [first])
            dev.output().setType(node.output().type())
            dev.insertBefore(node)
            node.output().replaceAllUsesWith(dev.output())
            node.destroy()


def trace(wrapper: nn.Module, inputs: Sequence[torch.Tensor]
          ) -> torch.jit.ScriptModule:
    """`wrapper` traced on `inputs`' device, its device arguments
    following its first input."""
    with warnings.catch_warnings():
        # Shapes read while tracing become constants: the export is for
        # the reference's fixed shapes, and `export_onnx` holds the trace
        # against the eager module on a second draw.
        warnings.simplefilter("ignore")
        traced = torch.jit.trace(wrapper, tuple(inputs), check_trace=False,
                                 strict=False)
    _follow_input_device(traced, inputs[0].device)
    return traced


def export_onnx(decoder: nn.Module, config: dict, out_path: str,
                feature_dim: int = 384, device=None) -> bool:
    """Export any decoder family to ONNX (TorchScript fallback) after
    holding its trace on `device` (CUDA when None) against the eager
    decoder on two seeded draws, within EXPORT_TOL of each field's largest
    value.  On a mismatch nothing is written and it returns False."""
    dev = resolve_device(device)
    exp = int(config.get("experiment", 2))
    wrapper = ExportWrapper(decoder, exp).to(dev).eval()
    inputs = _dummy_inputs(config, feature_dim, seed=0, device=dev)
    with torch.no_grad():
        traced = trace(wrapper, inputs)
        # The graph the file holds, run as recorded: the executor's
        # optimizing pass would compile fused kernels at the second call
        # (about 3 s a decoder on an H100), which whoever loads the file
        # does on their own device.
        with torch.jit.optimized_execution(False):
            err = max(field_errors(traced(*x), wrapper(*x))
                      for x in (inputs, _dummy_inputs(config, feature_dim,
                                                      seed=1, device=dev)))
    print(f"traced module max error vs eager (of each field's largest "
          f"value): {err:.2e}")
    if not err <= EXPORT_TOL:
        return False
    names = FAMILY_IO.get(exp, DEFAULT_IO)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.onnx.export(wrapper, inputs, out_path,
                              input_names=names[0], output_names=names[1],
                              opset_version=16, dynamo=False)
    except Exception as e:   # the serializer's packages may be missing
        print(f"ONNX serialization unavailable ({e}); exporting TorchScript "
              f"module instead")
        traced.save(out_path + ".pt")
    return True


def load_decoder(checkpoint, device=None):
    """(trainer, state, the decoder module with the checkpoint's weights
    on the trainer's device) of a checkpoint with its `.json` sidecar."""
    from fresnel_tpu_torch.train.harness import trainer_from_checkpoint

    trainer = trainer_from_checkpoint(checkpoint, device=device)
    state, _ = trainer.load_checkpoint(checkpoint)
    decoder = trainer.model
    decoder.load_state_dict({k[len("model."):]: v
                             for k, v in state["params"].items()
                             if k.startswith("model.")})
    return trainer, state, decoder.eval()


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Export a trained decoder")
    p.add_argument("checkpoint")
    p.add_argument("--npz", default=None)
    p.add_argument("--onnx", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the trace is made and verified: cuda "
                        "(default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    trainer, state, decoder = load_decoder(args.checkpoint, device=dev)
    meta = json.loads(Path(args.checkpoint + ".json").read_text())
    # The trace is verified before anything is written: a mismatch leaves
    # no file behind.
    if args.onnx and not export_onnx(
            decoder, meta["config"], args.onnx,
            feature_dim=trainer.config.feature_dim, device=dev):
        print(f"ONNX export MISMATCH -> {args.onnx} (nothing written)")
        return 1
    if args.npz:
        n = export_npz(decoder_flat(args.checkpoint, state["params"]),
                       meta["config"], args.npz)
        print(f"exported {n} weight arrays -> {args.npz}")
    if args.onnx:
        print(f"ONNX export verified -> {args.onnx}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
