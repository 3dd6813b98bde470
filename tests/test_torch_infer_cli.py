"""Port parity: `cli infer` against the JAX package's `cmd_infer`, on the
CPU, on one 512^2 image: with `results/exp2_k8_model.msgpack` (its
encoder's features), and without a checkpoint (a decoder from seed 0;
JAX's `init` is handed the port's seed-0 weights, since the two packages
draw different random bits): the same kept count after compaction, and
positions, scales, rotations, colours and opacities read back from the
files within 1e-4 absolute (measured below 2e-5).  A checkpoint that
needs an unported option (`use_amp`) raises NotImplementedError naming
the queue (--saag, --no_model and --html are held by
tests/test_torch_viewer.py; --fused_encoder and found backbone weights by
tests/test_torch_backbones.py)."""

import json
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu import cli as jcli
from fresnel_tpu.models.decoders import DirectPatchDecoder as JDecoder

from fresnel_tpu_torch import cli
from fresnel_tpu_torch.core import io as gio
from fresnel_tpu_torch.models.decoders import DirectPatchDecoder
from fresnel_tpu_torch.weights import init_flax_like_
from test_torch_infer_eval_cli import (  # noqa: F401
    FIELDS, K8, _close_clouds, image_path)
from test_torch_threads import _few_threads  # noqa: F401


def _ply_fields(path):
    c = gio.load_ply(path)
    return {k: getattr(c, k).numpy() for k in FIELDS}


def test_infer_with_checkpoint_matches_jax(image_path, tmp_path):
    j_out, t_out = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    args = jcli.build_parser().parse_args(
        ["infer", image_path, j_out, "--checkpoint", K8])
    assert jcli.cmd_infer(args) == 0
    assert cli.main(["infer", image_path, t_out, "--checkpoint", K8,
                     "--device", "cpu"]) == 0
    got, want = _ply_fields(t_out), _ply_fields(j_out)
    assert 10_000 < got["positions"].shape[0] <= 37 * 37 * 8
    _close_clouds(got, want)


def _flax_params(model):
    """The port decoder's weights in the Flax DirectPatchDecoder layout."""
    dense = {}
    for i, layer in enumerate(model.mlp.layers):
        dense[f"Dense_{i}"] = {
            "kernel": jnp.asarray(layer.weight.detach().numpy().T),
            "bias": jnp.asarray(layer.bias.detach().numpy())}
    return {"params": {"MLP_0": dense, "depth_offset": jnp.asarray(
        model.depth_offset.detach().numpy())}}


def test_infer_without_checkpoint_matches_jax(image_path, tmp_path,
                                              monkeypatch):
    model = DirectPatchDecoder(gaussians_per_patch=4)
    init_flax_like_(model, torch.Generator().manual_seed(0))
    seeded = _flax_params(model)
    monkeypatch.setattr(JDecoder, "init", lambda self, *a, **k: seeded)
    j_out, t_out = str(tmp_path / "j.bin"), str(tmp_path / "t.ply")
    assert jcli.cmd_infer(jcli.build_parser().parse_args(
        ["infer", image_path, j_out])) == 0
    assert cli.main(["infer", image_path, t_out, "--device", "cpu"]) == 0
    jc = gio.load_binary(j_out)
    want = {k: getattr(jc, k).numpy() for k in FIELDS}
    got = _ply_fields(t_out)
    assert got["positions"].shape[0] == 37 * 37 * 4
    _close_clouds(got, want)


def test_infer_refuses_unported_options(image_path, tmp_path):
    """`--fused_encoder` is ported (tests/test_torch_backbones.py); a
    checkpoint whose sidecar sets the unported `use_amp` raises, naming
    the queue, with or without it."""
    meta = json.loads(Path(K8 + ".json").read_text())
    meta["config"]["use_amp"] = True
    ckpt = tmp_path / "amp_model.msgpack"
    (tmp_path / "amp_model.msgpack.json").write_text(json.dumps(meta))
    out = str(tmp_path / "x.ply")
    for extra in ([], ["--fused_encoder"], ["--html", "v.html"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.main(["infer", image_path, out, "--device", "cpu",
                      "--checkpoint", str(ckpt)] + extra)
