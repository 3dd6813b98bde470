"""The port's decoder export, on the CPU: every family of the JAX test
(tests/test_export_families.py::CASES) traces, verifies and loads back;
three families against the JAX module's Flax forward; the `.npz` against
the JAX module's, bit for bit; the Flax names of a port `.pt` checkpoint.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fresnel_tpu.export import export_decoder as jexport
from fresnel_tpu_torch.export import export_decoder as texport
from fresnel_tpu_torch.train.config import PhysicsConfig, TrainingConfig
from fresnel_tpu_torch.train.harness import build_decoder
from fresnel_tpu_torch.weights import decoder_flax_flat, decoder_state_dict
from test_export_families import CASES
from test_torch_threads import _few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "results" / "exp2_model.msgpack")
REF_TOL = 1e-5      # of each output's largest value, against Flax


def _port_decoder(config, seed=7):
    """The decoder the port's Trainer builds for `config`, with weights
    drawn from an explicit generator, in inference mode."""
    known = {f.name for f in dataclasses.fields(TrainingConfig)}
    phys = PhysicsConfig(
        use_wave_rendering=bool(config.get("use_wave_rendering", False)),
        wavelength=float(config.get("physics_wavelength", 0.05)),
        focal_depth=float(config.get("physics_focal_depth", 0.5)),
        learnable_wavelength=bool(
            config.get("physics_learnable_wavelength", True)))
    model = build_decoder(TrainingConfig(
        **{k: v for k, v in config.items() if k in known}), phys)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return model.eval()


def _unflatten(flat):
    """{"a/b": array} -> Flax's nested {"params": {"a": {"b": array}}}."""
    tree = {}
    for path, v in flat.items():
        node = tree
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return {"params": tree}


@pytest.mark.parametrize("name,config", CASES, ids=[c[0] for c in CASES])
def test_family_traces_verifies_and_loads_on_cpu(name, config, tmp_path):
    model = _port_decoder(config)
    out = tmp_path / f"{name}.onnx"
    assert texport.export_onnx(model, config, str(out), device="cpu")
    loaded = torch.jit.load(str(out) + ".pt", map_location="cpu")
    assert not [n for n in loaded.graph.nodes()
                if n.kind() == "prim::Constant"
                and n.output().type().kind() == "DeviceObjType"]
    wrapper = texport.ExportWrapper(model, int(config["experiment"]))
    x = texport._dummy_inputs(config, 384, seed=2)
    with torch.no_grad():
        assert texport.field_errors(loaded(*x), wrapper(*x)) \
            <= texport.EXPORT_TOL


@pytest.fixture
def jitted_flax_apply(monkeypatch):
    """`_flax_reference` builds its decoder with the JAX harness's
    `build_decoder`; its `apply` is jitted here (the same forward, compiled
    once rather than op by op, which took 5-6 s per family)."""
    import jax
    import fresnel_tpu.train.harness as jharness

    build = jharness.build_decoder

    class Jitted:
        def __init__(self, model):
            self.apply = jax.jit(model.apply)

    monkeypatch.setattr(jharness, "build_decoder",
                        lambda *a, **k: Jitted(build(*a, **k)))


@pytest.mark.parametrize("name", ["exp1_saag_refine", "exp2_phase_output",
                                  "exp3_feature_guided"])
def test_family_matches_flax_reference(name, jitted_flax_apply):
    """The port's export wrapper against the JAX module's Flax forward, on
    the port's random weights carried to Flax names by
    `weights.decoder_flax_flat` (a wrong name or layout fails in Flax)."""
    config = dict(CASES)[name]
    model = _port_decoder(config)
    params = _unflatten(decoder_flax_flat(model.state_dict()))
    inputs = texport._dummy_inputs(config, 384)
    with torch.no_grad():
        got = texport.ExportWrapper(model, config["experiment"])(*inputs)
    got = [t.numpy() for t in (got if isinstance(got, tuple) else (got,))]
    want = jexport._flax_reference(config, params, inputs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if g.shape[-1] >= 14:                # quaternions up to sign
            g = g.copy()
            g[..., 6:10] *= np.sign(np.sum(g[..., 6:10] * w[..., 6:10], -1,
                                           keepdims=True))
        elif name.startswith("exp1") and g.shape[-1] == 4:
            g = g * np.sign(np.sum(g * w, -1, keepdims=True))
        assert np.abs(g - w).max() <= REF_TOL * np.abs(w).max()


@pytest.mark.parametrize("name", ["exp1_saag_refine", "exp4_fibonacci",
                                  "exp5_nca", "physics", "exp2_options"])
def test_flax_names_round_trip(name):
    """A port state dict -> Flax names and layouts -> back, bit for bit."""
    config = dict(CASES).get(name) or {
        "experiment": 2, "gaussians_per_patch": 1, "use_pose_encoding": True,
        "use_edge_aware": True, "use_depth_fusion": True,
        "use_phase_output": True, "feature_upsample": 2}
    sd = _port_decoder(config).state_dict()
    flat = decoder_flax_flat(sd)
    assert all("." not in k for k in flat)
    back = decoder_state_dict(flat)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k


def test_npz_matches_jax_bit_for_bit(tmp_path):
    import flax.serialization

    meta = json.loads(Path(CKPT + ".json").read_text())
    tree = flax.serialization.msgpack_restore(Path(CKPT).read_bytes())
    n_j = jexport.export_npz(tree["params"]["model"], meta["config"],
                             str(tmp_path / "j.npz"))
    n_t = texport.export_npz(texport.decoder_flat(CKPT, {}), meta["config"],
                             str(tmp_path / "t.npz"))
    assert n_t == n_j
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape
            assert t[k].tobytes() == j[k].tobytes(), k
    assert (tmp_path / "t.npz.json").read_text() == \
        (tmp_path / "j.npz.json").read_text()


def test_pt_checkpoint_exports_the_flax_names(tmp_path):
    trainer, state, _ = texport.load_decoder(CKPT, device="cpu")
    pt = tmp_path / "exp2.pt"
    trainer.save_checkpoint(pt, state, 300)
    from_pt = texport.decoder_flat(str(pt), state["params"])
    from_msgpack = texport.decoder_flat(CKPT, state["params"])
    assert sorted(from_pt) == sorted(from_msgpack)
    for k, v in from_msgpack.items():
        assert from_pt[k].tobytes() == np.asarray(v, np.float32).tobytes()
    assert texport.main([str(pt), "--npz", str(tmp_path / "pt.npz"),
                         "--device", "cpu"]) == 0
    with np.load(tmp_path / "pt.npz") as z:
        assert sorted(z.files) == sorted(from_msgpack)


def test_dummy_inputs_ignore_the_global_generator():
    config = dict(CASES)["exp1_saag_refine"]
    state = torch.get_rng_state()        # left as found for other files
    try:
        torch.manual_seed(123)
        a = texport._dummy_inputs(config, 384)
        torch.manual_seed(456)
        torch.rand(17)
        b = texport._dummy_inputs(config, 384)
    finally:
        torch.set_rng_state(state)
    c = texport._dummy_inputs(config, 384, seed=1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_mismatch_exits_one_and_writes_nothing(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setattr(texport, "EXPORT_TOL", -1.0)
    argv = [CKPT, "--npz", str(tmp_path / "w.npz"), "--onnx",
            str(tmp_path / "m.onnx"), "--device", "cpu"]
    assert texport.main(argv) == 1
    assert "ONNX export MISMATCH" in capsys.readouterr().out
    assert list(tmp_path.iterdir()) == []
