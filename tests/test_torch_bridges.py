"""The port's binary-protocol bridges against the JAX package's, on the
CPU: the same files and printed lines from the same 48^2 seeded PNG.

`dinov2` within 3e-5 (the patch extractor's tolerance in
test_torch_dataset.py), `depth` within 1e-6 (test_torch_encoders.py's),
`decoder` with the committed exp2 checkpoint within 1e-5 of each field's
largest value (quaternions up to sign), `test_novel_views` means and
coverages within 1e-4.  Without a checkpoint the two decoders are
initialised from different generators (JAX's PRNGKey(0) cannot be drawn
without JAX), so only the port's contract is held.
"""

import contextlib
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from fresnel_tpu.inference import bridges as jb
from fresnel_tpu_torch.inference import bridges as tb
from test_torch_threads import _few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "results" / "exp2_model.msgpack")
FIELDS = ((0, 3), (3, 6), (6, 10), (10, 13), (13, 14))
VIEWS, SIZE = 4, 64


def _run(fn, argv, **kw):
    """(return code, stdout) of a bridge command."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv, **kw)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The seeded PNG, and the JAX module's features and depth of it."""
    d = tmp_path_factory.mktemp("bridges")
    rng = np.random.default_rng(48)
    y, x = np.mgrid[0:48, 0:48] / 48.0
    img = 0.5 + 0.3 * np.sin(2 * np.pi * (x + rng.uniform(size=(3, 1, 1))))
    img[:, (x - 0.5) ** 2 + (y - 0.5) ** 2 < 0.06] = rng.uniform(
        size=(3, 1))
    img += rng.uniform(-0.1, 0.1, img.shape)
    png = d / "img.png"
    Image.fromarray((np.clip(img, 0, 1).transpose(1, 2, 0) * 255).astype(
        np.uint8)).save(png)
    rc_f, line_f = _run(jb.cmd_dinov2, [str(png), str(d / "jf.bin")])
    rc_d, _ = _run(jb.cmd_depth, [str(png), str(d / "jd.bin")])
    assert rc_f == rc_d == 0
    return {"dir": d, "png": str(png), "line": line_f}


def test_dinov2_matches_jax(work):
    d = work["dir"]
    rc, line = _run(tb.cmd_dinov2, [work["png"], str(d / "tf.bin")],
                    device="cpu")
    assert rc == 0 and line == work["line"] == "37 37 384\n"
    got = np.fromfile(d / "tf.bin", np.float32)
    want = np.fromfile(d / "jf.bin", np.float32)
    assert got.size == want.size == 37 * 37 * 384
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)


@pytest.mark.parametrize("argv", [[], ["128", "96"]], ids=["default", "W128"])
def test_depth_matches_jax(work, argv):
    d = work["dir"]
    _run(jb.cmd_depth, [work["png"], str(d / "jd2.bin"), *argv])
    rc, line = _run(tb.cmd_depth, [work["png"], str(d / "td.bin"), *argv],
                    device="cpu")
    assert rc == 0 and line == ""
    got = np.fromfile(d / "td.bin", np.float32)
    want = np.fromfile(d / "jd2.bin", np.float32)
    side = int(argv[0]) if argv else 256
    assert got.size == want.size == side * side
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_decoder_with_checkpoint_matches_jax(work):
    d = work["dir"]
    ins = [str(d / "jf.bin"), str(d / "jd.bin")]
    rc_j, n_j = _run(jb.cmd_decoder, [*ins, str(d / "jg.bin"), CKPT])
    rc_t, n_t = _run(tb.cmd_decoder, [*ins, str(d / "tg.bin"), CKPT],
                     device="cpu")
    assert rc_j == rc_t == 0 and n_t == n_j
    n = int(n_t)
    got = np.fromfile(d / "tg.bin", np.float32).reshape(n, 14)
    want = np.fromfile(d / "jg.bin", np.float32).reshape(n, 14)
    sign = np.where(np.sum(got[:, 6:10] * want[:, 6:10], -1) < 0, -1, 1)
    got[:, 6:10] *= sign[:, None]
    for a, b in FIELDS:
        scale = np.abs(want[:, a:b]).max()
        assert np.abs(got[:, a:b] - want[:, a:b]).max() <= 1e-5 * scale, \
            (a, b)


def test_decoder_without_checkpoint_contract(work):
    d = work["dir"]
    rc, line = _run(tb.cmd_decoder, [str(d / "jf.bin"), str(d / "jd.bin"),
                                     str(d / "t0.bin")], device="cpu")
    assert rc == 0 and line == "5476\n"
    g = np.fromfile(d / "t0.bin", np.float32).reshape(5476, 14)
    assert np.isfinite(g).all()
    assert (g[:, 3:6] > 0).all()
    np.testing.assert_allclose(np.linalg.norm(g[:, 6:10], axis=-1), 1.0,
                               atol=1e-5)


def _views(text):
    lines = text.splitlines()
    rows = [re.fullmatch(r"az=(\d+) mean=([\d.]+) coverage=([\d.]+)", ln)
            for ln in lines[:-1]]
    assert all(rows), lines
    return [(r[1], float(r[2]), float(r[3])) for r in rows], lines[-1]


def test_novel_views_match_jax(work):
    d = work["dir"]
    argv = [CKPT, str(VIEWS), str(SIZE)]
    rc_j, out_j = _run(jb.cmd_test_novel_views,
                       [work["png"], str(d / "jv"), *argv])
    rc_t, out_t = _run(tb.cmd_test_novel_views,
                       [work["png"], str(d / "tv"), *argv], device="cpu")
    (rows_j, verdict_j), (rows_t, verdict_t) = _views(out_j), _views(out_t)
    assert rc_t == rc_j and verdict_t == verdict_j
    assert [r[0] for r in rows_t] == [r[0] for r in rows_j] == \
        ["0", "90", "180", "270"]
    for (_, m_t, c_t), (_, m_j, c_j) in zip(rows_t, rows_j):
        assert abs(m_t - m_j) <= 1e-4 and abs(c_t - c_j) <= 1e-4
    names = sorted(p.name for p in (d / "tv").iterdir())
    assert names == sorted(p.name for p in (d / "jv").iterdir())
    assert len(names) == VIEWS


def test_decoder_on_experiment1_checkpoint_raises(work, tmp_path):
    from fresnel_tpu_torch.train.config import TrainingConfig
    from fresnel_tpu_torch.train.harness import Trainer

    t = Trainer(TrainingConfig(experiment=1, image_size=32), device="cpu")
    ckpt = tmp_path / "exp1.pt"
    t.save_checkpoint(ckpt, t.init_state(), 0)
    d = work["dir"]
    with pytest.raises(ValueError, match="SAAG prior"):
        tb.cmd_decoder([str(d / "jf.bin"), str(d / "jd.bin"),
                        str(tmp_path / "o.bin"), str(ckpt)], device="cpu")
    assert not (tmp_path / "o.bin").exists()


@pytest.mark.parametrize("cmd", ["dinov2", "depth", "decoder",
                                 "test_novel_views", None])
def test_usage_errors_return_one(cmd, capsys):
    assert tb.main([cmd] if cmd else []) == 1
    assert capsys.readouterr().err.startswith("usage: ")
