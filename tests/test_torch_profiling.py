"""Port parity: `utils.image` and `utils.profiling` on the CPU.

* `utils.image`: `depth_range`, `normalize_depth`, `depth_colormap`,
  `save_ppm` / `load_ppm`, `save_png` (the file's bytes) and `resize` at
  up- and downsampling sizes: bit for bit against the JAX package's
  (`resize` against its native C++ path, which the JAX package takes
  whenever its library builds).  `fresnel_tpu_torch.utils` exports the
  JAX package's names but `VLMGuidance` / `density_to_weight_map`.
* `render_with_stats` on a 500-Gaussian cloud at 64^2 with max_per_tile
  32 (so tiles overflow), for the "pairs", "search" and "stream"
  binnings: the image within 1e-5 of the JAX function's, `num_visible`,
  `num_tiles` and the four overflow integers equal, and the overflow
  equal to `render_tiled(return_overflow=True)`'s.  `trace` writes a
  Chrome trace; `StepTimer` times.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu import utils as jutils
from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.core.gaussians import GaussianCloud as JCloud
from fresnel_tpu.render.tile import TileRendererConfig as JCfg
from fresnel_tpu.utils import image as jimage
from fresnel_tpu.utils import profiling as jprof

from fresnel_tpu_torch import utils as tutils
from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.render.tile import TileRendererConfig, render_tiled
from fresnel_tpu_torch.utils import image as timage
from fresnel_tpu_torch.utils import profiling as tprof
from test_torch_threads import _few_threads  # noqa: F401

N, SIZE, M = 500, 64, 32


def test_exports():
    assert set(tutils.__all__) == set(jutils.__all__) - {
        "VLMGuidance", "density_to_weight_map"}


def test_image_helpers_match(tmp_path):
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 3.0, size=(17, 23)).astype(np.float32)
    assert timage.depth_range(depth) == jimage.depth_range(depth)
    for f in ("normalize_depth", "depth_colormap"):
        a, b = getattr(jimage, f)(depth), getattr(timage, f)(depth)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    img = rng.uniform(-0.1, 1.1, size=(9, 13, 3)).astype(np.float32)
    jimage.save_ppm(tmp_path / "j.ppm", img)
    timage.save_ppm(tmp_path / "t.ppm", img)
    assert (tmp_path / "j.ppm").read_bytes() == (tmp_path / "t.ppm").read_bytes()
    assert np.array_equal(jimage.load_ppm(tmp_path / "j.ppm"),
                          timage.load_ppm(tmp_path / "j.ppm"))
    for name, x in (("hwc", img), ("chw", img.transpose(2, 0, 1)),
                    ("depth", depth)):
        jimage.save_png(tmp_path / f"j_{name}.png", x)
        timage.save_png(tmp_path / f"t_{name}.png", x)
        assert ((tmp_path / f"j_{name}.png").read_bytes()
                == (tmp_path / f"t_{name}.png").read_bytes()), name


@pytest.mark.parametrize("shape,out", [((20, 30, 3), (11, 17)),
                                       ((33, 17), (64, 50)),
                                       ((64, 64, 4), (37, 37)),
                                       ((8, 8, 3), (8, 8))])
def test_resize_matches(shape, out):
    from fresnel_tpu import native

    x = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    b = timage.resize(x, *out)
    assert b.shape == out + shape[2:] and b.dtype == np.float32
    img = x[..., None] if x.ndim == 2 else x
    want = native.resize_bilinear(img, *out)
    assert want is not None, "the JAX package's native library did not build"
    assert np.array_equal(b, want[..., 0] if x.ndim == 2 else want)
    assert np.array_equal(b, jimage.resize(x, *out))


@pytest.fixture(scope="module")
def cloud():
    return JCloud.test_cloud(N, seed=0, spread=0.5, z_offset=-2.0,
                             scale=0.08)


@pytest.fixture(scope="module")
def jax_stats(cloud):
    cfg = JCfg(backend="xla", max_per_tile=M)
    return jprof.render_with_stats(
        cloud.positions, cloud.scales, cloud.rotations, cloud.colors,
        cloud.opacities, JCamera.default_training(SIZE), config=cfg)


@pytest.mark.parametrize("binning", ["pairs", "search", "stream"])
def test_render_with_stats_matches(cloud, jax_stats, binning):
    jimg, js = jax_stats
    args = [torch.from_numpy(np.array(getattr(cloud, f))) for f in (
        "positions", "scales", "rotations", "colors", "opacities")]
    cam = Camera.default_training(SIZE)
    cfg = TileRendererConfig(max_per_tile=M, binning=binning)
    img, st = tprof.render_with_stats(*args, cam, config=cfg)
    assert np.abs(img.numpy() - np.asarray(jimg)).max() <= 1e-5
    fields = ("num_gaussians", "num_visible", "num_tiles", "dropped_pairs",
              "total_pairs", "overflow_tiles", "max_tile_hits")
    assert {f: getattr(st, f) for f in fields} == {
        f: getattr(js, f) for f in fields}
    assert st.dropped_pairs > 0 and st.overflow_tiles > 0
    _, ovf = render_tiled(*args, cam, config=cfg, return_overflow=True)
    assert ovf.tolist() == [st.dropped_pairs, st.total_pairs,
                            st.overflow_tiles, st.max_tile_hits]
    assert min(st.project_ms, st.bin_ms, st.composite_ms) > 0
    assert st.total_ms == pytest.approx(
        st.project_ms + st.bin_ms + st.composite_ms)
    assert "overflow" in str(st)


def test_trace_and_step_timer(tmp_path, cloud):
    args = [torch.from_numpy(np.array(getattr(cloud, f))) for f in (
        "positions", "scales", "rotations", "colors", "opacities")]
    with tutils.trace(str(tmp_path / "tr")) as d:
        render_tiled(*args, Camera.default_training(32))
    files = list((tmp_path / "tr").glob("*.json"))
    assert d == str(tmp_path / "tr") and len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    t = tutils.StepTimer()
    t.tic()
    _ = jnp.asarray(sum(range(1000)))
    assert t.toc() >= 0.0 and t.steps_per_sec > 0.0
