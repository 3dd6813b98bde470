"""Port parity: the three sharded renders (`parallel.render`) against the
JAX package's `parallel/render.py`, on the CPU, at tests/test_parallel.py's
sizes and tolerances: four gloo ranks spawned once by
`parallel.launch.run_job` (the children import the port only), against
JAX's 4-device CPU mesh.  Each render is also held against the port's own
`render_tiled` at the same tolerance.

* batch-sharded: 4 clouds of 40 Gaussians at 32^2, max_per_tile 64,
  within 1e-5 (measured 1.2e-7 against JAX, 0.0 against render_tiled);
* Gaussian-sharded: 160 Gaussians pre-sorted front to back (JAX's sort,
  handed to both sides) at 32^2 with capacity 256 >= N, background (0.1,
  0.2, 0.3), within 2e-3 (JAX's own bound for the slab fold against one
  render; measured 1.2e-7 against both);
* pixel-sharded: 100 Gaussians at 64^2, 16-row bands, max_per_tile 128,
  within 2e-3 (measured 1.8e-7 against JAX, 5.7e-7 against
  render_tiled);
* a height of 50 over 4 ranks raises ValueError "not divisible".
Every rank returns the whole image; the ranks' images are bit for bit
equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.core.gaussians import GaussianCloud as JCloud
from fresnel_tpu.parallel import render as jrender
from fresnel_tpu.parallel.mesh import get_mesh
from fresnel_tpu.render.projection import (
    depth_sort_indices, project_gaussians)
from fresnel_tpu.render.tile import TileRendererConfig as JConfig

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.parallel import launch
from fresnel_tpu_torch.render.tile import TileRendererConfig, render_tiled
from test_torch_threads import _few_threads  # noqa: F401

BG = (0.1, 0.2, 0.3)


def _fields(clouds):
    return [np.stack([np.asarray(getattr(c, k)) for c in clouds])
            for k in ("positions", "scales", "rotations", "colors",
                      "opacities")]


def _cases():
    """(name, fields, size, max_per_tile, background) of each render, the
    fields numpy arrays as JAX's test builds them."""
    batch = _fields([JCloud.test_cloud(40, seed=s, z_offset=-2.0)
                     for s in range(4)])
    cloud = JCloud.test_cloud(160, seed=7, spread=0.5, z_offset=-2.0)
    cam = JCamera.default_training(32)
    proj = project_gaussians(cloud.positions, cloud.scales, cloud.rotations,
                             cam)
    proj = dataclasses.replace(proj,
                               visible=proj.visible & (cloud.opacities > 0))
    order = np.asarray(depth_sort_indices(proj))
    slab = [f[0][order] for f in _fields([cloud])]
    pix = [f[0] for f in _fields([JCloud.test_cloud(100, seed=3, spread=0.5,
                                                    z_offset=-2.0)])]
    return [("batch", batch, 32, 64, None), ("gaussian", slab, 32, 256, BG),
            ("pixel", pix, 64, 128, BG)]


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    cases = _cases()
    tasks = []
    for kind, fields, size, m, bg in cases:
        t = {"task": "render", "kind": kind, "fields": fields,
             "camera": Camera.default_training(size),
             "config": TileRendererConfig(max_per_tile=m)}
        if bg is not None:
            t["background"] = bg
        tasks.append(t)
    tasks.append({"task": "raises", "inner": dict(
        tasks[2], fields=[f[:10] for f in cases[2][1]],
        camera=Camera.default_training(50))})
    res = launch.run_job(tasks, 4, tmp_path_factory.mktemp("prender"),
                         device="cpu", threads=1)
    mesh = get_mesh(4)
    want = {}
    for kind, fields, size, m, bg in cases:
        fn = getattr(jrender, f"render_{kind}_sharded")
        kw = {} if bg is None else {"background": bg}
        want[kind] = np.asarray(fn(*[jnp.asarray(f) for f in fields],
                                   JCamera.default_training(size), mesh,
                                   config=JConfig(max_per_tile=m), **kw))
    return dict(cases=cases, ranks=res, want=want)


@pytest.mark.parametrize("i,kind,tol", [(0, "batch", 1e-5),
                                        (1, "gaussian", 2e-3),
                                        (2, "pixel", 2e-3)])
def test_sharded_render_matches_jax(renders, i, kind, tol):
    _, fields, size, m, bg = renders["cases"][i]
    got = [r[i]["image"] for r in renders["ranks"]]
    assert renders["ranks"][0][i]["kind"] == kind
    for g in got[1:]:
        assert torch.equal(g, got[0])
    want = renders["want"][kind]
    assert tuple(got[0].shape) == want.shape
    np.testing.assert_allclose(got[0].numpy(), want, atol=tol)
    cam = Camera.default_training(size)
    cfg = TileRendererConfig(max_per_tile=m)
    kw = {} if bg is None else {"background": bg}
    t = [torch.from_numpy(f) for f in fields]
    if kind == "batch":
        ref = torch.stack([render_tiled(*[f[b] for f in t], cam, config=cfg)
                           for b in range(t[0].shape[0])])
    else:
        ref = render_tiled(*t, cam, config=cfg, **kw)
    np.testing.assert_allclose(got[0].numpy(), ref.numpy(), atol=tol)


def test_pixel_sharded_rejects_indivisible_height(renders):
    for r in renders["ranks"]:
        assert "not divisible" in r[3]
