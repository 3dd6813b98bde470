"""Port parity: the HTML viewer (viewer/html_viewer.py), the live reprocess
server (viewer/serve.py) and `cli infer --saag / --no_model / --html` and
`cli view` against the JAX package, on the CPU.

* `saag_categories`: equal to the JAX package's for every combination of
  stages, and as long as the cloud `to_surface_gaussians` emits.
* `build_html` / `pack_cloud`: byte for byte against the JAX package's on
  the same numpy cloud (the port's given as tensors), with and without
  categories, under a cap with tied opacities (numpy's unstable argsort on
  the host on both sides), and with the server's panel and script.
* `cli infer --saag --html` on a 64^2 PNG (read at 512^2; the SAAG grid
  is 256^2) against `fresnel_tpu.cli` in the same directory: the same
  number of Gaussians kept and in the viewer; the PLYs' positions,
  scales, colours and opacities within 1e-5 and rotations within 2e-4
  (the depth estimators differ by ~1e-6, and arccos near a flat normal
  magnifies that; measured 1.6e-6 and 7.9e-5); the page outside its
  payload byte for byte.  `--no_model` without a checkpoint writes the
  same files as `--saag`.
* `cli view` of a PLY: the same bytes as the JAX package's.
* The server on port 0 (as tests/test_viewer.py drives the JAX one): the
  page with its reprocess panel; reprocess with subsample 1 and 2
  against the JAX package's session on the same image and depth (the
  same counts; payloads within 1e-5 but for rotations, 1e-6); a bad
  parameter answered with {"error": ...}; /render at 64^2 a PNG that is
  not all background; /export.ply read back.  Every answer's status is
  checked and none may hold "error" unless the test asks for one.
"""

import base64
import json
import threading
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from fresnel_tpu.core import gaussians as jg
from fresnel_tpu.core import io as jio
from fresnel_tpu.geometry import saag as J
from fresnel_tpu.viewer import html_viewer as jhv
from fresnel_tpu.viewer import serve as jserve

from fresnel_tpu_torch import cli
from fresnel_tpu_torch.core import gaussians as tg
from fresnel_tpu_torch.core import io as tio
from fresnel_tpu_torch.geometry import saag as T
from fresnel_tpu_torch.viewer import html_viewer as thv
from fresnel_tpu_torch.viewer import serve as tserve
from test_torch_threads import _few_threads  # noqa: F401

F = 15   # floats per packed Gaussian


def _payload(html):
    """(page without its base64 payload, (n, 15) floats of the payload)."""
    start = html.index('loadCloud("') + len('loadCloud("')
    end = html.index('"', start)
    data = np.frombuffer(base64.b64decode(html[start:end]), "<f4")
    return html[:start] + html[end:], data.reshape(-1, F)


def _numpy_cloud(n, seed, tied=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    op = rng.uniform(size=n).astype(np.float32)
    if tied:
        op = np.round(op * 8) / 8          # many equal opacities
    op[:5] = 0.0                           # masked entries
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(0.01, 0.1, (n, 3)).astype(np.float32), q,
            rng.uniform(size=(n, 3)).astype(np.float32), op)


def _clouds(fields):
    return (jg.GaussianCloud(*map(jnp.asarray, fields)),
            tg.GaussianCloud(*map(torch.from_numpy, fields)))


@pytest.mark.parametrize("shell", [True, False])
@pytest.mark.parametrize("walls", [True, False])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("density", [True, False])
def test_saag_categories_match_the_block_layout(shell, walls, wrap, density):
    depth = torch.rand(16, 16, generator=torch.Generator().manual_seed(0))
    pc = T.pointcloud_from_depth(depth, depth_scale=2.0).normalize(3.0)
    wp = T.SilhouetteWrapParams(enabled=wrap)
    shp = T.VolumetricShellParams(enabled=shell, connect_walls=walls)
    dp = T.AdaptiveDensityParams(enabled=density)
    cloud = T.to_surface_gaussians(pc, depth, wrap_params=wp,
                                   shell_params=shp, density_params=dp)
    cats = thv.saag_categories(pc.num_points, wp, shp, dp)
    want = jhv.saag_categories(
        pc.num_points, J.SilhouetteWrapParams(enabled=wrap),
        J.VolumetricShellParams(enabled=shell, connect_walls=walls),
        J.AdaptiveDensityParams(enabled=density))
    np.testing.assert_array_equal(cats, want)
    assert len(cats) == cloud.num_gaussians
    n = pc.num_points
    assert (cats[:n] == 0).all()
    if shell:
        assert (cats[n:2 * n] == 1).all()


@pytest.mark.parametrize("case", ["plain", "categories", "tied_cap",
                                  "served"])
def test_build_html_bytes_match_jax(case):
    fields = _numpy_cloud(3000, 1, tied=case == "tied_cap")
    jc, tc = _clouds(fields)
    kw = dict(max_gaussians=1000 if case == "tied_cap" else 30000,
              distance=2.5)
    if case in ("categories", "tied_cap"):
        kw["categories"] = np.random.default_rng(2).integers(
            0, 5, 3000).astype(np.uint8)
    if case == "served":
        kw.update(serve_panel=jserve._serve_panel(),
                  serve_js=jserve._serve_js())
        assert kw["serve_panel"] == tserve._serve_panel()
        assert kw["serve_js"] == tserve._serve_js()
    want = jhv.build_html(jc, **kw)
    got = thv.build_html(tc, **kw)
    assert got[1] == want[1]
    assert got[0] == want[0]


def test_pack_cloud_rejects_a_category_length_mismatch():
    _, tc = _clouds(_numpy_cloud(10, 0))
    with pytest.raises(ValueError, match="categories length"):
        thv.pack_cloud(tc, np.zeros(3, np.uint8))


def _png(path, size=64, seed=0):
    rng = np.random.default_rng(seed)
    Image.fromarray((rng.uniform(size=(size, size, 3)) * 255).astype(
        np.uint8)).save(path)
    return str(path)


@pytest.fixture(scope="module")
def infer_runs(tmp_path_factory):
    from fresnel_tpu import cli as jcli
    d = tmp_path_factory.mktemp("infer")
    img = _png(d / "img.png")
    assert jcli.main(["infer", img, str(d / "j.ply"), "--saag", "--html",
                      str(d / "j.html")]) == 0
    assert cli.main(["infer", img, str(d / "t.ply"), "--saag", "--html",
                     str(d / "t.html"), "--device", "cpu"]) == 0
    assert cli.main(["infer", img, str(d / "n.ply"), "--no_model", "--html",
                     str(d / "n.html"), "--device", "cpu"]) == 0
    return d


def test_infer_saag_matches_jax(infer_runs):
    d = infer_runs
    want, got = jio.load_ply(str(d / "j.ply")), tio.load_ply(str(d / "t.ply"))
    assert got.num_gaussians == want.num_gaussians
    assert 0 < got.num_gaussians < 12 * 256 * 256
    for k in ("positions", "scales", "rotations", "colors", "opacities"):
        tol = 2e-4 if k == "rotations" else 1e-5
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=tol, err_msg=k)
    jpage, jdata = _payload((d / "j.html").read_text())
    tpage, tdata = _payload((d / "t.html").read_text())
    assert tpage == jpage and len(tdata) == len(jdata) == 30000
    assert set(np.unique(tdata[:, 14])) <= {0.0, 1.0, 2.0, 3.0, 4.0}
    assert "const HAS_CATS = true;" in tpage


def test_no_model_writes_what_saag_writes(infer_runs):
    d = infer_runs
    assert (d / "n.ply").read_bytes() == (d / "t.ply").read_bytes()
    assert (d / "n.html").read_text() == (d / "t.html").read_text()


def test_infer_model_path_with_html(tmp_path):
    img = _png(tmp_path / "img.png", seed=1)
    assert cli.main(["infer", img, str(tmp_path / "m.ply"), "--html",
                     str(tmp_path / "m.html"), "--gaussians_per_patch", "1",
                     "--device", "cpu"]) == 0
    kept = tio.load_ply(str(tmp_path / "m.ply")).num_gaussians
    page, data = _payload((tmp_path / "m.html").read_text())
    assert "const HAS_CATS = false;" in page
    assert len(data) <= kept and (data[:, 14] == 0).all()


def test_view_static_matches_jax(tmp_path):
    from fresnel_tpu import cli as jcli
    fields = _numpy_cloud(500, 4)
    fields[4][:] = np.clip(fields[4], 0.05, 0.95)   # PLY logit round trip
    _, tc = _clouds(fields)
    tio.save_ply(tmp_path / "c.ply", tc)
    assert jcli.main(["view", str(tmp_path / "c.ply"),
                      str(tmp_path / "j.html"), "--max_gaussians", "300"]) == 0
    assert cli.main(["view", str(tmp_path / "c.ply"),
                     str(tmp_path / "t.html"), "--max_gaussians", "300",
                     "--device", "cpu"]) == 0
    assert (tmp_path / "t.html").read_bytes() == (
        tmp_path / "j.html").read_bytes()


# ----------------------------------------------------------------------
# The live reprocess server
# ----------------------------------------------------------------------

def _session_inputs():
    rng = np.random.default_rng(3)
    img = rng.uniform(0.2, 0.9, (32, 32, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:32, 0:32]
    depth = ((xx + yy) / 62.0).astype(np.float32)
    return img, depth


class Client:
    def __init__(self, base):
        self.base = base

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()

    def post_json(self, path, obj):
        req = urllib.request.Request(
            self.base + path, data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200
            return json.loads(r.read())


@pytest.fixture(scope="module")
def server():
    img, depth = _session_inputs()
    session = tserve.ReprocessSession(img, depth, grid=32, device="cpu")
    httpd = tserve.make_server(session, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield Client(f"http://127.0.0.1:{httpd.server_address[1]}")
    httpd.shutdown()
    httpd.server_close()
    thread.join()


def test_page_has_reprocess_panel(server):
    status, ctype, body = server.get("/")
    html = body.decode()
    assert status == 200 and "text/html" in ctype
    assert "loadCloud(" in html and "/reprocess" in html
    assert 'id="rp_normal_strength"' in html
    assert 'id="rp_shell_thickness"' in html


@pytest.mark.parametrize("subsample", [1, 2])
def test_reprocess_matches_jax_session(server, subsample):
    img, depth = _session_inputs()
    want_b64, want_n = jserve.ReprocessSession(img, depth, grid=32).reprocess(
        {"subsample": subsample})
    got = server.post_json("/reprocess", {"subsample": subsample})
    assert "error" not in got
    assert got["n"] == want_n > 0
    a = np.frombuffer(base64.b64decode(got["data_b64"]), "<f4").reshape(-1, F)
    b = np.frombuffer(base64.b64decode(want_b64), "<f4").reshape(-1, F)
    cols = np.r_[0:6, 10:15]
    np.testing.assert_allclose(a[:, cols], b[:, cols], rtol=0, atol=1e-5)
    np.testing.assert_allclose(a[:, 6:10], b[:, 6:10], rtol=0, atol=1e-6)


def test_reprocess_changes_cloud_and_count(server):
    base = server.post_json("/reprocess", {})
    changed = server.post_json(
        "/reprocess", {"normal_strength": 0.2, "shell_thickness": 0.9,
                       "shell_back_opacity": 0.1})
    n4 = server.post_json("/reprocess", {"subsample": 4})
    assert not any("error" in r for r in (base, changed, n4))
    assert changed["data_b64"] != base["data_b64"]
    assert n4["n"] < base["n"]


def test_reprocess_bad_params_reports_error(server):
    out = server.post_json("/reprocess", {"subsample": "not-a-number"})
    assert "error" in out


def test_render_png(server):
    assert "error" not in server.post_json("/reprocess", {})
    status, ctype, body = server.get(
        "/render?az=0.5&el=0.2&dist=2.5&size=64")
    assert status == 200 and ctype == "image/png"
    import io
    arr = np.asarray(Image.open(io.BytesIO(body)))
    assert arr.shape == (64, 64, 3) and arr.max() > 0


def test_export_ply_roundtrip(server, tmp_path):
    assert "error" not in server.post_json("/reprocess", {"subsample": 2})
    status, _, body = server.get("/export.ply")
    assert status == 200
    p = tmp_path / "cloud.ply"
    p.write_bytes(body)
    cloud = tio.load_ply(str(p))
    assert cloud.num_gaussians == 12 * 16 * 16
    assert torch.isfinite(cloud.to_flat()).all()
