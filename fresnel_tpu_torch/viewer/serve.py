"""Local reprocess server: the HTML viewer's live SAAG loop.

Counterpart of fresnel_tpu/viewer/serve.py.  Change a quality-panel
parameter in the page and the Gaussian cloud is regenerated from the
loaded image and depth on the server, without leaving the viewer:

  * ``GET /``           the viewer page with an extra "reprocess" panel;
  * ``POST /reprocess`` JSON params -> SAAG run again (or the learned
                        decoder, when one is loaded and enabled) -> the
                        new packed cloud, swapped into the page by
                        loadCloud();
  * ``GET /render``     the current cloud rendered by the tiled renderer
                        at the page's orbit camera -> PNG;
  * ``GET /export.ply`` the current cloud as a binary PLY.

``ThreadingHTTPServer`` answers each request on its own thread: the
session's work runs on the session's device under the session's lock, so
the card sees one request at a time.  A failed ``/render`` answers 500
with the error's text, a failed ``/reprocess`` a JSON ``{"error": ...}``,
as the JAX package's server does.  The session runs on the card unless
``device="cpu"`` is given.

Run:  python -m fresnel_tpu_torch.cli view --serve image.png
      python -m fresnel_tpu_torch.viewer.serve image.png --port 8008
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Callable, Optional, Union
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from fresnel_tpu_torch.core import io as gio
from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.device import resolve_device
from fresnel_tpu_torch.geometry import (
    AdaptiveDensityParams, SilhouetteWrapParams, SurfaceGaussianParams,
    VolumetricShellParams, pointcloud_from_depth, to_surface_gaussians)
from fresnel_tpu_torch.models.encoders import (
    create_depth_estimator, resize_linear)
from fresnel_tpu_torch.render.tile import TileRendererConfig, render_tiled
from fresnel_tpu_torch.viewer.html_viewer import (
    build_html, pack_cloud, saag_categories)

# The parameter dataclasses' defaults (geometry/saag.py) plus the
# viewer-level knobs: depth curve, depth scale, subsample, opacity.
DEFAULT_PARAMS = {
    "base_size": 0.008,
    "aspect_ratio": 5.0,
    "edge_threshold": 0.15,
    "edge_shrink": 0.3,
    "gradient_scale": 50.0,
    "normal_strength": 1.0,
    "opacity": 0.8,
    "depth_exponent": 1.0,
    "depth_scale": 1.0,
    "subsample": 2,
    "use_learned_decoder": False,
    "wrap": True,
    "wrap_layers": 3,
    "wrap_spacing": 0.5,
    "wrap_opacity_falloff": 0.7,
    "shell": True,
    "shell_thickness": 0.3,
    "shell_back_opacity": 0.6,
    "shell_walls": True,
    "shell_wall_segments": 3,
    "density": True,
    "density_extra": 4,
    "density_jitter": 0.6,
}


class ReprocessSession:
    """Server-side state: the loaded image and depth, resized to `grid`^2
    on `device` (CUDA by default), and the current cloud.

    ``decode_fn`` (optional): a callable ``(image, depth) -> GaussianCloud``
    wrapping a trained decoder; when it is set and the client enables
    "learned decoder", reprocess uses it instead of SAAG.
    """

    def __init__(self, image: np.ndarray, depth: np.ndarray,
                 grid: int = 256, decode_fn: Optional[Callable] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.grid = int(grid)
        self.decode_fn = decode_fn
        img = torch.as_tensor(np.asarray(image, np.float32),
                              device=self.device)
        self.image = resize_linear(img.permute(2, 0, 1), self.grid,
                                   self.grid).permute(1, 2, 0)
        self.depth_raw = resize_linear(
            torch.as_tensor(np.asarray(depth, np.float32),
                            device=self.device), self.grid, self.grid)
        self.lock = threading.RLock()
        self.cloud = None
        self.categories = None
        self.reprocess(dict(DEFAULT_PARAMS))

    def _on_device(self):
        """The session's lock, and its card as the current device."""
        stack = contextlib.ExitStack()
        stack.enter_context(self.lock)
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.no_grad())
        return stack

    # -- reprocess: SAAG again with new parameters ------------------------
    def reprocess(self, params: dict) -> "tuple[str, int]":
        p = dict(DEFAULT_PARAMS)
        p.update({k: v for k, v in params.items() if k in DEFAULT_PARAMS})

        with self._on_device():
            if p["use_learned_decoder"] and self.decode_fn is not None:
                cloud = self.decode_fn(self.image, self.depth_raw)
                self.cloud, self.categories = cloud, None
                return pack_cloud(cloud, None, max_gaussians=100000)

            # The depth curve before unprojection.
            depth = self.depth_raw
            if p["depth_exponent"] != 1.0:
                depth = torch.pow(torch.clamp(depth, 0.0, 1.0),
                                  float(p["depth_exponent"]))

            sp = SurfaceGaussianParams(
                base_size=float(p["base_size"]),
                aspect_ratio=float(p["aspect_ratio"]),
                edge_threshold=float(p["edge_threshold"]),
                edge_shrink=float(p["edge_shrink"]),
                gradient_scale=float(p["gradient_scale"]),
                normal_strength=float(p["normal_strength"]))
            wp = SilhouetteWrapParams(
                enabled=bool(p["wrap"]), wrap_layers=int(p["wrap_layers"]),
                layer_spacing=float(p["wrap_spacing"]),
                opacity_falloff=float(p["wrap_opacity_falloff"]))
            shp = VolumetricShellParams(
                enabled=bool(p["shell"]),
                thickness=float(p["shell_thickness"]),
                back_opacity=float(p["shell_back_opacity"]),
                connect_walls=bool(p["shell_walls"]),
                wall_segments=int(p["shell_wall_segments"]))
            dp = AdaptiveDensityParams(
                enabled=bool(p["density"]),
                extra_count=int(p["density_extra"]),
                position_jitter=float(p["density_jitter"]))

            sub = max(1, int(p["subsample"]))
            pc = pointcloud_from_depth(
                depth, color=self.image, depth_scale=float(p["depth_scale"]),
                subsample=sub).normalize(3.0)
            cloud = to_surface_gaussians(
                pc, depth, params=sp, wrap_params=wp, shell_params=shp,
                density_params=dp, opacity=float(p["opacity"]))
            cats = saag_categories(pc.num_points, wp, shp, dp)
            self.cloud, self.categories = cloud, cats
            return pack_cloud(cloud, cats, max_gaussians=100000)

    # -- render: the current cloud to a PNG -------------------------------
    def render_png(self, azimuth_rad: float, elevation_rad: float,
                   distance: float, size: int = 1024) -> bytes:
        """The current cloud (masked entries included, at opacity 0) from
        the orbit pose, `size` clipped to [64, 2048], max_per_tile 512."""
        from PIL import Image

        size = int(np.clip(size, 64, 2048))
        with self._on_device():
            cloud = self.cloud
            cam = Camera.from_pose(float(elevation_rad), float(azimuth_rad),
                                   size, distance=float(distance)).to(
                                       self.device)
            # A standalone render's cap: no gradients, a SAAG-sized cloud.
            cfg = TileRendererConfig(max_per_tile=512)
            img = render_tiled(cloud.positions, cloud.scales,
                               cloud.rotations, cloud.colors,
                               cloud.opacities, cam, config=cfg)
            arr = (img.permute(1, 2, 0) * 255).cpu().numpy().astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()

    def export_ply(self) -> bytes:
        with self.lock:
            cloud = self.cloud
        with tempfile.TemporaryDirectory() as td:
            path = Path(td) / "cloud.ply"
            gio.save_ply(path, cloud)
            return path.read_bytes()


# ---------------------------------------------------------------------------
# The panel and JS put into the viewer page (html_viewer._TEMPLATE's
# hooks).  Plain strings, not run through str.format: single braces are
# safe.
# ---------------------------------------------------------------------------

_NUM_FIELDS = [
    # (id, label, step)
    ("base_size", "base size", 0.001),
    ("aspect_ratio", "aspect", 0.5),
    ("edge_threshold", "edge thr", 0.01),
    ("edge_shrink", "edge shrink", 0.05),
    ("normal_strength", "normal str", 0.05),
    ("gradient_scale", "grad scale", 1.0),
    ("opacity", "opacity", 0.05),
    ("depth_exponent", "depth exp", 0.05),
    ("depth_scale", "depth scale", 0.1),
    ("subsample", "subsample", 1),
    ("wrap_layers", "wrap layers", 1),
    ("wrap_spacing", "wrap spacing", 0.05),
    ("shell_thickness", "shell thick", 0.05),
    ("shell_back_opacity", "back opacity", 0.05),
    ("shell_wall_segments", "wall segs", 1),
    ("density_extra", "density extra", 1),
]
_BOOL_FIELDS = [("wrap", "silhouette wrap"), ("shell", "volumetric shell"),
                ("shell_walls", "shell walls"), ("density", "adaptive density"),
                ("use_learned_decoder", "learned decoder")]


def _serve_panel() -> str:
    rows = []
    for fid, label, step in _NUM_FIELDS:
        rows.append(
            f'<label>{label}<input type="number" id="rp_{fid}" step="{step}"'
            f' value="{DEFAULT_PARAMS[fid]}" style="width:64px;float:right">'
            f'</label>')
    for fid, label in _BOOL_FIELDS:
        chk = "checked" if DEFAULT_PARAMS[fid] else ""
        rows.append(f'<label><input type="checkbox" id="rp_{fid}" {chk}> '
                    f'{label}</label>')
    return (
        '<hr style="border-color:#333"><b>reprocess</b>\n'
        + "\n".join(rows)
        + '\n<button id="rp_apply" style="margin-top:6px">apply</button>'
          ' <button id="rp_png">export PNG</button>'
          ' <button id="rp_ply">export PLY</button>'
          '<div id="rp_status" style="color:#8c8;margin-top:4px"></div>')


_SERVE_JS = """
// ---- reprocess bridge (server mode) ------------------------------------
const RP_NUM = %s;
const RP_BOOL = %s;
function rpStatus(msg) { document.getElementById('rp_status').textContent = msg; }
async function rpApply() {
  const body = {};
  for (const f of RP_NUM) body[f] = +document.getElementById('rp_' + f).value;
  for (const f of RP_BOOL) body[f] = document.getElementById('rp_' + f).checked;
  rpStatus('reprocessing…');
  const t0 = performance.now();
  try {
    const r = await fetch('/reprocess', {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify(body)});
    const j = await r.json();
    if (j.error) { rpStatus('error: ' + j.error); return; }
    loadCloud(j.data_b64, j.n);
    rpStatus(j.n + ' gaussians (' + (performance.now() - t0).toFixed(0) + ' ms)');
  } catch (e) { rpStatus('error: ' + e); }
}
document.getElementById('rp_apply').onclick = rpApply;
document.getElementById('rp_png').onclick = () => {
  rpStatus('rendering…');
  const u = `/render?az=${az}&el=${el}&dist=${dist}&size=1024`;
  const a = document.createElement('a');
  a.href = u; a.download = 'render.png'; a.click();
  rpStatus('');
};
document.getElementById('rp_ply').onclick = () => {
  const a = document.createElement('a');
  a.href = '/export.ply'; a.download = 'cloud.ply'; a.click();
};
"""


def _serve_js() -> str:
    return _SERVE_JS % (
        json.dumps([f for f, _, _ in _NUM_FIELDS]),
        json.dumps([f for f, _ in _BOOL_FIELDS]))


def make_server(session: ReprocessSession, port: int = 0,
                max_gaussians: int = 100000) -> ThreadingHTTPServer:
    """Build (do not start) the HTTP server on 127.0.0.1; port 0 picks a
    free port."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                with session.lock:
                    cloud, cats = session.cloud, session.categories
                    html, _ = build_html(
                        cloud, max_gaussians=max_gaussians, categories=cats,
                        serve_panel=_serve_panel(), serve_js=_serve_js())
                self._send(200, "text/html; charset=utf-8", html.encode())
            elif url.path == "/render":
                q = parse_qs(url.query)

                def f(key, default):
                    return float(q.get(key, [default])[0])

                try:
                    png = session.render_png(
                        azimuth_rad=f("az", 0.0), elevation_rad=f("el", 0.0),
                        distance=f("dist", 2.0), size=int(f("size", 1024)))
                    self._send(200, "image/png", png)
                except Exception as e:  # an answer beats a hung page
                    self._send(500, "text/plain", str(e).encode())
            elif url.path == "/export.ply":
                self._send(200, "application/octet-stream",
                           session.export_ply())
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if urlparse(self.path).path != "/reprocess":
                self._send(404, "text/plain", b"not found")
                return
            n_bytes = int(self.headers.get("Content-Length", 0))
            try:
                params = json.loads(self.rfile.read(n_bytes) or b"{}")
                t0 = time.perf_counter()
                b64, n = session.reprocess(params)
                body = json.dumps(
                    {"n": n, "data_b64": b64,
                     "ms": (time.perf_counter() - t0) * 1000})
                self._send(200, "application/json", body.encode())
            except Exception as e:
                self._send(200, "application/json",
                           json.dumps({"error": str(e)}).encode())

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def load_session(image_path: str, grid: int = 256,
                 depth_estimator: str = "auto",
                 decode_fn: Optional[Callable] = None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> ReprocessSession:
    """An image file, its depth from `depth_estimator` at `grid`^2, and
    the session over them on `device` (CUDA by default)."""
    from PIL import Image

    dev = resolve_device(device)
    img = np.asarray(Image.open(image_path).convert("RGB"),
                     np.float32) / 255.0
    # Loaded once per session: found Depth-Anything weights are ~100 MB.
    estimator = create_depth_estimator(depth_estimator, device=dev)
    print(f"depth estimator: {estimator.kind}"
          + (f" ({estimator.weights_path})" if estimator.weights_path
             else ""))
    with torch.no_grad():
        depth = estimator(torch.as_tensor(img, device=dev), grid)
    return ReprocessSession(img, depth.cpu().numpy(), grid=grid,
                            decode_fn=decode_fn, device=dev)


def serve_image(image_path: str, port: int = 8008, grid: int = 256,
                depth_estimator: str = "auto",
                decode_fn: Optional[Callable] = None,
                device: Optional[Union[str, torch.device]] = None) -> None:
    """Load an image, estimate its depth, and serve the live viewer
    (blocking, until interrupted)."""
    session = load_session(image_path, grid, depth_estimator, decode_fn,
                           device)
    httpd = make_server(session, port=port)
    host, actual_port = httpd.server_address[:2]
    print(f"live viewer at http://{host}:{actual_port}/  (ctrl-c to stop)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def main(argv=None):
    p = argparse.ArgumentParser(description="Live reprocess viewer server")
    p.add_argument("image", help="input image (png/jpg)")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--grid", type=int, default=256)
    p.add_argument("--depth_estimator", default="auto")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    serve_image(args.image, port=args.port, grid=args.grid,
                depth_estimator=args.depth_estimator, device=args.device)


if __name__ == "__main__":
    main()
