"""Self-contained interactive HTML splat viewer with elliptical splats.

Counterpart of fresnel_tpu/viewer/html_viewer.py, with the same page byte
for byte: the full Gaussian parameterization (position, per-axis scale,
wxyz quaternion, colour, opacity, SAAG category) embedded as base64
float32; the client projects each Gaussian (Sigma3D = R S^2 R^T through
the view rotation and the perspective Jacobian to Sigma2D) and draws
oriented ellipses; a quality panel (size and opacity multipliers, a
preview cap, per-category toggles for the SAAG blocks) re-renders in the
page; dragging subsamples to a preview cap.  `pack_cloud` works in numpy
on the host: a cloud's tensors come over with `.cpu()`.

Run:  python -m fresnel_tpu_torch.viewer.html_viewer CLOUD.ply OUT.html
(or `python -m fresnel_tpu_torch.cli view CLOUD.ply OUT.html`; `cli infer
--saag --html OUT.html` exports with SAAG categories, so the toggles are
live).
"""

from __future__ import annotations

import argparse
import base64
from pathlib import Path

import numpy as np

CATEGORY_NAMES = ("base", "shell back", "walls", "wrap", "density")


def saag_categories(n_base: int, wrap_params, shell_params,
                    density_params) -> np.ndarray:
    """Per-Gaussian category ids for a to_surface_gaussians cloud.

    Mirrors the static block layout of geometry/saag.py
    to_surface_gaussians: [N base | N shell-back | N*segments walls |
    N*layers wrap | N*extra density], blocks present only when the stage
    is enabled.  0=base 1=shell-back 2=wall 3=wrap 4=density.
    """
    parts = [np.zeros(n_base, np.uint8)]
    if shell_params.enabled:
        parts.append(np.full(n_base, 1, np.uint8))
        if shell_params.connect_walls:
            parts.append(np.full(n_base * shell_params.wall_segments, 2,
                                 np.uint8))
    if wrap_params.enabled:
        parts.append(np.full(n_base * wrap_params.wrap_layers, 3, np.uint8))
    if density_params.enabled:
        parts.append(np.full(n_base * density_params.extra_count, 4,
                             np.uint8))
    return np.concatenate(parts)


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>fresnel-tpu viewer</title>
<style>
 body {{ margin:0; background:#111; color:#ccc; font-family:monospace; overflow:hidden; }}
 #hud {{ position:fixed; top:8px; left:8px; font-size:12px; user-select:none; }}
 #panel {{ position:fixed; top:8px; right:8px; width:230px; background:#1c1c1ccc;
          border:1px solid #333; padding:8px 10px; font-size:12px; user-select:none; }}
 #panel label {{ display:block; margin:4px 0 0; }}
 #panel input[type=range] {{ width:120px; vertical-align:middle; }}
 #panel .v {{ float:right; color:#8c8; }}
 canvas {{ display:block; }}
</style></head>
<body>
<div id="hud">fresnel-tpu &middot; {n} gaussians &middot; drag=orbit wheel=zoom shift-drag=pan<br>
<span id="fps"></span> <span id="drawn"></span></div>
<div id="panel">
 <b>quality</b>
 <label>size &times;<span class="v" id="sizeV">1.00</span>
  <input type="range" id="size" min="-1" max="0.699" step="0.01" value="0"></label>
 <label>opacity &times;<span class="v" id="opV">1.00</span>
  <input type="range" id="op" min="0.05" max="2" step="0.05" value="1"></label>
 <label>preview cap <span class="v" id="capV"></span>
  <input type="range" id="cap" min="500" max="{n}" step="500" value="{n}"></label>
 <div id="cats"></div>
{serve_panel}
</div>
<canvas id="c"></canvas>
<script>
const F = 15;  // x,y,z, sx,sy,sz, qw,qx,qy,qz, r,g,b, op, cat
const HAS_CATS = {has_cats};
let N = 0, g, M, colPre, cat, priority, DL, dlOrder;
let sizeMul = 1.0, opMul = 1.0, cap = 0;

// Precompute M = R * diag(scale) per Gaussian (row-major 3x3) and color
// strings; priority order = opacity-descending (what the cap keeps).
// A function so a reprocess server can hot-swap the cloud (loadCloud is
// re-entered with the new payload — the HTML analogue of the reference
// viewer's load_gaussians after reprocess_image, viewer.cpp:300-452).
function loadCloud(dataB64, n) {{
  N = n;
  const raw = Uint8Array.from(atob(dataB64), ch => ch.charCodeAt(0));
  g = new Float32Array(raw.buffer);
  M = new Float32Array(9 * N);
  colPre = new Array(N);
  cat = new Uint8Array(N);
  for (let i = 0; i < N; i++) {{
    const o = i * F;
    const sx = g[o+3], sy = g[o+4], sz = g[o+5];
    const w = g[o+6], x = g[o+7], y = g[o+8], z = g[o+9];
    const R = [1-2*(y*y+z*z), 2*(x*y-w*z), 2*(x*z+w*y),
               2*(x*y+w*z), 1-2*(x*x+z*z), 2*(y*z-w*x),
               2*(x*z-w*y), 2*(y*z+w*x), 1-2*(x*x+y*y)];
    const m = i * 9;
    M[m+0]=R[0]*sx; M[m+1]=R[1]*sy; M[m+2]=R[2]*sz;
    M[m+3]=R[3]*sx; M[m+4]=R[4]*sy; M[m+5]=R[5]*sz;
    M[m+6]=R[6]*sx; M[m+7]=R[7]*sy; M[m+8]=R[8]*sz;
    colPre[i] = `rgba(${{g[o+10]*255|0}},${{g[o+11]*255|0}},${{g[o+12]*255|0}},`;
    cat[i] = g[o+14];
  }}
  priority = Array.from({{length: N}}, (_, i) => i)
    .sort((a, b) => g[b*F+13] - g[a*F+13]);
  DL = new Float32Array(8 * N);       // drawlist (8 slots per splat)
  dlOrder = new Int32Array(N);
  const capEl = document.getElementById('cap');
  if (capEl) {{
    capEl.max = N;
    if (+capEl.value > N || +capEl.value === +capEl.getAttribute('data-n'))
      capEl.value = N;
    capEl.setAttribute('data-n', N);
    cap = Math.min(+capEl.value, N);
    document.getElementById('capV').textContent = cap;
  }}
  const hud = document.querySelector('#hud');
  if (hud) hud.childNodes[0].textContent =
    `fresnel-tpu · ${{N}} gaussians · drag=orbit wheel=zoom shift-drag=pan`;
}}
loadCloud("{data_b64}", {n});

const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let W, H;
function resize() {{ W = canvas.width = innerWidth; H = canvas.height = innerHeight; }}
resize(); addEventListener('resize', resize);

// ---- quality panel ----------------------------------------------------
const catOn = [true, true, true, true, true];
const CAT_NAMES = {cat_names};
const $ = id => document.getElementById(id);
$('size').oninput = e => {{
  sizeMul = Math.pow(10, +e.target.value);
  $('sizeV').textContent = sizeMul.toFixed(2); }};
$('op').oninput = e => {{
  opMul = +e.target.value; $('opV').textContent = opMul.toFixed(2); }};
$('cap').oninput = e => {{
  cap = +e.target.value; $('capV').textContent = cap; }};
$('capV').textContent = N;
if (HAS_CATS) {{
  const box = $('cats');
  for (let c = 0; c < CAT_NAMES.length; c++) {{
    const lab = document.createElement('label');
    const cb = document.createElement('input');
    cb.type = 'checkbox'; cb.checked = true;
    cb.onchange = () => catOn[c] = cb.checked;
    lab.appendChild(cb);
    lab.appendChild(document.createTextNode(' ' + CAT_NAMES[c]));
    box.appendChild(lab);
  }}
}}

// ---- camera -----------------------------------------------------------
let az = 0.0, el = 0.0, dist = {distance}, panX = 0, panY = 0;
let dragging = false, panning = false, lx = 0, ly = 0;
const DRAG_CAP = 8000;   // preview subsample while interacting
canvas.addEventListener('mousedown', e => {{
  dragging = true; panning = e.shiftKey; lx = e.clientX; ly = e.clientY; }});
addEventListener('mouseup', () => dragging = false);
addEventListener('mousemove', e => {{
  if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  if (panning) {{ panX += dx * 0.002 * dist; panY -= dy * 0.002 * dist; }}
  else {{ az += dx * 0.01; el = Math.max(-1.5, Math.min(1.5, el + dy * 0.01)); }}
  lx = e.clientX; ly = e.clientY;
}});
canvas.addEventListener('wheel', e => {{
  dist *= Math.exp(e.deltaY * 0.001); e.preventDefault(); }}, {{passive: false}});

let frames = 0, t0 = performance.now();

function draw() {{
  const ce = Math.cos(el), se = Math.sin(el);
  const ca = Math.cos(az), sa = Math.sin(az);
  const cx = dist * ce * sa, cy = dist * se, cz = dist * ce * ca;
  const fl = Math.hypot(cx, cy, cz);
  const fx = -cx/fl, fy = -cy/fl, fz = -cz/fl;      // forward
  // right = normalize(cross(forward, worldUp)) — matches
  // core/camera.py:look_at_view so screen orientation agrees with renders.
  let rx = -fz, ry = 0, rz = fx;
  const rl = Math.hypot(rx, ry, rz) || 1;
  rx/=rl; ry/=rl; rz/=rl;
  const ux = ry*fz - rz*fy, uy = rz*fx - rx*fz, uz = rx*fy - ry*fx;  // up
  const focal = Math.min(W, H) * 0.8;
  const capNow = dragging ? Math.min(cap, DRAG_CAP) : cap;

  let nd = 0;
  for (let k = 0; k < N && nd < capNow; k++) {{
    const i = priority[k];
    if (HAS_CATS && !catOn[cat[i]]) continue;
    const o = i * F;
    const px = g[o] - cx, py = g[o+1] - cy, pz = g[o+2] - cz;
    const d = px*fx + py*fy + pz*fz;
    if (d <= 0.05) continue;
    const vx = px*rx + py*ry + pz*rz;
    const vy = px*ux + py*uy + pz*uz;
    const sx = focal * vx / d + W/2 + panX * focal / dist;
    const sy = -focal * vy / d + H/2 + panY * focal / dist;
    if (sx < -200 || sx > W+200 || sy < -200 || sy > H+200) continue;

    // B = J * [r;u;f] * M * sizeMul, Sigma2D = B Bᵀ (+0.3 px²) — the same
    // EWA chain as render/projection.py, done per frame client-side.
    // NOTE the second row keeps the renderer's J[1,2] SIGN QUIRK
    // (reference parity: differentiable_renderer.py:146 has dv/dz =
    // +fy*y/z² where true geometry needs −fy*y/z²; render/projection.py
    // preserves it, so the viewer must too or anisotropic splats would
    // appear mirrored vs renders): the vy*j2 term is NEGATED relative to
    // the true Jacobian.
    const m = i * 9;
    const a0 = rx*M[m]+ry*M[m+3]+rz*M[m+6], a1 = rx*M[m+1]+ry*M[m+4]+rz*M[m+7],
          a2 = rx*M[m+2]+ry*M[m+5]+rz*M[m+8];
    const b0 = ux*M[m]+uy*M[m+3]+uz*M[m+6], b1 = ux*M[m+1]+uy*M[m+4]+uz*M[m+7],
          b2 = ux*M[m+2]+uy*M[m+5]+uz*M[m+8];
    const c0 = fx*M[m]+fy*M[m+3]+fz*M[m+6], c1 = fx*M[m+1]+fy*M[m+4]+fz*M[m+7],
          c2 = fx*M[m+2]+fy*M[m+5]+fz*M[m+8];
    const j0 = focal / d, j2 = focal / (d * d);
    const B00 = (a0*j0 - vx*j2*c0)*sizeMul, B01 = (a1*j0 - vx*j2*c1)*sizeMul,
          B02 = (a2*j0 - vx*j2*c2)*sizeMul;
    const B10 = (-b0*j0 - vy*j2*c0)*sizeMul, B11 = (-b1*j0 - vy*j2*c1)*sizeMul,
          B12 = (-b2*j0 - vy*j2*c2)*sizeMul;
    const S00 = B00*B00 + B01*B01 + B02*B02 + 0.3;
    const S01 = B00*B10 + B01*B11 + B02*B12;
    const S11 = B10*B10 + B11*B11 + B12*B12 + 0.3;
    const mm = (S00 + S11) / 2;
    const disc = Math.sqrt(Math.max(0, (S00 - S11)*(S00 - S11)/4 + S01*S01));
    const r1 = 2 * Math.sqrt(Math.max(1e-6, mm + disc));
    const r2 = 2 * Math.sqrt(Math.max(1e-6, mm - disc));
    if (r1 < 0.25) continue;
    const ang = 0.5 * Math.atan2(2 * S01, S00 - S11);
    const al = Math.min(1, g[o+13] * opMul);
    if (al < 0.004) continue;

    const s = nd * 8;
    DL[s]=i; DL[s+1]=d; DL[s+2]=sx; DL[s+3]=sy; DL[s+4]=r1; DL[s+5]=r2;
    DL[s+6]=ang; DL[s+7]=al;
    dlOrder[nd] = nd;
    nd++;
  }}
  // back-to-front painter's sort of the visible subset
  const sub = dlOrder.subarray(0, nd);
  sub.sort((a, b) => DL[b*8+1] - DL[a*8+1]);

  ctx.fillStyle = '#000'; ctx.fillRect(0, 0, W, H);
  for (let k = 0; k < nd; k++) {{
    const s = sub[k] * 8;
    ctx.fillStyle = colPre[DL[s]|0] + DL[s+7].toFixed(3) + ')';
    ctx.beginPath();
    ctx.ellipse(DL[s+2], DL[s+3], DL[s+4], DL[s+5], DL[s+6], 0, 6.2832);
    ctx.fill();
  }}
  frames++;
  const now = performance.now();
  if (now - t0 > 500) {{
    $('fps').textContent = (frames * 1000 / (now - t0)).toFixed(1) + ' fps';
    $('drawn').innerHTML = '&middot; ' + nd + ' drawn';
    frames = 0; t0 = now;
  }}
  requestAnimationFrame(draw);
}}
draw();
{serve_js}
</script></body></html>
"""


def _host(x) -> np.ndarray:
    """A tensor or array as a float32 numpy array on the host."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def pack_cloud(cloud, categories: "np.ndarray | None" = None,
               max_gaussians: int = 30000) -> "tuple[str, int]":
    """GaussianCloud -> (base64 of the 15-float packed payload, count).

    Drops masked (opacity <= 1e-3) splats and caps at max_gaussians,
    keeping the highest-opacity ones by numpy's `argsort(-op)` on the
    host, as the JAX package does, so equal clouds give equal bytes.
    Shared by the static export and the reprocess server's /reprocess
    response.
    """
    pos = _host(cloud.positions)
    scales = _host(cloud.scales)
    quats = _host(cloud.rotations)
    col = _host(cloud.colors)
    op = _host(cloud.opacities)
    cats = (np.asarray(categories, np.uint8) if categories is not None
            else np.zeros(len(op), np.uint8))
    if len(cats) != len(op):
        raise ValueError(
            f"categories length {len(cats)} != cloud size {len(op)}")

    live = op > 1e-3
    pos, scales, quats = pos[live], scales[live], quats[live]
    col, op, cats = col[live], op[live], cats[live]
    if len(op) > max_gaussians:
        idx = np.argsort(-op)[:max_gaussians]
        pos, scales, quats = pos[idx], scales[idx], quats[idx]
        col, op, cats = col[idx], op[idx], cats[idx]

    packed = np.concatenate(
        [pos, scales, quats, np.clip(col, 0, 1), op[:, None],
         cats[:, None].astype(np.float32)], -1).astype("<f4")
    return base64.b64encode(packed.tobytes()).decode(), len(op)


def build_html(cloud, max_gaussians: int = 30000, distance: float = 2.0,
               categories: "np.ndarray | None" = None,
               serve_panel: str = "", serve_js: str = "") -> "tuple[str, int]":
    """Render the viewer HTML for a cloud; returns (html, gaussian count).

    serve_panel / serve_js inject the reprocess-server controls
    (viewer/serve.py) — empty for the self-contained static export.
    """
    data_b64, n = pack_cloud(cloud, categories, max_gaussians)
    has_cats = "true" if categories is not None else "false"
    cat_names = "[" + ",".join(f'"{nm}"' for nm in CATEGORY_NAMES) + "]"
    html = _TEMPLATE.format(n=n, data_b64=data_b64, distance=distance,
                            has_cats=has_cats, cat_names=cat_names,
                            serve_panel=serve_panel, serve_js=serve_js)
    return html, n


def export_html(cloud, out_path: str, max_gaussians: int = 30000,
                distance: float = 2.0,
                categories: "np.ndarray | None" = None) -> int:
    """GaussianCloud -> self-contained HTML viewer with oriented ellipses.

    Ships the full (scale3, quat4) parameterization so the client can do
    real EWA projection.  `categories` (uint8 per Gaussian, see
    saag_categories) enables the per-stage toggles in the panel.
    """
    html, n = build_html(cloud, max_gaussians, distance, categories)
    Path(out_path).write_text(html)
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="Export HTML splat viewer")
    p.add_argument("cloud", help=".ply or .bin")
    p.add_argument("output", help="output .html")
    p.add_argument("--max_gaussians", type=int, default=30000)
    p.add_argument("--distance", type=float, default=2.0)
    args = p.parse_args(argv)

    from fresnel_tpu_torch.core import io as gio

    cloud = (gio.load_ply(args.cloud) if args.cloud.endswith(".ply")
             else gio.load_binary(args.cloud))
    n = export_html(cloud, args.output, args.max_gaussians, args.distance)
    print(f"viewer with {n} gaussians -> {args.output}")


if __name__ == "__main__":
    main()
