"""Self-contained interactive HTML viewer for trajectories + maps.

Host copy of orbslam3_tpu/viz/html_view.py: one HTML file with the map and
trajectory embedded as JSON and a small dependency-free canvas renderer
(orbit / zoom / pan, point size by depth, estimate against ground truth).
Open it in any browser. `snapshot_data` takes the port's MapState: its
tensors come to the host once each.

Usage:
    from orbslam3_tpu_torch.viz.html_view import save_html_view
    save_html_view("out.html", map_state=slam.map, traj=ps, gt=gt_p)
"""
from __future__ import annotations

import json

import numpy as np
import torch

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>orbslam3_tpu map</title><style>
 body {{ margin:0; background:#101014; color:#ccc; font:12px sans-serif; }}
 #hud {{ position:fixed; top:8px; left:10px; user-select:none; }}
 canvas {{ display:block; }}
 .sw {{ display:inline-block; width:10px; height:10px; margin-right:4px; }}
</style></head><body>
<div id="hud">
 <b>orbslam3_tpu</b> — drag: orbit · wheel: zoom · shift-drag: pan<br>
 <span class="sw" style="background:#4da3ff"></span>estimate
 <span class="sw" style="background:#ffb84d"></span>ground truth
 <span class="sw" style="background:#9aa0a6"></span>map points
 <span class="sw" style="background:#ff5d5d"></span>keyframes
 <span id="stats"></span>
</div>
<canvas id="c"></canvas>
<script>
const DATA = {data_json};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function resize() {{ W = cv.width = innerWidth; H = cv.height = innerHeight; }}
resize(); addEventListener('resize', () => {{ resize(); draw(); }});
// center/scale the scene
let c = [0,0,0], r = 1e-6;
let yaw = 0.7, pitch = 0.5, dist = 1, panX = 0, panY = 0;
function recenter() {{
  const all = DATA.points.concat(DATA.traj, DATA.gt, DATA.kf);
  c = [0,0,0];
  for (const p of all) {{ c[0]+=p[0]; c[1]+=p[1]; c[2]+=p[2]; }}
  c = c.map(v => v / Math.max(all.length,1));
  r = 1e-6;
  for (const p of all) r = Math.max(r, Math.hypot(p[0]-c[0], p[1]-c[1], p[2]-c[2]));
  dist = 2.6*r;
}}
recenter();
function proj(p) {{
  const x = p[0]-c[0], y = p[1]-c[1], z = p[2]-c[2];
  const cy_ = Math.cos(yaw), sy = Math.sin(yaw), cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x1 = cy_*x + sy*y, y1 = -sy*x + cy_*y;       // yaw about +z
  const y2 = cp*y1 - sp*z, z2 = sp*y1 + cp*z;       // pitch
  const zc = dist - x1;                              // camera looks along -x1
  if (zc <= 0.05*r) return null;
  const f = 0.9 * Math.min(W, H) / (zc / r);
  return [W/2 + f*(y2/r) + panX, H/2 - f*(z2/r) + panY, zc];
}}
function polyline(pts, color, width) {{
  ctx.strokeStyle = color; ctx.lineWidth = width; ctx.beginPath();
  let started = false;
  for (const p of pts) {{
    const s = proj(p); if (!s) {{ started = false; continue; }}
    if (!started) {{ ctx.moveTo(s[0], s[1]); started = true; }}
    else ctx.lineTo(s[0], s[1]);
  }}
  ctx.stroke();
}}
function draw() {{
  ctx.fillStyle = '#101014'; ctx.fillRect(0,0,W,H);
  ctx.fillStyle = '#9aa0a6';
  for (const p of DATA.points) {{
    const s = proj(p); if (!s) continue;
    const sz = Math.max(0.7, 2.2*r/s[2]);
    ctx.globalAlpha = Math.min(1, 1.6*r/s[2]);
    ctx.fillRect(s[0], s[1], sz, sz);
  }}
  ctx.globalAlpha = 1;
  if (DATA.gt.length) polyline(DATA.gt, '#ffb84d', 1.5);
  if (DATA.traj.length) polyline(DATA.traj, '#4da3ff', 2);
  ctx.fillStyle = '#ff5d5d';
  for (const p of DATA.kf) {{
    const s = proj(p); if (!s) continue;
    ctx.fillRect(s[0]-2, s[1]-2, 4, 4);
  }}
  document.getElementById('stats').textContent =
    ` · ${{DATA.points.length}} pts · ${{DATA.kf.length}} KFs · ${{DATA.traj.length}} poses`;
}}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmouseup = () => drag = null;
onmousemove = e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ panX += dx; panY += dy; }}
  else {{ yaw += dx*0.008; pitch = Math.max(-1.5, Math.min(1.5, pitch + dy*0.008)); }}
  drag = [e.clientX, e.clientY, drag[2]]; draw();
}};
cv.onwheel = e => {{ dist *= Math.exp(e.deltaY * 0.001); draw(); e.preventDefault(); }};
draw();
{live_js}</script></body></html>
"""

# polling loop appended in live mode (viz/live.py): refresh DATA from the
# server; auto-recenter only until the user takes over the camera
_LIVE_JS = """
let userView = false;
cv.addEventListener('mousedown', () => userView = true);
cv.addEventListener('wheel', () => userView = true);
async function pollState() {
  try {
    const resp = await fetch('/state.json', {cache: 'no-store'});
    if (resp.ok) {
      const d = await resp.json();
      DATA.points = d.points; DATA.kf = d.kf;
      DATA.traj = d.traj; DATA.gt = d.gt;
      if (!userView) recenter();
      draw();
    }
  } catch (e) {}
  setTimeout(pollState, POLL_MS);
}
pollState();
"""


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def snapshot_data(map_state=None, traj=None, gt=None,
                  max_points: int = 20000) -> dict:
    """Host-side scene snapshot (one device read per array: callers
    throttle): valid map points (subsampled), keyframe positions, and the
    estimated / ground-truth trajectories, all as plain lists."""
    pts = np.zeros((0, 3), np.float32)
    kfs = np.zeros((0, 3), np.float32)
    if map_state is not None:
        valid = _host(map_state.mp_valid)
        pts = _host(map_state.mp_pos)[valid]
        if len(pts) > max_points:
            sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
            pts = pts[sel]
        kfs = _host(map_state.kf_p)[_host(map_state.kf_valid)]
    return dict(
        points=np.round(pts, 4).tolist(),
        kf=np.round(kfs, 4).tolist(),
        traj=np.round(_host(traj), 4).tolist() if traj is not None else [],
        gt=np.round(_host(gt), 4).tolist() if gt is not None else [],
    )


def render_page(data: dict, poll_ms: int | None = None) -> str:
    """The viewer page: self-contained when poll_ms is None, otherwise a
    live page that refreshes DATA from /state.json every poll_ms."""
    live = ""
    if poll_ms is not None:
        live = f"const POLL_MS = {int(poll_ms)};" + _LIVE_JS
    return _TEMPLATE.format(data_json=json.dumps(data), live_js=live)


def save_html_view(path: str, map_state=None, traj=None, gt=None,
                   max_points: int = 20000):
    """Write a standalone HTML viewer.

    Args:
      map_state: the port's MapState (valid map points + keyframe positions plotted)
      traj: (T, 3) estimated positions
      gt: (T, 3) ground-truth positions (optional)
    """
    data = snapshot_data(map_state, traj, gt, max_points)
    with open(path, "w") as f:
        f.write(render_page(data))
    return path
