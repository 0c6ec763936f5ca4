"""Browser-based interactive viewer (counterpart of
gaussian_ray_tracing_tpu/viewer.py).

The stand-in for the reference's GLFW/ImGui window (src/gui.{h,cpp}):
interaction runs over HTTP, a self-contained HTML page (no external
assets) with mouse-drag orbit, wheel zoom, WASD and right-drag pan
(gui.cpp:136-256), the fisheye toggle (gui.cpp:188-191), render-type
selection, primitive insertion, OBJ upload, per-primitive translate /
rotate / scale editing and removal (gui.cpp:319-438 ->
GaussianTracer.cpp:711-736, driving update_instance_transform and
remove_primitive), fetching freshly rendered PNG frames from a
GaussianRayTracer.

Stdlib HTTP (ThreadingHTTPServer); one lock serialises every request that
touches the tracer. Frames render on the scene's device: with a mesh
type chosen and primitives inserted, through the mesh tracer
(GaussianRayTracer.render_rgb8), else through render(method="auto"). A
handler thread selects the scene's CUDA device itself (the current device
is per thread), and `serve` renders one frame before it answers, so no
request waits on the kernels' build.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>gaussian-ray-tracing-tpu</title><style>
body { margin:0; background:#111; color:#ddd; font:13px monospace; }
#bar, #edit { padding:6px 10px; } img { display:block; margin:auto; cursor:grab; }
button, select, input { background:#222; color:#ddd; border:1px solid #444; margin-right:4px; }
</style></head><body>
<div id="bar">
 <button onclick="toggle('fisheye')">fisheye</button>
 <select id="mtype" onchange="refresh()">
   <option value="">no mesh</option><option value="mirror">mirror</option>
   <option value="glass">glass</option><option value="normal">normal</option>
 </select>
 <button onclick="addPrim('plane')">+plane</button>
 <button onclick="addPrim('sphere')">+sphere</button>
 <input type="file" id="objfile" accept=".obj" style="width:170px"
        onchange="uploadObj(this)"/>
 <button onclick="clearPrims()">clear</button>
 <span id="stat"></span>
</div>
<div id="edit">
 <select id="prim" onchange="refresh()"></select>
 <button onclick="removePrim()">remove</button>
 move <button onclick="edit('translate',{dx:-GS})">-x</button><button
  onclick="edit('translate',{dx:GS})">+x</button><button
  onclick="edit('translate',{dy:-GS})">-y</button><button
  onclick="edit('translate',{dy:GS})">+y</button><button
  onclick="edit('translate',{dz:-GS})">-z</button><button
  onclick="edit('translate',{dz:GS})">+z</button>
 rot <button onclick="edit('rotate',{axis:'y',deg:-15})">&#8634;y</button><button
  onclick="edit('rotate',{axis:'y',deg:15})">&#8635;y</button><button
  onclick="edit('rotate',{axis:'x',deg:-15})">&#8634;x</button><button
  onclick="edit('rotate',{axis:'x',deg:15})">&#8635;x</button>
 scale <button onclick="edit('scale',{f:0.8})">-</button><button
  onclick="edit('scale',{f:1.25})">+</button>
 <span style="opacity:.6">(shift-drag moves the selected primitive;
  WASD/QE or right-drag pans the camera)</span>
</div>
<img id="view" width="640" height="360"/>
<script>
let az = 0, el = 15, r = 3.0, fisheye = 0, busy = false, pending = false;
let cx = 0, cy = 0, cz = 0;  // camera pan offset (world)
let interacting = false, settleTimer = null;
const GS = 0.25;  // gizmo step (world units)
const img = document.getElementById('view');
function url() {
  const t = document.getElementById('mtype').value;
  const s = interacting ? 2 : 1;  // progressive: half-res while dragging
  return `/frame?az=${az}&el=${el}&r=${r}&fisheye=${fisheye}&s=${s}` +
    `&cx=${cx}&cy=${cy}&cz=${cz}` + (t ? `&type=${t}` : '');
}
function settleSoon() {
  if (settleTimer) clearTimeout(settleTimer);
  settleTimer = setTimeout(() => { interacting = false; refresh(); }, 200);
}
function refresh() {
  if (busy) { pending = true; return; }
  busy = true;
  const t0 = performance.now();
  const u = url() + `&_=${Date.now()}`;
  const next = new Image();
  next.onload = () => {
    img.src = next.src; busy = false;
    document.getElementById('stat').textContent =
      `az ${az.toFixed(0)} el ${el.toFixed(0)} r ${r.toFixed(2)} — ${(performance.now()-t0).toFixed(0)} ms`;
    if (pending) { pending = false; refresh(); }
  };
  next.src = u;
}
function syncPrims() {
  fetch('/prims').then(r => r.json()).then(d => {
    const sel = document.getElementById('prim');
    const keep = sel.value;
    sel.innerHTML = d.prims.map((p, i) =>
      `<option value="${i}">#${i} ${p.kind} (${p.faces}f)</option>`).join('');
    if (keep && keep < d.prims.length) sel.value = keep;
  });
}
function toggle(k) { fisheye = 1 - fisheye; refresh(); }
function addPrim(kind) { fetch('/add?kind=' + kind).then(() => { syncPrims(); refresh(); }); }
function clearPrims() { fetch('/clear').then(() => { syncPrims(); refresh(); }); }
function removePrim() {
  const i = document.getElementById('prim').value;
  if (i === '') return;
  fetch('/remove?i=' + i).then(() => { syncPrims(); refresh(); });
}
function edit(op, p) {
  const i = document.getElementById('prim').value;
  if (i === '') return;
  const q = Object.entries(p).map(([k, v]) => `${k}=${v}`).join('&');
  fetch(`/edit?i=${i}&op=${op}&${q}`).then(refresh);
}
function uploadObj(inp) {
  const f = inp.files[0];
  if (!f) return;
  f.text().then(txt => fetch('/upload', {method: 'POST', body: txt})
    .then(() => { syncPrims(); refresh(); }));
}
let drag = null, dragBtn = 0;
img.onmousedown = e => { drag = [e.clientX, e.clientY]; dragBtn = e.button;
                         e.preventDefault(); };
img.oncontextmenu = e => e.preventDefault();
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  interacting = true;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (e.shiftKey) {
    // gizmo drag: move the SELECTED PRIMITIVE in the view plane
    const i = document.getElementById('prim').value;
    if (i !== '') {
      fetch(`/edit?i=${i}&op=drag&px=${dx}&py=${dy}&az=${az}&el=${el}&r=${r}`)
        .then(refresh);
    }
  } else if (dragBtn === 2) {
    // pan: move the orbit center in the view plane (gui.cpp:136-197)
    fetch(`/pan?px=${dx}&py=${dy}&az=${az}&el=${el}&r=${r}&cx=${cx}&cy=${cy}&cz=${cz}`)
      .then(rs => rs.json()).then(d => { cx = d.cx; cy = d.cy; cz = d.cz; refresh(); });
  } else {
    az -= dx * 0.5;
    el = Math.max(-89, Math.min(89, el + dy * 0.5));
    refresh();
  }
  drag = [e.clientX, e.clientY]; settleSoon();
};
img.onwheel = e => {
  interacting = true;
  r *= Math.exp(e.deltaY * 0.001); refresh(); settleSoon(); e.preventDefault();
};
window.onkeydown = e => {
  const k = e.key.toLowerCase();
  const step = r * 0.05;
  const rad = az * Math.PI / 180;
  // camera-relative WASD on the ground plane + QE vertical
  const fwd = [-Math.sin(rad), 0, -Math.cos(rad)];
  const rgt = [Math.cos(rad), 0, -Math.sin(rad)];
  if (k === 'w') { cx += fwd[0]*step; cz += fwd[2]*step; }
  else if (k === 's') { cx -= fwd[0]*step; cz -= fwd[2]*step; }
  else if (k === 'a') { cx -= rgt[0]*step; cz -= rgt[2]*step; }
  else if (k === 'd') { cx += rgt[0]*step; cz += rgt[2]*step; }
  else if (k === 'q') { cy -= step; }
  else if (k === 'e') { cy += step; }
  else return;
  refresh();
};
syncPrims(); refresh();
</script></body></html>"""


def _f(q: dict, key: str, default: float) -> float:
    return float(q.get(key, default))


def _rotation(axis: str, deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    m = np.eye(4, dtype=np.float32)
    i, j = {"x": (1, 2), "y": (2, 0), "z": (0, 1)}[axis]
    m[i, i] = c; m[i, j] = -s; m[j, i] = s; m[j, j] = c
    return m


def _camera_basis(az: float, el: float):
    """Right/up unit vectors of the orbit camera's view plane (matches
    cameras.orbit_camera's az/el convention)."""
    ar, er = math.radians(az), math.radians(el)
    fwd = -np.array([
        math.cos(er) * math.sin(ar), math.sin(er), math.cos(er) * math.cos(ar)
    ], np.float32)  # eye -> center
    world_up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(fwd, world_up)
    right /= max(np.linalg.norm(right), 1e-6)
    up = np.cross(right, fwd)
    return right, up


def apply_edit(tracer, index: int, op: str, q: dict) -> None:
    """Compose a gizmo edit onto a primitive's instance transform
    (GaussianTracer.cpp:711-736 updateInstanceTransform analog)."""
    old = tracer.primitives[index].transform.cpu().numpy().astype(np.float32)
    if op == "translate":
        d = np.eye(4, dtype=np.float32)
        d[:3, 3] = [_f(q, "dx", 0), _f(q, "dy", 0), _f(q, "dz", 0)]
        new = d @ old
    elif op == "drag":
        # screen-space drag -> world translation in the camera view plane
        right, up = _camera_basis(_f(q, "az", 0), _f(q, "el", 15))
        scale = _f(q, "r", 3.0) * 0.002  # px -> world
        t = (_f(q, "px", 0) * right - _f(q, "py", 0) * up) * scale
        d = np.eye(4, dtype=np.float32)
        d[:3, 3] = t
        new = d @ old
    elif op == "rotate":
        rot = _rotation(q.get("axis", "y"), _f(q, "deg", 0))
        p = np.eye(4, dtype=np.float32); p[:3, 3] = old[:3, 3]
        pn = np.eye(4, dtype=np.float32); pn[:3, 3] = -old[:3, 3]
        new = p @ rot @ pn @ old  # rotate about the primitive's position
    elif op == "scale":
        f = _f(q, "f", 1.0)
        sc = np.diag([f, f, f, 1.0]).astype(np.float32)
        p = np.eye(4, dtype=np.float32); p[:3, 3] = old[:3, 3]
        pn = np.eye(4, dtype=np.float32); pn[:3, 3] = -old[:3, 3]
        new = p @ sc @ pn @ old  # scale about the primitive's position
    else:
        raise ValueError(f"unknown edit op {op}")
    tracer.update_instance_transform(index, new)


def render_frame(tracer, q: dict, center: np.ndarray, width: int, height: int) -> np.ndarray:
    """The /frame request's RGB8 frame: the camera model (fisheye=1), the
    render type (type=mirror|glass|normal), the orbit pose (az, el, r and the
    pan offset cx, cy, cz) and the progressive scale (s=2 while the user
    drags: the browser upscales). Call with the viewer's lock held."""
    from gaussian_ray_tracing_tpu_torch.cameras import orbit_camera
    from gaussian_ray_tracing_tpu_torch.utils.image import quantize_rgb8

    tracer.set_camera_model("fisheye" if q.get("fisheye") == "1" else "pinhole")
    if q.get("type"):
        tracer.set_render_type(q["type"])
    s = max(1, min(4, int(_f(q, "s", 1))))
    pan = np.array([_f(q, "cx", 0), _f(q, "cy", 0), _f(q, "cz", 0)], np.float32)
    tracer.update_camera(orbit_camera(center + pan, _f(q, "r", 3.0), _f(q, "az", 0.0),
                                      _f(q, "el", 15.0), width=width // s, height=height // s,
                                      device=tracer.device))
    if q.get("type") and tracer.primitives:
        return tracer.render_rgb8()
    return quantize_rgb8(tracer.render(method="auto")["rgb"].cpu().numpy())


def make_handler(tracer, width: int, height: int):
    from gaussian_ray_tracing_tpu_torch.utils.image import encode_png

    lock = threading.Lock()
    center = tracer.scene.center().cpu().numpy()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj):
            self._send(200, json.dumps(obj).encode(), "application/json")

        def do_POST(self):
            u = urlparse(self.path)
            if u.path != "/upload":
                self._send(404, b"not found", "text/plain")
                return
            # OBJ text body -> a primitive (createLoadMesh, gui.cpp:331-339)
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            with tempfile.NamedTemporaryFile("wb", suffix=".obj", delete=False) as f:
                f.write(body)
                path = f.name
            try:
                with lock:
                    idx = tracer.create_load_mesh(path)
            finally:
                os.unlink(path)
            self._json({"index": idx})

        def do_GET(self):
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            if u.path == "/":
                self._send(200, _PAGE.encode())
            elif u.path == "/frame":
                with lock:
                    if tracer.device.type == "cuda":
                        torch.cuda.set_device(tracer.device)
                    frame = render_frame(tracer, q, center, width, height)
                self._send(200, encode_png(frame), "image/png")
            elif u.path == "/add":
                with lock:
                    if q.get("kind") == "sphere":
                        tracer.create_sphere(tess_u=36, tess_v=18)
                    else:
                        tracer.create_plane()
                self._json({})
            elif u.path == "/prims":
                with lock:
                    prims = [{"kind": ("sphere" if p.num_faces > 500 else
                                       "plane" if p.num_faces == 2 else "mesh"),
                              "faces": int(p.num_faces),
                              "transform": p.transform.cpu().numpy().tolist()}
                             for p in tracer.primitives]
                self._json({"prims": prims})
            elif u.path == "/edit":
                with lock:
                    apply_edit(tracer, int(q["i"]), q.get("op", "translate"), q)
                self._json({})
            elif u.path == "/remove":
                with lock:
                    tracer.remove_primitive(int(q["i"]))
                self._json({})
            elif u.path == "/pan":
                # view-plane pan: the new orbit-centre offset
                right, up = _camera_basis(_f(q, "az", 0), _f(q, "el", 15))
                scale = _f(q, "r", 3.0) * 0.002
                d = (-_f(q, "px", 0) * right + _f(q, "py", 0) * up) * scale
                cur = np.array([_f(q, "cx", 0), _f(q, "cy", 0), _f(q, "cz", 0)], np.float32) + d
                self._json({"cx": float(cur[0]), "cy": float(cur[1]), "cz": float(cur[2])})
            elif u.path == "/clear":
                with lock:
                    tracer.primitives.clear()
                self._json({})
            elif u.path == "/info":
                with lock:
                    info = {"n": int(tracer.scene.num_active), "prims": len(tracer.primitives)}
                self._json(info)
            else:
                self._send(404, b"not found", "text/plain")

    return Handler


def serve(tracer, host: str = "127.0.0.1", port: int = 8800, width: int = 640,
          height: int = 360, block: bool = True):
    """Start the viewer on (host, port) (port 0: any free port) for frames
    of width x height. Renders one frame first (on CUDA this builds and
    loads the kernels), then serves: forever with block, else on a daemon
    thread. Returns the server (call .shutdown() and .server_close() when
    block=False)."""
    render_frame(tracer, {}, tracer.scene.center().cpu().numpy(), width, height)
    server = ThreadingHTTPServer((host, port), make_handler(tracer, width, height))
    print(f"viewer: http://{host}:{server.server_address[1]}/", flush=True)
    if block:
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
