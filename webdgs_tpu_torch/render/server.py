"""Interactive browser viewer, view mode (counterpart of
webdgs_tpu/render/server.py:287-767).

A zero-dependency HTTP server streams JPEG frames rendered on the GPU to a
canvas page with fly controls (WASD/Space/Ctrl move, Q/E roll, drag to
look, wheel to dolly, P point mode, [ and ] splat scale):

    python -m webdgs_tpu_torch serve scene.ply --port 8000

Endpoints: ``/`` (the page), ``/frame.jpg``, ``/stats`` and ``/control``.
The reference's live-training and upload branches (``/loss.jpg``,
``/upload``, ``/upload_done``) are not yet ported and answer HTTP 501.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

PAGE = """<!doctype html>
<html><head><title>webdgs_tpu_torch viewer</title><style>
body { margin:0; background:#111; color:#ccc; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; }
canvas { display:block; margin:0 auto; }
</style></head><body>
<div id="hud">webdgs_tpu_torch &mdash; WASD/Space/Ctrl move &middot; drag look
&middot; Q/E roll &middot; wheel dolly &middot; P point mode
&middot; [/] splat scale &middot; ,/. point size
<span id="stats"></span></div>
<canvas id="c"></canvas>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
let keys = {}, drag = null;
onkeydown = e => { keys[e.code] = true;
                   if(e.code=='KeyP') post({toggle_mode:1});
                   if(e.code=='BracketLeft') post({gaussian_scale_delta:-0.05});
                   if(e.code=='BracketRight') post({gaussian_scale_delta:0.05});
                   if(e.code=='Comma') post({point_size_delta:-1});
                   if(e.code=='Period') post({point_size_delta:1}); };
onkeyup = e => keys[e.code] = false;
c.onpointerdown = e => { drag = [e.pageX, e.pageY]; c.setPointerCapture(e.pointerId); };
c.onpointerup = () => drag = null;
c.onpointermove = e => {
  if (drag) { post({drag:[e.pageX-drag[0], e.pageY-drag[1]]}); drag=[e.pageX,e.pageY]; }
};
c.onwheel = e => { e.preventDefault(); post({wheel: e.deltaY}); };
function post(o) { fetch('/control', {method:'POST', body:JSON.stringify(o)}); }
setInterval(() => {
  const m = {move:[!!keys.KeyW,!!keys.KeyS,!!keys.KeyA,!!keys.KeyD,
                   !!keys.Space,!!keys.ControlLeft||!!keys.ControlRight],
             roll:[!!keys.KeyQ,!!keys.KeyE], dt:0.05};
  if (m.move.some(x=>x) || m.roll.some(x=>x)) post(m);
}, 50);
function sendResize() { post({resize:[innerWidth, innerHeight - 24]}); }
onresize = sendResize;
async function loop() {
  sendResize();
  const s0 = await (await fetch('/stats')).json();
  c.width = s0.width; c.height = s0.height;
  while (true) {
    const r = await fetch('/frame.jpg?' + Date.now());
    const img = await createImageBitmap(await r.blob());
    // motion frames arrive at reduced resolution; stretch to the canvas
    ctx.drawImage(img, 0, 0, c.width, c.height);
  }
}
loop();
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  if (c.width != s.width || c.height != s.height) {
    c.width = s.width; c.height = s.height;
  }
  document.getElementById('stats').textContent =
    ` | ${s.points} pts | ${s.fps.toFixed(1)} fps | ${s.render_mode}`;
}, 1000);
</script></body></html>
"""

NOT_PORTED = (b"not yet ported: live training and uploads are served by "
              b"the JAX package (python -m webdgs_tpu serve)")


class ViewerServer:
    # render at reduced resolution while the camera moves; after motion
    # stops the resolution refines one octave per frame
    MOTION_WINDOW_S = 0.4
    MOTION_DOWNSCALE = 2

    # keys the reference's /control accepts; toggle_train, config and
    # camera_preset act on a trainer and are no-ops in view mode, as in
    # the reference's view mode
    CONTROL_KEYS = frozenset((
        "move", "roll", "drag", "wheel", "dt", "toggle_mode", "toggle_train",
        "config", "gaussian_scale_delta", "point_size_delta", "resize",
        "camera_preset"))

    def __init__(self, viewer, quality: int = 85,
                 motion_downscale: int | None = None):
        self.viewer = viewer
        self.quality = quality
        # serializes device work and viewer-state mutation
        self.lock = threading.Lock()
        self.fps = 0.0  # EMA
        self._last_input = 0.0
        self._down_level = 1  # current progressive-refine octave
        if motion_downscale is not None:
            self.MOTION_DOWNSCALE = motion_downscale

    def handle_control(self, msg: dict) -> list[str]:
        """Apply a control message; returns the unrecognized keys."""
        ctl = self.viewer.control
        if any(k in msg for k in ("move", "roll", "drag", "wheel")):
            self._last_input = time.monotonic()
        with self.lock:
            if "move" in msg:
                f, b, l, r, u, d = msg["move"]
                ctl.move(msg.get("dt", 0.05), forward=f, backward=b,
                         left=l, right=r, up=u, down=d)
            if "roll" in msg:
                ql, qe = msg["roll"]
                ctl.roll(msg.get("dt", 0.05), left=ql, right=qe)
            if "drag" in msg:
                dx, dy = msg["drag"]
                ctl.drag(dx, dy)
            if "wheel" in msg:
                ctl.wheel(float(msg["wheel"]))
            if "toggle_mode" in msg:
                self.viewer.set_render_mode(
                    "pointcloud" if self.viewer.render_mode == "gaussian"
                    else "gaussian")
            if "gaussian_scale_delta" in msg:
                cur = self.viewer.gaussian_scaling
                self.viewer.set_gaussian_scaling(
                    cur + float(msg["gaussian_scale_delta"]))
            if "point_size_delta" in msg:
                self.viewer.set_point_size(max(
                    1.0, self.viewer.point_size_px
                    + float(msg["point_size_delta"])))
            if "resize" in msg:
                # quantize to multiples of 64, like the reference
                w, h = msg["resize"]
                w = int(np.clip((int(w) // 64) * 64, 64, 3840))
                h = int(np.clip((int(h) // 64) * 64, 64, 2160))
                self.viewer.width, self.viewer.height = w, h
        return [k for k in msg if k not in self.CONTROL_KEYS]

    def stats(self) -> dict:
        """HUD stats: fps, point count, render mode, viewport, and the tile
        entries the last frame asked for."""
        return {
            "fps": self.fps,
            "points": int(self.viewer.scene.num_alive()),
            "render_mode": self.viewer.render_mode,
            "width": self.viewer.width,
            "height": self.viewer.height,
            "entries": self.viewer.entry_demand,
        }

    def frame_jpeg(self) -> bytes:
        from PIL import Image
        moving = (time.monotonic() - self._last_input) < self.MOTION_WINDOW_S
        t0 = time.perf_counter()
        with self.lock:
            down = (self.MOTION_DOWNSCALE if moving
                    else max(1, self._down_level // 2))
            self._down_level = down
            img = self.viewer.render(downscale=down)
        dt = time.perf_counter() - t0
        inst = 1.0 / dt if dt > 0 else 0.0
        self.fps = inst if self.fps == 0 else 0.9 * self.fps + 0.1 * inst
        arr = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=self.quality)
        return buf.getvalue()

    def serve(self, port: int = 8000, host: str = "127.0.0.1") -> None:
        server = make_http_server(self, host, port)
        print(f"viewer at http://{host}:{port}/")
        try:
            server.serve_forever()
        finally:
            server.server_close()


def make_http_server(vs: ViewerServer, host: str, port: int):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.jpg"):
                self._send(200, vs.frame_jpeg(), "image/jpeg")
            elif self.path.startswith("/loss.jpg"):
                self._send(501, NOT_PORTED, "text/plain")
            elif self.path.startswith("/stats"):
                self._send(200, json.dumps(vs.stats()).encode(),
                           "application/json")
            elif self.path == "/" or self.path.startswith("/index"):
                self._send(200, PAGE.encode(), "text/html")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path == "/control":
                length = int(self.headers.get("Content-Length", 0))
                msg = json.loads(self.rfile.read(length) or b"{}")
                unknown = vs.handle_control(msg)
                body = (json.dumps({"unknown_keys": unknown}).encode()
                        if unknown else b"{}")
                self._send(200, body, "application/json")
            elif self.path.startswith("/upload"):
                self._send(501, NOT_PORTED, "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

    return ThreadingHTTPServer((host, port), Handler)
