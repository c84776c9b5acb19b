"""Interactive browser viewer with live training (counterpart of
webdgs_tpu/render/server.py).

A zero-dependency HTTP server streams JPEG frames rendered on the GPU to a
canvas page with fly controls (WASD/Space/Ctrl move, Q/E roll, drag to
look, wheel to dolly, P point mode, L loss view, [ and ] splat scale, C
the config panel):

    python -m webdgs_tpu_torch serve scene.ply --port 8000
    python -m webdgs_tpu_torch serve --train --points ... --cameras ... \
        --images ...

With a Trainer attached, the scene shown is the one being optimised: the
HUD carries the training widget (iteration, iters/s, points, PSNR, next
densify), T pauses and resumes, the config panel's sliders post live
config updates, and dropping a COLMAP dataset (points, cameras.bin,
images.bin, images) on the page hands it to the trainer -- or starts one.

Endpoints: ``/`` (the page), ``/frame.jpg``, ``/loss.jpg``, ``/stats``,
``/control``, ``/upload`` and ``/upload_done``.

Training runs in its own thread.  Both threads launch on the device's
current stream of their own thread; frames run under ``torch.no_grad``
themselves (it is thread-local).  ``self.lock`` serialises frames and
viewer-state changes, ``_step_lock`` a training step against trainer-state
swaps (uploads), ``_state_lock`` the small shared flags.
"""

from __future__ import annotations

import io
import json
import math
import os
import random
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

PAGE = """<!doctype html>
<html><head><title>webdgs_tpu_torch viewer</title><style>
body { margin:0; background:#111; color:#ccc; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; }
canvas { display:block; margin:0 auto; }
</style></head><body>
<div id="hud">webdgs_tpu_torch &mdash; WASD/Space/Ctrl move &middot; drag look
&middot; Q/E roll &middot; wheel dolly &middot; P point mode &middot; L loss view
&middot; [/] splat scale &middot; C config &middot; drop a .ply / points3D.bin
to load it (or a whole COLMAP dataset &mdash; points + cameras.bin +
images.bin + images &mdash; to train)
<span id="stats"></span></div>
<div id="cfg" style="display:none; position:fixed; top:28px; left:8px;
background:#1b1b1bee; padding:8px 12px; border:1px solid #333;"></div>
<canvas id="c"></canvas>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
// live hyperparameter sliders, the reference's training controls
// (index.html:105-179 ranges; main.ts:301-372 wiring) — each input posts a
// deep-partial config update applied to the NEXT training step
// [path, label, lo, hi, init, isInt] — ranges mirror the reference's
// control panel (index.html:105-212) plus the densify knobs it keeps
// config-only (trainer.ts:147-164)
const SLIDERS = [
  ['max_iterations',  'iterations',  1000, 50000, 10000, 1],
  ['adam.lr_pos',     'lr position', 0, 0.001,  0.00016, 0],
  ['adam.lr_rot',     'lr rotation', 0, 0.01,   0.001, 0],
  ['adam.lr_scale',   'lr scale',    0, 0.05,   0.005, 0],
  ['adam.lr_opacity', 'lr opacity',  0, 0.2,    0.05, 0],
  ['adam.lr_color',   'lr color',    0, 0.02,   0.0025, 0],
  ['loss.lambda_l1',  'lambda L1',   0, 1,      0.8, 0],
  ['loss.lambda_l2',  'lambda L2',   0, 1,      0.0, 0],
  ['loss.lambda_dssim','lambda DSSIM',0, 1,     0.2, 0],
  ['densify.schedule.warmup_iterations', 'densify warmup', 0, 5000, 500, 1],
  ['densify.schedule.interval', 'densify interval', 10, 500, 100, 1],
  ['densify.schedule.stop_iterations', 'densify stop', 1000, 50000, 15000, 1],
  ['densify.metric_threshold',  'metric threshold', 0, 1, 0.5, 0],
  ['densify.prune_opacity',     'prune opacity', 0, 0.2, 0.01, 0],
];
const cfgDiv = document.getElementById('cfg');
const lossWarn = document.createElement('div');
lossWarn.style.cssText = 'color:#e0a030;max-width:360px;display:none';
cfgDiv.appendChild(lossWarn);
const sliderRefs = [];  // synced to the live trainer config on first /stats
// the reference warns when the loss weights drift off sum 1
// (main.ts:301-321); same check, live on every lambda change
function checkLossSum() {
  let sum = 0;
  for (const [path, inp] of sliderRefs)
    if (path.startsWith('loss.lambda')) sum += +inp.value;
  lossWarn.textContent = Math.abs(sum - 1) > 0.01
    ? `loss weights sum to ${sum.toFixed(2)} (expected 1.0): ` +
      'the effective learning rate scales with the sum' : '';
  lossWarn.style.display = lossWarn.textContent ? 'block' : 'none';
}
for (const [path, label, lo, hi, init, isInt] of SLIDERS) {
  const row = document.createElement('div');
  row.innerHTML = `<label style="display:inline-block;width:130px">${label}</label>
    <input type="range" min="${lo}" max="${hi}" step="${isInt ? Math.max(1, Math.round((hi-lo)/200)) : (hi-lo)/200}" value="${init}"
     style="width:160px;vertical-align:middle">
    <span style="display:inline-block;width:70px">${init}</span>`;
  const inp = row.querySelector('input'), val = row.querySelector('span');
  // debounce: a drag coalesces to ONE config post, not one per input tick
  let cfgTimer = null;
  inp.oninput = () => {
    val.textContent = fmtVal(inp.value, isInt);
    checkLossSum();
    clearTimeout(cfgTimer);
    cfgTimer = setTimeout(() => {
      const cfg = {}; let o = cfg;
      const parts = path.split('.');
      for (let i = 0; i < parts.length - 1; i++) o = o[parts[i]] = {};
      o[parts[parts.length-1]] = isInt ? Math.round(+inp.value) : +inp.value;
      post({config: cfg});
    }, 250);
  };
  sliderRefs.push([path, inp, val, isInt]);
  cfgDiv.appendChild(row);
}
// the init constants above are only placeholders: the running config may
// carry CLI/--config overrides, so sliders snap to the live values (the
// reference's sliders and its configs share one source, main.ts:234-372)
// camera presets, the reference's camera-choice select (index.html:236):
// jump the fly-cam to any dataset camera
const camRow = document.createElement('div');
camRow.innerHTML = `<label style="display:inline-block;width:130px">camera</label>
  <select style="width:160px"><option value="">free</option></select>`;
const camSel = camRow.querySelector('select');
camSel.onchange = () => {
  if (camSel.value !== '') post({camera_preset: +camSel.value});
};
cfgDiv.appendChild(camRow);
function syncCameras(s) {
  const n = s.trainer ? (s.trainer.n_cameras || 0) : 0;
  while (camSel.options.length > 1 + n) camSel.remove(camSel.options.length - 1);
  for (let i = camSel.options.length - 1; i < n; i++)
    camSel.add(new Option(`cam ${i}`, i));
}
function syncSliders(s) {
  syncCameras(s);
  if (!s.trainer || !s.trainer.config) return;
  for (const [path, inp, val, isInt] of sliderRefs) {
    if (path in s.trainer.config) {
      const v = s.trainer.config[path];
      // widen the range first: a CLI/--config override outside the
      // reference's slider envelope must DISPLAY truthfully, not clamp
      // (and a later drag must not silently rewrite it to the clamp)
      if (v < +inp.min) inp.min = v;
      if (v > +inp.max) inp.max = v;
      inp.value = v;
      val.textContent = fmtVal(v, isInt);
    }
  }
  checkLossSum();
}
function fmtVal(v, isInt) {
  return isInt ? String(Math.round(+v)) : (+v).toPrecision(3);
}
let keys = {}, drag = null, wheel = 0;
onkeydown = e => { keys[e.code] = true; if(e.code=='KeyP') post({toggle_mode:1});
                   if(e.code=='KeyT') post({toggle_train:1});
                   if(e.code=='KeyC') cfgDiv.style.display =
                       cfgDiv.style.display=='none' ? 'block' : 'none';
                   if(e.code=='KeyL') showLoss = !showLoss;
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
// in-browser scene loading, the reference's file-input/drag-drop entry
// point (main.ts:234-503, load.ts:6): drop a .ply or points3D.bin on the
// page and the live scene swaps without a process restart
const upMsg = document.createElement('span');
document.getElementById('hud').appendChild(upMsg);
async function upload(f) {
  const r = await fetch('/upload?name=' + encodeURIComponent(f.name),
                        {method: 'POST', body: f});
  const j = await r.json();
  if (!r.ok) throw new Error(j.error);
  return j;
}
// multi-file batches (a whole COLMAP dataset at once): images stream
// first, metadata last, then /upload_done assembles the dataset ONCE and
// (in view-only sessions) starts training — the reference's three file
// pickers (main.ts:405-458) collapsed into one drop target
async function uploadAll(files) {
  const meta = [], rest = [];
  for (const f of files)
    (/\\.(bin|json|ply)$/i.test(f.name) ? meta : rest).push(f);
  const ordered = rest.concat(meta);
  let last = null;
  try {
    for (let i = 0; i < ordered.length; i++) {
      upMsg.textContent = ` | loading ${ordered[i].name} (${i+1}/${ordered.length})...`;
      last = await upload(ordered[i]);
    }
    const d = await (await fetch('/upload_done', {method:'POST'})).json();
    upMsg.textContent = d.dataset && d.dataset !== 'no files staged'
      ? ` | ${d.dataset}`
      : (last && last.points != null ? ` | loaded ${last.points} pts` : ' | loaded');
  } catch (e) { upMsg.textContent = ` | upload failed: ${e.message || e}`; }
  setTimeout(() => upMsg.textContent = '', 8000);
}
document.body.ondragover = e => e.preventDefault();
document.body.ondrop = e => {
  e.preventDefault();
  if (e.dataTransfer.files.length) uploadAll([...e.dataTransfer.files]);
};
// click-to-browse fallback in the config panel (the reference's
// <input type=file>, index.html)
const fileRow = document.createElement('div');
fileRow.innerHTML = `<label style="display:inline-block;width:130px">scene/dataset</label>
  <input type="file" multiple accept=".ply,.bin,.json,.jpg,.jpeg,.png" style="width:220px">`;
fileRow.querySelector('input').onchange = e => {
  if (e.target.files.length) uploadAll([...e.target.files]);
};
cfgDiv.appendChild(fileRow);
setInterval(() => {
  const m = {move:[!!keys.KeyW,!!keys.KeyS,!!keys.KeyA,!!keys.KeyD,
                   !!keys.Space,!!keys.ControlLeft||!!keys.ControlRight],
             roll:[!!keys.KeyQ,!!keys.KeyE], dt:0.05};
  if (m.move.some(x=>x) || m.roll.some(x=>x)) post(m);
}, 50);
let showLoss = false;
function sendResize() { post({resize:[innerWidth, innerHeight - 24]}); }
onresize = sendResize;
async function loop() {
  sendResize();
  const s0 = await (await fetch('/stats')).json();
  c.width = s0.width; c.height = s0.height;
  syncSliders(s0);
  while (true) {
    const r = await fetch((showLoss ? '/loss.jpg?' : '/frame.jpg?') + Date.now());
    const b = await r.blob();
    const img = await createImageBitmap(b);
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
  let t = ` | ${s.points} pts | ${s.fps.toFixed(1)} fps | ${s.render_mode}`;
  if (s.trainer) {
    const tr = s.trainer;
    t += ` | iter ${tr.iteration}/${tr.max_iterations}`
       + ` | ${tr.iters_per_sec.toFixed(1)} it/s`
       + (tr.psnr != null ? ` | psnr ${tr.psnr.toFixed(2)}` : '')
       + (tr.holdout_psnr != null ? ` | holdout ${tr.holdout_psnr.toFixed(2)}` : '')
       + (tr.next_densify != null ? ` | densify@${tr.next_densify}` : '')
       + (tr.error ? ` | ERROR: ${tr.error}`
          : (tr.training ? ' | TRAINING (T pauses)' : ' | paused (T resumes)'));
  }
  document.getElementById('stats').textContent = t;
}, 1000);
</script></body></html>
"""


def _flatten_config(cfg) -> dict:
    """TrainerConfig -> {'adam.lr_pos': 0.00016, ...}: every scalar leaf of
    the nested dataclasses keyed by its dotted path (the paths of the
    page's sliders and of /control's deep partials)."""
    import dataclasses

    flat: dict = {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            path = f"{prefix}{f.name}"
            if dataclasses.is_dataclass(val):
                walk(val, path + ".")
            elif isinstance(val, (int, float, bool)):
                flat[path] = val

    walk(cfg, "")
    return flat


def _jpeg(img, quality: int) -> bytes:
    from PIL import Image
    arr = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


class ViewerServer:
    # render at reduced resolution while the camera moves; after motion
    # stops the resolution refines one octave per frame
    MOTION_WINDOW_S = 0.4
    MOTION_DOWNSCALE = 2

    # evaluate the holdout split (when there is one) this often during live
    # training, on this many of its views
    HOLDOUT_EVAL_EVERY = 500
    HOLDOUT_EVAL_VIEWS = 4

    def __init__(self, viewer, quality: int = 85, trainer=None,
                 start_training: bool = True,
                 motion_downscale: int | None = None,
                 holdout: tuple[list, list] | None = None):
        self.viewer = viewer
        self.quality = quality
        # serializes frames and viewer-state mutation
        self.lock = threading.Lock()
        # guards the small shared flags (training, _loss_view, ...)
        self._state_lock = threading.Lock()
        self.fps = 0.0  # EMA
        self._last_input = 0.0
        self._down_level = 1  # current progressive-refine octave
        if motion_downscale is not None:
            self.MOTION_DOWNSCALE = motion_downscale
        self.trainer = trainer
        self.training = bool(trainer) and start_training
        self.train_error: str | None = None
        self._loss_view: tuple[int, float] = (0, 0.0)  # (index, chosen_at)
        self.holdout = holdout if holdout and holdout[0] else None
        self._holdout_groups: dict | None = None  # grouped at first eval
        self.holdout_psnr: float | None = None
        self._shutdown = threading.Event()
        # serializes trainer-state swaps (uploads) against a running step
        self._step_lock = threading.Lock()
        # uploaded dataset pieces, staged until a training set is complete
        self._dataset_stage: dict = {"extr": None, "intr": None,
                                     "json": None, "imgs": {}}
        self._assemble_lock = threading.Lock()
        self._train_thread: threading.Thread | None = None
        if trainer is not None:
            self._start_train_thread()

    def _start_train_thread(self) -> None:
        self._train_thread = threading.Thread(
            target=self._train_loop, daemon=True, name="webdgs-train")
        self._train_thread.start()

    # -- live training: one step after another on its own thread ----------
    def _train_loop(self) -> None:
        tr = self.trainer
        while not self._shutdown.is_set():
            if tr.iteration >= tr.config.max_iterations:
                with self._state_lock:
                    self.training = False
            if not self.training:
                self._shutdown.wait(0.05)
                continue
            try:
                with self._step_lock:
                    tr.step()
                if (self.holdout is not None
                        and tr.iteration % self.HOLDOUT_EVAL_EVERY == 0):
                    if self._holdout_groups is None:
                        # group and upload the holdout views once
                        from webdgs_tpu_torch.train.trainer import \
                            _group_views
                        cams, imgs = self.holdout
                        self._holdout_groups = _group_views(
                            cams[:self.HOLDOUT_EVAL_VIEWS],
                            imgs[:self.HOLDOUT_EVAL_VIEWS], tr.device)
                    r = tr.evaluate(groups=self._holdout_groups)
                    self.holdout_psnr = r["psnr"]
            except Exception as e:  # surface the failure in the HUD
                traceback.print_exc()
                with self._state_lock:
                    self.train_error = f"{type(e).__name__}: {e}"
                    self.training = False
                continue
            # publish the new scene to the frame renderer: one attribute
            # store of a scene whose tensors are never updated in place
            self.viewer.set_point_cloud(tr.scene)

    def handle_upload(self, name: str, data: bytes) -> dict:
        """Adopt an uploaded file:
          * scene files (binary PLY / COLMAP points3D.bin): swap the live
            scene; an attached trainer restarts from the new points (fresh
            optimizer, iteration 0);
          * camera metadata (cameras.bin / images.bin / a cameras .json):
            staged;
          * ground-truth images (.jpg/.png): staged by file name.
        ``/upload_done`` then assembles the staged dataset
        (:meth:`_assemble_dataset`)."""
        low = name.lower()
        if low.endswith("cameras.bin"):
            from webdgs_tpu_torch.io.colmap import load_cameras_bin
            with self._state_lock:
                self._dataset_stage["intr"] = load_cameras_bin(data)
                n = len(self._dataset_stage["intr"])
            return {"name": name, "staged": "camera intrinsics",
                    "count": n}
        if low.endswith("images.bin"):
            from webdgs_tpu_torch.io.colmap import load_images_bin
            with self._state_lock:
                self._dataset_stage["extr"] = load_images_bin(data)
                n = len(self._dataset_stage["extr"])
            return {"name": name, "staged": "camera extrinsics",
                    "count": n}
        if low.endswith(".json"):
            from webdgs_tpu_torch.io.colmap import load_cameras_json
            with self._state_lock:
                self._dataset_stage["json"] = load_cameras_json(data)
                n = len(self._dataset_stage["json"])
            return {"name": name, "staged": "cameras (json)",
                    "count": n}
        if low.endswith((".jpg", ".jpeg", ".png")):
            from PIL import Image
            arr = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                             dtype=np.float32) / 255.0
            base = os.path.basename(name)
            with self._state_lock:
                self._dataset_stage["imgs"][base] = {
                    "name": base, "image": arr,
                    "width": arr.shape[1], "height": arr.shape[0]}
                n = len(self._dataset_stage["imgs"])
            return {"name": name, "staged": "image", "count": n}
        from webdgs_tpu_torch.io.ply import load_point_cloud
        scene = load_point_cloud(data, self.viewer.device)
        n = int(scene.num_alive())
        if self.trainer is not None:
            with self._state_lock:
                was_training = self.training
                self.training = False
            # wait out a running step, then swap under the step lock so a
            # racing step cannot publish the old scene over the new one
            with self._step_lock:
                self.trainer.resume_from(scene, None, 0)
                scene = self.trainer.scene  # the capacity-padded copy
            with self._state_lock:
                self.train_error = None
                self.training = was_training
        with self.lock:
            self.viewer.set_point_cloud(scene)
            self.viewer.frame_scene()
        return {"name": name, "points": n}

    def _assemble_dataset(self) -> str:
        """Build (cameras, images) from the staged uploads and hand them to
        the trainer, or start one on the live scene in a view-only session.
        Returns a status line for the response."""
        # two concurrent /upload_done posts must not both start a Trainer
        with self._assemble_lock:
            return self._assemble_dataset_locked()

    def _assemble_dataset_locked(self) -> str:
        with self._state_lock:
            st = self._dataset_stage
            extr, intr, js = st["extr"], st["intr"], st["json"]
            imgs = dict(st["imgs"])
        if extr is None and intr is None and js is None and not imgs:
            return "no files staged"
        if js is not None:
            cams = js
        elif extr is not None:
            if intr is not None:
                from webdgs_tpu_torch.io.colmap import \
                    merge_extrinsics_intrinsics
                cams = merge_extrinsics_intrinsics(extr, intr)
            else:
                cams = extr
        else:
            return "waiting for camera extrinsics (images.bin or .json)"
        if not imgs:
            return "waiting for ground-truth images"
        from webdgs_tpu_torch.io.images import numeric_key
        # pair by file name when the metadata carries names (images.bin
        # does), else by numeric-sorted index, like the CLI
        named = [(c, imgs[c.img_name]) for c in cams
                 if c.img_name and c.img_name in imgs]
        if named:
            named.sort(key=lambda p: numeric_key(p[0].img_name))
            cameras = [c for c, _ in named]
            images = [m for _, m in named]
        else:
            cs = sorted(cams, key=lambda c: numeric_key(c.img_name or
                                                        str(c.id)))
            ms = sorted(imgs.values(), key=lambda m: numeric_key(m["name"]))
            n = min(len(cs), len(ms))
            cameras, images = cs[:n], ms[:n]
        if not cameras:
            return "no camera/image pairs"
        if self.trainer is not None:
            with self._step_lock:
                self.trainer.set_dataset(cameras, images)
            return f"dataset set: {len(cameras)} views"
        # view-only session: a Trainer on the live scene with the default
        # config (sliders and config posts change it from the browser)
        from webdgs_tpu_torch.train.config import TrainerConfig
        from webdgs_tpu_torch.train.trainer import Trainer
        trainer = Trainer(self.viewer.scene, cameras, images,
                          TrainerConfig(), self.viewer.settings)
        trainer.dataset_cameras = cameras
        with self._state_lock:
            self.trainer = trainer
            self.train_error = None
            self.training = True
        self._start_train_thread()
        return f"training started: {len(cameras)} views"

    def toggle_training(self) -> bool:
        if self.trainer is None:
            return False
        with self._state_lock:
            if self.trainer.iteration < self.trainer.config.max_iterations:
                self.training = not self.training
            return self.training

    def shutdown(self) -> None:
        """Stop the training thread (it finishes its current step)."""
        self._shutdown.set()
        if self._train_thread is not None:
            self._train_thread.join(timeout=30)

    CONTROL_KEYS = frozenset((
        "move", "roll", "drag", "wheel", "dt", "toggle_mode", "toggle_train",
        "config", "gaussian_scale_delta", "point_size_delta", "resize",
        "camera_preset"))

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
            if "toggle_train" in msg:
                self.toggle_training()
            if "config" in msg and self.trainer is not None:
                # a live deep-partial config update, applied from the next
                # training step
                try:
                    self.trainer.set_config(msg["config"])
                except (ValueError, TypeError) as e:
                    with self._state_lock:
                        self.train_error = f"config: {e}"
            if "camera_preset" in msg:
                # jump the fly camera to a dataset camera; fovY from
                # (fy, height)
                cams = getattr(self.trainer, "dataset_cameras", None)
                if cams:
                    c = cams[int(msg["camera_preset"]) % len(cams)]
                    if c.position is not None:
                        self.viewer.control.position = np.asarray(
                            c.position, np.float32)
                    if c.rotation is not None:
                        self.viewer.control.rotation = np.asarray(
                            c.rotation, np.float32)
                    if c.fy and c.height:
                        self.viewer.fov_y = 2.0 * math.atan(
                            c.height / (2.0 * c.fy))
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
        """HUD stats: fps, point count, render mode, viewport, the tile
        entries the last frame asked for, and -- with a trainer attached --
        its iteration, rate, points, PSNR, next densify, state and live
        config."""
        out = {
            "fps": self.fps,
            "points": int(self.viewer.scene.num_alive()),
            "render_mode": self.viewer.render_mode,
            "width": self.viewer.width,
            "height": self.viewer.height,
            "entries": self.viewer.entry_demand,
        }
        if self.trainer is not None:
            tr = self.trainer
            m = tr.last_metrics
            psnr = m.get("psnr") if isinstance(m, dict) else None
            out["trainer"] = {
                "iteration": tr.iteration,
                "max_iterations": tr.config.max_iterations,
                "iters_per_sec": tr.iters_per_sec,
                "points": tr.num_points,
                "psnr": None if psnr is None else float(psnr),
                "loss": (None if not isinstance(m, dict) or "loss" not in m
                         else float(m["loss"])),
                "next_densify": tr.next_densify_iteration(),
                "training": self.training,
                "error": self.train_error,
                "holdout_psnr": self.holdout_psnr,
                "n_cameras": len(getattr(tr, "dataset_cameras", None) or ()),
                # live config leaves by dotted path, for the sliders
                "config": _flatten_config(tr.config),
            }
        return out

    def frame_jpeg(self) -> bytes:
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
        return _jpeg(img, self.quality)

    LOSS_VIEW_HOLD_S = 2.0

    def loss_jpeg(self) -> bytes:
        """Per-pixel |loss gradient| of a dataset view (the reference's
        show-loss view); the normal frame without a trainer.  The sampled
        view is held for LOSS_VIEW_HOLD_S, since the page polls this at
        frame rate."""
        if self.trainer is None:
            return self.frame_jpeg()
        now = time.monotonic()
        with self._state_lock:
            idx, chosen = self._loss_view
            if now - chosen > self.LOSS_VIEW_HOLD_S:
                flat_count = sum(g["count"]
                                 for g in self.trainer.groups.values())
                idx = random.randrange(flat_count)
                self._loss_view = (idx, now)
        img = self.trainer.visualize_loss(idx).cpu().numpy()
        return _jpeg(img, self.quality)

    def serve(self, port: int = 8000, host: str = "127.0.0.1") -> None:
        server = make_http_server(self, host, port)
        mode = " (live training)" if self.trainer is not None else ""
        print(f"viewer at http://{host}:{port}/{mode}")
        try:
            server.serve_forever()
        finally:
            server.server_close()
            self.shutdown()


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

        def _json(self, code, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path.startswith("/frame.jpg"):
                self._send(200, vs.frame_jpeg(), "image/jpeg")
            elif self.path.startswith("/loss.jpg"):
                self._send(200, vs.loss_jpeg(), "image/jpeg")
            elif self.path.startswith("/stats"):
                self._json(200, vs.stats())
            elif self.path == "/" or self.path.startswith("/index"):
                self._send(200, PAGE.encode(), "text/html")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            if self.path == "/control":
                unknown = vs.handle_control(json.loads(data or b"{}"))
                self._json(200, {"unknown_keys": unknown} if unknown else {})
            elif self.path.startswith("/upload_done"):
                try:
                    self._json(200, {"dataset": vs._assemble_dataset()})
                except Exception as e:  # bad pairing etc.: report it
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
            elif self.path.startswith("/upload"):
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                name = (q.get("name") or ["scene"])[0]
                try:
                    self._json(200, vs.handle_upload(name, data))
                except Exception as e:  # malformed file: keep the scene
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
            else:
                self._send(404, b"not found", "text/plain")

    return ThreadingHTTPServer((host, port), Handler)
