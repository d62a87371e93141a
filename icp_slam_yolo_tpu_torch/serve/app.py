"""HTTP control panel: route-parity server on the standard library; the
counterpart of the JAX package's ``serve/app.py`` (the same routes, status
codes, content types and page), over the port's `ServerState`.

Re-implements the reference's Flask surface (`mainn.py:404-700`) without the
Flask dependency (stdlib ``ThreadingHTTPServer``):

  GET  /                      control-panel page (reference: `templates/jjj.html`)
  GET  /points_stream         SSE: {points px, pose {x,y,ex,ey}, distance, rmse}
                              every 100 ms (`mainn.py:595-641`; also serves the
                              rmse field the reference UI expects but never got)
  GET  /video_feed            multipart JSON frames of current scan points
                              (`mainn.py:567-582`)
  GET  /map_image             current occupancy rendering as PNG (`mainn.py:584`)
  GET  /camera_feed?eye=0|1   MJPEG stream of annotated stereo detection frames
                              (reference overlay `mainn.py:236-248`, shown via
                              the display loop `mainn.py:771-780`)
  GET  /camera_image?eye=0|1  latest annotated frame as one JPEG (404 if none)
  GET  /map_viewer            deep-zoom tiled map viewer (reference:
                              OpenSeadragon in `templates/jjj.html:9,150`;
                              here a dependency-free canvas client)
  GET  /map_tiles_meta        pyramid metadata {width,height,tile,zmax,mm_per_px}
  GET  /map_tiles?z=&x=&y=    one 256 px PNG tile of the live map at level z
  GET  /save_map?filename=X   persist PNG + pixel-coords npy (`mainn.py:434-454`)
  GET  /list_saved_files      *.png in the work dir (`mainn.py:455-462`)
  POST /add_point             add POI at the robot pose (`mainn.py:464-479`)
  POST /set_active_target     {id} or {id: null} (`mainn.py:481-505`)
  GET  /get_points_of_interest POIs in pixel coords (`mainn.py:507-522`)
  GET  /stop_stream /resume_stream  pause/unpause SLAM (`mainn.py:654-663`)
  GET  /save_frame            snapshot current map to capture_<ts>.png (`mainn.py:665`)
  GET  /capture_map           one-shot capture flag (`mainn.py:696-700`)
  POST /toggle_visibility     {map, icp} booleans (`mainn.py:646-652`)
  GET  /load_map/<file>       load PNG/PCD, switch to localization (`mainn.py:679`)
  GET  /resume_mapping        leave localization mode (reference's update_mode=1
                              intent, which `mainn.py` set but never read)
  POST /load_map_for_imshow   {filename} display a saved map (`mainn.py:404-431`)
  GET  /get_map_points/<base> saved npy pixel points as JSON (`mainn.py:524-540`)
  GET  /get_map_image/<file>  saved PNG bytes (`mainn.py:542-562`)
"""

from __future__ import annotations

import json
import os
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np

from icp_slam_yolo_tpu_torch.serve.state import ServerState

_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>tpu-slam control panel</title>
<style>
 body{font-family:system-ui;margin:0;background:#111;color:#eee;display:flex;height:100vh}
 #side{width:300px;min-width:300px;overflow-y:auto;padding:.8rem;background:#181818;border-right:1px solid #333}
 #main{flex:1;padding:.8rem;overflow:hidden}
 canvas{border:1px solid #444;background:#222;cursor:grab;touch-action:none}
 button{margin:.15rem;padding:.3rem .6rem;background:#2a2a2a;color:#eee;border:1px solid #555;border-radius:4px;cursor:pointer}
 button:hover{background:#3a3a3a}
 button.active{background:#264;border-color:#4a6}
 #stats{margin:.4rem 0;font-family:monospace;font-size:.85rem}
 h3{margin:.8rem 0 .3rem;font-size:.9rem;color:#9ab;text-transform:uppercase;letter-spacing:.05em}
 .poi,.mapfile{display:flex;align-items:center;gap:.3rem;padding:.15rem 0;font-size:.85rem}
 .poi.target{color:#fd6}
 .mapfile img{width:56px;height:46px;object-fit:cover;border:1px solid #444}
 .mapfile span{flex:1;overflow:hidden;text-overflow:ellipsis;white-space:nowrap}
 label{font-size:.85rem;margin-right:.6rem}
 #mode{font-family:monospace;color:#6c6}
</style></head>
<body>
<div id="side">
 <h2 style="margin:.2rem 0">tpu-slam</h2>
 <div id="mode">mapping</div>
 <div><a href="/map_viewer" style="color:#8cf;font-size:.85rem">deep-zoom map viewer &rarr;</a></div>
 <h3>stream</h3>
 <button onclick="fetch('/stop_stream')">pause</button>
 <button onclick="fetch('/resume_stream')">resume</button>
 <button onclick="fetch('/save_frame')">save frame</button>
 <button onclick="fetch('/capture_map')">capture</button>
 <h3>layers</h3>
 <label><input type="checkbox" id="showMap" checked onchange="toggles()"> map</label>
 <label><input type="checkbox" id="showIcp" checked onchange="toggles()"> icp view</label>
 <label><input type="checkbox" id="showSaved" onchange="draw()"> saved overlay</label>
 <h3>points of interest</h3>
 <button onclick="addPoi()">add POI at robot</button>
 <button onclick="setTarget(null)">clear target</button>
 <div id="pois"></div>
 <h3>saved maps</h3>
 <button onclick="saveMap()">save map</button>
 <button onclick="refreshFiles()">refresh list</button>
 <button onclick="fetch('/resume_mapping').then(()=>{mode('mapping')})">resume mapping</button>
 <div id="files"></div>
</div>
<div id="main">
 <div id="stats">pose: &mdash; | distance: &mdash; | rmse: &mdash;</div>
 <canvas id="map" width="1000" height="700"></canvas>
 <div style="display:inline-block;vertical-align:top">
  <img id="icp" width="280" height="280" style="display:block;border:1px solid #444" title="ICP debug view">
  <img id="cam0" width="280" style="display:block;border:1px solid #444;margin-top:4px" title="left camera (annotated detections)" src="/camera_feed?eye=0">
  <img id="cam1" width="280" style="display:block;border:1px solid #444;margin-top:4px" title="right camera (annotated detections)" src="/camera_feed?eye=1">
 </div>
</div>
<script>
const canvas = document.getElementById('map'), ctx = canvas.getContext('2d');
let pois = [], landmarks = [], activeTarget = null, live = {}, savedPts = [];
let view = {s: 1, x: 0, y: 0};           // pan/zoom: map px -> screen
const bg = new Image(); let bgOk = false;
bg.onload = () => { bgOk = true; draw(); };

// --- pan (drag) + zoom (wheel, anchored at the cursor) -----------------
let drag = null;
canvas.addEventListener('pointerdown', e => { drag = {x: e.offsetX, y: e.offsetY}; canvas.setPointerCapture(e.pointerId); });
canvas.addEventListener('pointermove', e => {
  if (!drag) return;
  view.x += e.offsetX - drag.x; view.y += e.offsetY - drag.y;
  drag = {x: e.offsetX, y: e.offsetY}; draw();
});
canvas.addEventListener('pointerup', () => { drag = null; });
canvas.addEventListener('wheel', e => {
  e.preventDefault();
  const f = e.deltaY < 0 ? 1.15 : 1/1.15, s2 = Math.min(20, Math.max(.2, view.s * f));
  view.x = e.offsetX - (e.offsetX - view.x) * (s2 / view.s);
  view.y = e.offsetY - (e.offsetY - view.y) * (s2 / view.s);
  view.s = s2; draw();
}, {passive: false});

function draw(){
  ctx.setTransform(1, 0, 0, 1, 0, 0);
  ctx.fillStyle = '#222'; ctx.fillRect(0, 0, canvas.width, canvas.height);
  ctx.setTransform(view.s, 0, 0, view.s, view.x, view.y);
  if (bgOk && document.getElementById('showMap').checked) ctx.drawImage(bg, 0, 0);
  if (document.getElementById('showSaved').checked && savedPts.length){
    ctx.fillStyle = '#579';
    for (const [x, y] of savedPts) ctx.fillRect(x, y, 1.5, 1.5);
  }
  if (live.points){
    ctx.fillStyle = '#4f4';
    for (const [x, y] of live.points) ctx.fillRect(x, y, 2, 2);
  }
  if (live.pose){
    ctx.fillStyle = '#48f';
    ctx.beginPath(); ctx.arc(live.pose.x, live.pose.y, 5/view.s, 0, 7); ctx.fill();
    ctx.strokeStyle = '#f44'; ctx.lineWidth = 2/view.s; ctx.beginPath();
    ctx.moveTo(live.pose.x, live.pose.y); ctx.lineTo(live.pose.ex, live.pose.ey); ctx.stroke();
  }
  ctx.font = `${12/view.s}px monospace`;
  for (const p of pois){
    ctx.fillStyle = (activeTarget === p.id) ? '#fd6' : '#ff0';
    ctx.beginPath(); ctx.arc(p.pos_px[0], p.pos_px[1], 5/view.s, 0, 7); ctx.fill();
    ctx.fillText(p.name, p.pos_px[0] + 7/view.s, p.pos_px[1]);
  }
  ctx.fillStyle = '#f0f';  // fused pallet landmarks
  for (const lm of landmarks){
    ctx.fillRect(lm.px - 4/view.s, lm.py - 4/view.s, 8/view.s, 8/view.s);
    ctx.fillText('pallet x' + lm.n_obs, lm.px + 6/view.s, lm.py);
  }
}

// --- POIs + target -------------------------------------------------------
async function refreshPois(){
  pois = (await (await fetch('/get_points_of_interest')).json()).points;
  const el = document.getElementById('pois');
  el.innerHTML = '';
  for (const p of pois){
    const row = document.createElement('div');
    row.className = 'poi' + (activeTarget === p.id ? ' target' : '');
    row.innerHTML = `<span>${p.name} (${p.pos_px[0]},${p.pos_px[1]})</span>`;
    const b = document.createElement('button');
    b.textContent = activeTarget === p.id ? 'targeted' : 'set target';
    if (activeTarget === p.id) b.className = 'active';
    b.onclick = () => setTarget(p.id);
    row.appendChild(b); el.appendChild(row);
  }
  draw();
}
async function addPoi(){ await fetch('/add_point', {method: 'POST'}); refreshPois(); }
async function setTarget(id){
  await fetch('/set_active_target', {method: 'POST',
    headers: {'Content-Type': 'application/json'}, body: JSON.stringify({id})});
  activeTarget = id; refreshPois();
}

// --- saved-map gallery ---------------------------------------------------
async function refreshFiles(){
  const files = (await (await fetch('/list_saved_files')).json()).files;
  const el = document.getElementById('files');
  el.innerHTML = '';
  for (const f of files){
    const row = document.createElement('div');
    row.className = 'mapfile';
    const img = document.createElement('img');
    img.src = '/get_map_image/' + encodeURIComponent(f);
    const name = document.createElement('span'); name.textContent = f;
    const view_ = document.createElement('button'); view_.textContent = 'view';
    view_.onclick = async () => {
      await fetch('/load_map_for_imshow', {method: 'POST',
        headers: {'Content-Type': 'application/json'}, body: JSON.stringify({filename: f})});
      const base = f.replace(/\\.[^.]*$/, '');
      savedPts = (await (await fetch('/get_map_points/' + encodeURIComponent(base))).json()).points;
      document.getElementById('showSaved').checked = true; draw();
    };
    const load = document.createElement('button'); load.textContent = 'localize';
    load.onclick = async () => {
      const r = await (await fetch('/load_map/' + encodeURIComponent(f))).json();
      mode('localization'); alert(r.message);
    };
    row.append(img, name, view_, load); el.appendChild(row);
  }
}
function saveMap(){
  const name = prompt('filename base', 'map_1');
  if (name) fetch('/save_map?filename=' + encodeURIComponent(name)).then(refreshFiles);
}
function mode(m){ document.getElementById('mode').textContent = m; }
function toggles(){
  const m = document.getElementById('showMap').checked, i = document.getElementById('showIcp').checked;
  fetch('/toggle_visibility', {method: 'POST',
    headers: {'Content-Type': 'application/json'}, body: JSON.stringify({map: m, icp: i})});
  document.getElementById('icp').style.display = i ? '' : 'none';
  draw();
}

refreshPois(); refreshFiles();
setInterval(async () => {
  if (document.getElementById('showIcp').checked)
    document.getElementById('icp').src = '/icp_image?t=' + Date.now();
  if (document.getElementById('showMap').checked) bg.src = '/map_image?t=' + Date.now();
  landmarks = (await (await fetch('/landmarks')).json()).landmarks;
}, 2000);

const es = new EventSource('/points_stream');
es.onmessage = (ev) => {
  const d = JSON.parse(ev.data);
  live = d;
  if (d.pose){
    let s = `pose: ${d.pose.x},${d.pose.y} | distance: ${d.distance ?? '—'} | rmse: ${d.rmse ?? '—'}`;
    if (d.camera_data) s += ` | pallet: ${d.camera_data.distance_mm}mm yaw ${d.camera_data.yaw_deg}°`;
    document.getElementById('stats').textContent = s;
  }
  draw();
};
</script></body></html>
"""

# Deep-zoom map viewer (reference: `templates/jjj.html` embeds OpenSeadragon
# from a CDN, lines 9,150 — zero-egress here, so this is a dependency-free
# canvas client speaking the same tiled-pyramid contract: /map_tiles_meta +
# /map_tiles?z=&x=&y=).  Wheel = zoom around cursor (native -> beyond-native
# magnification like OSD), drag = pan, POIs + live robot pose overlaid, and
# the cursor's map position is read out in millimetres.
_VIEWER_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>tpu-slam deep-zoom map</title>
<style>
 body{margin:0;background:#111;color:#eee;font-family:system-ui;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:.4rem .7rem;border-radius:6px;font-size:.85rem;z-index:2}
 #hud a{color:#8cf}
 canvas{display:block;cursor:grab}
</style></head><body>
<div id="hud"><a href="/">&larr; control panel</a> &nbsp; <span id="pos">-</span>
 &nbsp; zoom <span id="zl">1.0</span>x</div>
<canvas id="cv"></canvas>
<script>
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let meta = null, scale = 1, ox = 0, oy = 0;           // native px -> screen: (p - o) * scale
const tiles = new Map(), pois = [];
let pose = null, epoch = 0;
function resize(){ cv.width = innerWidth; cv.height = innerHeight; draw(); }
addEventListener('resize', resize);
function tileKey(z,x,y,e){ return z+'/'+x+'/'+y+'/'+e; }
function getTile(z,x,y){
  const k = tileKey(z,x,y,epoch);
  if (tiles.has(k)) return tiles.get(k);
  const im = new Image();
  im.onload = draw;
  im.src = `/map_tiles?z=${z}&x=${x}&y=${y}&e=${epoch}`;
  tiles.set(k, im);
  if (tiles.size > 600) { const first = tiles.keys().next().value; tiles.delete(first); }
  return im;
}
function draw(){
  if (!meta) return;
  ctx.fillStyle = '#7f7f7f'; ctx.fillRect(0, 0, cv.width, cv.height);
  // pyramid level whose pixels are closest below 1 screen px
  const l = Math.max(0, Math.min(meta.zmax, meta.zmax + Math.floor(Math.log2(scale)) + 1));
  const ls = 2 ** (meta.zmax - l);            // native px per level px
  const sp = scale * ls;                      // screen px per level px
  const t = meta.tile;
  const lw = Math.ceil(meta.width / ls), lh = Math.ceil(meta.height / ls);
  const x0 = Math.max(0, Math.floor(ox / ls / t)), y0 = Math.max(0, Math.floor(oy / ls / t));
  const x1 = Math.min(Math.ceil(lw / t) - 1, Math.floor((ox + cv.width / scale) / ls / t));
  const y1 = Math.min(Math.ceil(lh / t) - 1, Math.floor((oy + cv.height / scale) / ls / t));
  ctx.imageSmoothingEnabled = sp < 4;         // crisp pixels when deep-zoomed
  for (let ty = y0; ty <= y1; ty++) for (let tx = x0; tx <= x1; tx++){
    const im = getTile(l, tx, ty);
    if (!im.complete || !im.naturalWidth) continue;
    ctx.drawImage(im, (tx * t * ls - ox) * scale, (ty * t * ls - oy) * scale, t * sp, t * sp);
  }
  for (const p of pois){
    const sx = (p.pos_px[0] - ox) * scale, sy = (p.pos_px[1] - oy) * scale;
    ctx.fillStyle = '#f55'; ctx.beginPath(); ctx.arc(sx, sy, 5, 0, 7); ctx.fill();
    ctx.fillStyle = '#fff'; ctx.fillText(p.name, sx + 7, sy + 3);
  }
  if (pose){
    const sx = (pose.x - ox) * scale, sy = (pose.y - oy) * scale;
    ctx.strokeStyle = '#5f5'; ctx.fillStyle = '#5f5';
    ctx.beginPath(); ctx.arc(sx, sy, 6, 0, 7); ctx.fill();
    ctx.beginPath(); ctx.moveTo(sx, sy);
    ctx.lineTo((pose.ex - ox) * scale, (pose.ey - oy) * scale); ctx.stroke();
  }
  document.getElementById('zl').textContent = scale.toFixed(2);
}
let dragging = false, lx = 0, ly = 0;
cv.onpointerdown = e => { dragging = true; lx = e.clientX; ly = e.clientY; cv.setPointerCapture(e.pointerId); };
cv.onpointerup = () => dragging = false;
cv.onpointermove = e => {
  if (dragging){ ox -= (e.clientX - lx) / scale; oy -= (e.clientY - ly) / scale; lx = e.clientX; ly = e.clientY; draw(); }
  if (meta){
    const px = ox + e.clientX / scale, py = oy + e.clientY / scale;
    const mmx = (px - meta.center_px[0]) * meta.mm_per_px;
    const mmy = (meta.center_px[1] - py) * meta.mm_per_px;
    document.getElementById('pos').textContent =
      `px (${px.toFixed(0)}, ${py.toFixed(0)})  mm (${mmx.toFixed(0)}, ${mmy.toFixed(0)})`;
  }
};
cv.onwheel = e => {
  e.preventDefault();
  const f = e.deltaY < 0 ? 1.25 : 0.8;
  const px = ox + e.clientX / scale, py = oy + e.clientY / scale;
  scale = Math.max(0.05, Math.min(64, scale * f));
  ox = px - e.clientX / scale; oy = py - e.clientY / scale;
  draw();
};
async function refresh(){
  const r = await fetch('/get_points_of_interest'); const j = await r.json();
  pois.length = 0; for (const p of (j.points || [])) pois.push(p);
  draw();
}
const es = new EventSource('/points_stream');
es.onmessage = ev => { const d = JSON.parse(ev.data); if (d.pose) { pose = d.pose; draw(); } };
setInterval(() => { epoch++; draw(); }, 5000);   // live map refresh: re-fetch tiles
setInterval(refresh, 5000);
fetch('/map_tiles_meta').then(r => r.json()).then(m => {
  meta = m; resize();
  scale = Math.min(innerWidth / m.width, innerHeight / m.height) * 0.95;
  ox = -(innerWidth / scale - m.width) / 2; oy = -(innerHeight / scale - m.height) / 2;
  refresh();
});
</script></body></html>
"""


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        # --- helpers ------------------------------------------------------
        def _json(self, obj, code: int = 200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _bytes(self, data: bytes, mimetype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", mimetype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body_json(self):
            return json.loads(self._raw_body) if self._raw_body else {}

        def _safe_path(self, name: str) -> str | None:
            """Resolve a client-supplied filename under the work dir, or
            ``None`` when it escapes it.  Raw handlers pass ``../`` through,
            so every file route must containment-check before touching disk
            (the server is unauthenticated and binds 0.0.0.0).  ``name`` must
            already be percent-decoded by the route handler — decoding twice
            would mis-resolve legal filenames containing literal %XX."""
            root = os.path.realpath(state.work_dir)
            fp = os.path.realpath(os.path.join(root, name))
            if fp != root and not fp.startswith(root + os.sep):
                return None
            return fp

        # --- GET ------------------------------------------------------------
        def do_GET(self):
            url = urlparse(self.path)
            path, q = url.path, parse_qs(url.query)
            if path == "/":
                self._bytes(_INDEX_HTML.encode(), "text/html")
            elif path == "/points_stream":
                self._sse()
            elif path == "/video_feed":
                self._video_feed()
            elif path == "/map_image":
                self._bytes(state.map_png_bytes(), "image/png")
            elif path == "/map_viewer":
                self._bytes(_VIEWER_HTML.encode(), "text/html")
            elif path == "/map_tiles_meta":
                self._json(state.map_tiles_meta())
            elif path == "/map_tiles":
                try:
                    z = int((q.get("z") or ["0"])[0])
                    tx = int((q.get("x") or ["0"])[0])
                    ty = int((q.get("y") or ["0"])[0])
                except ValueError:
                    return self._json({"status": "error", "message": "bad tile coords"}, 400)
                if not (0 <= z <= 12 and 0 <= tx < 4096 and 0 <= ty < 4096):
                    return self._json({"status": "error", "message": "tile out of range"}, 400)
                self._bytes(state.map_tile_png(z, tx, ty), "image/png")
            elif path == "/icp_image":
                self._bytes(state.icp_view_png_bytes(), "image/png")
            elif path == "/camera_image":
                eye = int((q.get("eye") or ["0"])[0]) if (q.get("eye") or ["0"])[0] in ("0", "1") else 0
                jpeg = state.camera_frame_jpeg(eye)
                if jpeg is None:
                    return self._json({"status": "error", "message": "no camera frame yet"}, 404)
                self._bytes(jpeg, "image/jpeg")
            elif path == "/camera_feed":
                eye = int((q.get("eye") or ["0"])[0]) if (q.get("eye") or ["0"])[0] in ("0", "1") else 0
                self._camera_feed(eye)
            elif path == "/landmarks":
                self._json({"landmarks": state.landmark_markers()})
            elif path == "/save_map":
                name = (q.get("filename") or [None])[0]
                if not name:
                    return self._json({"status": "error", "message": "filename required"}, 400)
                base = os.path.splitext(unquote(name))[0]
                if base != os.path.basename(base) or self._safe_path(base) is None:
                    return self._json({"status": "error", "message": "invalid filename"}, 400)
                state.save_map(base)
                self._json({"status": "success", "message": f"map saved as '{base}'"})
            elif path == "/list_saved_files":
                files = [f for f in os.listdir(state.work_dir) if f.endswith(".png")]
                self._json({"files": files})
            elif path == "/get_points_of_interest":
                pts = [
                    {"id": i, "name": f"Point {i + 1}", "pos_px": state.world_to_px(p[0], p[1])}
                    for i, p in enumerate(state.points_of_interest)
                ]
                self._json({"points": pts})
            elif path == "/stop_stream":
                state.paused.set()
                self._json({"status": "success", "message": "Stream stopped"})
            elif path == "/resume_stream":
                state.paused.clear()
                self._json({"status": "success", "message": "Stream resumed"})
            elif path == "/save_frame":
                fname = f"capture_{int(time.time())}.png"
                with open(os.path.join(state.work_dir, fname), "wb") as f:
                    f.write(state.map_png_bytes())
                self._json({"status": "success", "filename": fname})
            elif path == "/capture_map":
                state.capture_requested = True
                self._json({"message": "capturing map image..."})
            elif path.startswith("/load_map/"):
                fname = unquote(path[len("/load_map/"):])
                fp = self._safe_path(fname)
                if fp is None or not os.path.exists(fp):
                    return self._json({"message": f"File {fname} not found"}, 404)
                try:
                    state.load_map(fp)
                except ValueError:
                    return self._json({"message": "unsupported file format"}, 400)
                self._json({"message": f"loaded map {fname}; switched to localization mode"})
            elif path == "/resume_mapping":
                state.resume_mapping()
                self._json({"status": "success", "message": "mapping mode resumed"})
            elif path.startswith("/get_map_points/"):
                base = unquote(path[len("/get_map_points/"):])
                npy = self._safe_path(base + ".npy")
                try:
                    if npy is None:
                        raise FileNotFoundError(base)
                    pts = np.load(npy).tolist()
                    if pts:
                        pts = pts[:-1]  # parity quirk: reference drops the last row (`mainn.py:533`)
                    self._json({"points": pts})
                except FileNotFoundError:
                    self._json({"points": []})
            elif path.startswith("/get_map_image/"):
                fname = unquote(path[len("/get_map_image/"):])
                fp = self._safe_path(fname)
                if fp is None or not os.path.exists(fp):
                    return self._bytes(b"File not found", "text/plain", 404)
                with open(fp, "rb") as f:
                    self._bytes(f.read(), "image/png")
            else:
                self._json({"error": "not found"}, 404)

        # --- POST -----------------------------------------------------------
        def do_POST(self):
            path = urlparse(self.path).path
            # read the body before any route: a socket closed with bytes unread
            # is reset, and the client can lose the answer
            self._raw_body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
            if path == "/add_point":
                pos = state.add_poi()
                self._json({"status": "success", "message": "point added", "new_point": pos})
            elif path == "/set_active_target":
                data = self._body_json()
                pid = data.get("id")
                if pid is None:
                    state.set_target(None)
                    return self._json({"status": "success", "message": "target cleared"})
                try:
                    pid = int(pid)
                except (TypeError, ValueError):
                    return self._json({"status": "error", "message": "invalid point id"}, 400)
                if state.set_target(pid):
                    self._json({"status": "success", "message": f"target set to point {pid + 1}"})
                else:
                    self._json({"status": "error", "message": "point id does not exist"}, 400)
            elif path == "/toggle_visibility":
                data = self._body_json()
                state.show_map = data.get("map", state.show_map)
                state.show_icp = data.get("icp", state.show_icp)
                self._json({"status": "success", "show_map": state.show_map, "show_icp": state.show_icp})
            elif path == "/load_map_for_imshow":
                data = self._body_json()
                fname = data.get("filename")
                fp = self._safe_path(fname) if fname else None
                if fp is None or not os.path.exists(fp):
                    return self._json({"status": "error", "message": "file does not exist"}, 404)
                self._json({"status": "success", "message": f"displaying map {fname}"})
            else:
                self._json({"error": "not found"}, 404)

        # --- streams ----------------------------------------------------------
        def _sse(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                while not state.stopped.is_set():
                    payload = state.stream_payload()
                    if payload:
                        self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
                        self.wfile.flush()
                    time.sleep(0.1)  # `mainn.py:639`
            except (BrokenPipeError, ConnectionResetError):
                pass

        def _camera_feed(self, eye: int):
            """MJPEG stream of the latest annotated stereo frame for one eye —
            the reference's live detection display (`mainn.py:771-780`), made
            a browser surface.  Pushes only when the camera worker has
            produced a NEW frame (seq counter), at most ~10 Hz like the
            reference's camera loop (`mainn.py:145-176`)."""
            self.send_response(200)
            self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
            self.end_headers()
            last_seq = -1
            try:
                while not state.stopped.is_set():
                    with state.lock:
                        seq = state.camera_frame_seq
                        jpeg = state.last_annotated_jpeg[eye] if seq != last_seq else None
                    if jpeg is not None:
                        last_seq = seq
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\nContent-Length: "
                            + str(len(jpeg)).encode() + b"\r\n\r\n" + jpeg + b"\r\n"
                        )
                        self.wfile.flush()
                    time.sleep(0.1)
            except (BrokenPipeError, ConnectionResetError):
                pass

        def _video_feed(self):
            self.send_response(200)
            self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
            self.end_headers()
            try:
                while not state.stopped.is_set():
                    with state.lock:
                        pts = list(state.last_scan_points_px)
                    body = json.dumps({"points": pts}).encode()
                    self.wfile.write(b"--frame\r\nContent-Type: application/json\r\n\r\n" + body + b"\r\n")
                    self.wfile.flush()
                    time.sleep(0.05)  # `mainn.py:581`
            except (BrokenPipeError, ConnectionResetError):
                pass

    return Handler


def make_server(state: ServerState, host: str = "0.0.0.0", port: int = 5000) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(state))


def serve(state: ServerState, host: str = "0.0.0.0", port: int = 5000) -> None:
    server = make_server(state, host, port)
    print(f"serving on http://{host}:{port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        state.stopped.set()
        server.shutdown()
