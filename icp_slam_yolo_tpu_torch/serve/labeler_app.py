"""Web labeler: browser UI over `data/labeler.LabelSession`; the counterpart
of the JAX package's ``serve/labeler_app.py``, on the standard library's
HTTP server, with the port's image codecs (`utils.images`) in place of PIL.

The reference's OpenCV-window labelers (mouse polygon drawing, class
sidebar, YOLO-assist keys) as an HTTP surface:

  GET  /label                 canvas UI
  GET  /label/state           {index, total, image_name, classes, polygons}
  GET  /label/image           current image bytes
  POST /label/polygon         {points, label} -> add
  POST /label/polygon/<i>     {label?|rotate?|move?|delete?} -> edit
  POST /label/nav             {dir: +1/-1} (refused while any polygon unlabeled)
  POST /label/save            write the three label formats + review CSV
  POST /label/auto            detector assist ('s' key) when a `Detector` is attached
  POST /label/mask/start      {width?, height?} begin a paint mask (defaults to
                              the current image size)
  POST /label/mask/paint      {points: [[x,y],...], brush, shape, erase} apply
                              a brush stroke (one call per drag segment batch)
  GET  /label/mask            current mask as PNG (white = painted)
  POST /label/mask/commit     {label?, min_area?} -> contours -> polygons
                              (the reference's brush draw/erase -> findContours
                              flow, `labels_segmentation_ver_2.py`)
  GET  /label/coords          click-to-print pixel coordinates page
  POST /label/click           {x, y} -> echoed to the server console as
                              "[x, y]," (`labels_segmentation/lay_diem.py` parity)
"""

from __future__ import annotations

import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

import numpy as np

from icp_slam_yolo_tpu_torch.utils.images import encode_png, image_size

_LABEL_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>labeler</title>
<style>body{font-family:system-ui;background:#111;color:#eee;margin:1rem}
canvas{border:1px solid #555;cursor:crosshair}button{margin:.15rem}</style></head>
<body>
<h3 id="title">labeler</h3>
<div>
<button onclick="nav(-1)">&laquo; prev</button>
<button onclick="nav(1)">next &raquo;</button>
<button onclick="finishPoly()">finish polygon</button>
<button onclick="save()">save labels</button>
<button onclick="auto()">auto-label</button>
<span id="classes"></span>
</div>
<div>
<button id="brushBtn" onclick="toggleBrush()">brush: off</button>
<label>size <input id="brushSize" type="range" min="4" max="60" value="16"></label>
<select id="brushShape"><option>circle</option><option>square</option></select>
<label><input id="erase" type="checkbox"> erase</label>
<select id="maskClass"></select>
<button onclick="commitMask()">mask &rarr; polygons</button>
</div>
<canvas id="cv"></canvas>
<script>
let state=null, draft=[], img=new Image();
const cv=document.getElementById('cv'), ctx=cv.getContext('2d');
// --- paintbrush mode (reference: labels_segmentation_ver_2.py brush flow) --
let brush=false, painting=false, strokeBuf=[];
function toggleBrush(){
  brush=!brush;
  document.getElementById('brushBtn').textContent='brush: '+(brush?'on':'off');
  if(brush) fetch('/label/mask/start',{method:'POST',body:'{}'});
  draw();
}
function brushParams(){
  return {brush:+document.getElementById('brushSize').value,
          shape:document.getElementById('brushShape').value,
          erase:document.getElementById('erase').checked};
}
async function flushStroke(){
  if(!strokeBuf.length) return;
  const pts=strokeBuf; strokeBuf=[];
  await fetch('/label/mask/paint',{method:'POST',
    body:JSON.stringify({points:pts,...brushParams()})});
}
function paintLocal(x,y){
  const p=brushParams(), r=p.brush/2;
  ctx.fillStyle=p.erase?'rgba(0,0,255,.5)':'rgba(255,0,0,.5)';
  if(p.shape==='circle'){ctx.beginPath();ctx.arc(x,y,r,0,7);ctx.fill();}
  else ctx.fillRect(x-r,y-r,p.brush,p.brush);
}
cv.addEventListener('pointerdown',e=>{
  if(!brush) return; painting=true; cv.setPointerCapture(e.pointerId);
  const r=cv.getBoundingClientRect();
  const x=e.clientX-r.left, y=e.clientY-r.top;
  strokeBuf.push([x,y]); paintLocal(x,y);
});
cv.addEventListener('pointermove',e=>{
  if(!brush||!painting) return;
  const r=cv.getBoundingClientRect();
  const x=e.clientX-r.left, y=e.clientY-r.top;
  strokeBuf.push([x,y]); paintLocal(x,y);
  if(strokeBuf.length>=24) flushStroke();
});
cv.addEventListener('pointerup',()=>{ if(painting){painting=false; flushStroke();} });
async function commitMask(){
  await flushStroke();
  const label=document.getElementById('maskClass').value||null;
  const r=await (await fetch('/label/mask/commit',
    {method:'POST',body:JSON.stringify({label})})).json();
  if(r.error) alert(r.error);
  else { alert('added '+r.added+' polygons'); if(brush) toggleBrush(); refresh(); }
}
async function refresh(){
  state = await (await fetch('/label/state')).json();
  document.getElementById('title').textContent =
    `${state.image_name} (${state.index+1}/${state.total})`;
  const span=document.getElementById('classes'); span.innerHTML='';
  const sel=document.getElementById('maskClass'); sel.innerHTML='';
  for(const c of state.classes){
    const b=document.createElement('button'); b.textContent='label: '+c;
    b.onclick=()=>labelLast(c); span.appendChild(b);
    const o=document.createElement('option'); o.textContent=c; sel.appendChild(o);
  }
  img = new Image();
  img.onload = ()=>{cv.width=img.width; cv.height=img.height; draw();};
  img.src = '/label/image?i=' + state.index + '&t=' + Date.now();
}
function draw(){
  ctx.drawImage(img,0,0);
  for(const p of state.polygons){
    ctx.strokeStyle = p.label==='none' ? '#f44' : '#4f4';
    ctx.beginPath();
    p.points.forEach(([x,y],i)=> i?ctx.lineTo(x,y):ctx.moveTo(x,y));
    ctx.closePath(); ctx.stroke();
    ctx.fillStyle='#ff0';
    ctx.fillText(p.label, p.points[0][0], p.points[0][1]-4);
  }
  ctx.strokeStyle='#08f'; ctx.beginPath();
  draft.forEach(([x,y],i)=> i?ctx.lineTo(x,y):ctx.moveTo(x,y)); ctx.stroke();
}
cv.onclick=(e)=>{
  if(brush) return;   // brush strokes handle their own pointer events
  const r=cv.getBoundingClientRect();
  draft.push([e.clientX-r.left, e.clientY-r.top]); draw();
};
async function finishPoly(){
  if(draft.length<3) return;
  await fetch('/label/polygon',{method:'POST',body:JSON.stringify({points:draft})});
  draft=[]; refresh();
}
async function labelLast(c){
  if(!state.polygons.length) return;
  await fetch('/label/polygon/'+(state.polygons.length-1),
    {method:'POST',body:JSON.stringify({label:c})});
  refresh();
}
async function nav(d){
  const r=await (await fetch('/label/nav',{method:'POST',body:JSON.stringify({dir:d})})).json();
  if(!r.ok) alert('label every polygon first'); else refresh();
}
async function save(){
  const r=await (await fetch('/label/save',{method:'POST'})).json();
  alert('saved '+r.saved+' labels');
}
async function auto(){
  const r=await (await fetch('/label/auto',{method:'POST'})).json();
  if(r.error) alert(r.error); else refresh();
}
refresh();
</script></body></html>
"""

# click-to-print-coords page (`lay_diem.py` parity: each click drops a red dot
# and prints "[x, y]," — here both into the page log and the server console)
_COORDS_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>pick coords</title>
<style>body{font-family:system-ui;background:#111;color:#eee;margin:1rem}
canvas{border:1px solid #555;cursor:crosshair}pre{background:#222;padding:.5rem}</style></head>
<body><h3>click to print pixel coordinates (ESC reference: lay_diem.py)</h3>
<canvas id="cv"></canvas><pre id="log"></pre>
<script>
const cv=document.getElementById('cv'), ctx=cv.getContext('2d'),
      log=document.getElementById('log'), img=new Image();
img.onload=()=>{cv.width=img.width; cv.height=img.height; ctx.drawImage(img,0,0);};
img.src='/label/image?t='+Date.now();
cv.onclick=async(e)=>{
  const r=cv.getBoundingClientRect();
  const x=Math.round(e.clientX-r.left), y=Math.round(e.clientY-r.top);
  ctx.fillStyle='#f00'; ctx.beginPath(); ctx.arc(x,y,5,0,7); ctx.fill();
  log.textContent += `[${x}, ${y}],\\n`;
  await fetch('/label/click',{method:'POST',body:JSON.stringify({x,y})});
};
</script></body></html>
"""


def make_labeler_handler(session, detector=None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            return json.loads(self._raw_body) if self._raw_body else {}

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/label":
                body = _LABEL_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/label/state":
                self._json(
                    {
                        "index": session.index,
                        "total": len(session.images),
                        "image_name": os.path.basename(session.images[session.index]),
                        "classes": session.classes,
                        "polygons": [
                            {"points": p.points, "label": p.label} for p in session.current
                        ],
                    }
                )
            elif path == "/label/coords":
                body = _COORDS_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/label/mask":
                m = getattr(session, "_mask", None)
                if m is None:
                    return self._json({"error": "no active mask"}, 404)
                data = encode_png((np.asarray(m) * 255).astype(np.uint8))
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path.startswith("/label/image"):
                with open(session.images[session.index], "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            path = urlparse(self.path).path
            # read the body before any route: a socket closed with bytes unread
            # is reset, and the client can lose the answer
            self._raw_body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
            if path == "/label/polygon":
                data = self._body()
                i = session.add_polygon(data["points"], data.get("label", "none"))
                self._json({"ok": True, "index": i})
            elif path.startswith("/label/polygon/"):
                i = int(path.rsplit("/", 1)[1])
                data = self._body()
                if data.get("delete"):
                    session.delete_polygon(i)
                if "label" in data:
                    session.set_label(i, data["label"])
                if "rotate" in data:
                    session.current[i].rotate(float(data["rotate"]))
                if "move" in data:
                    session.current[i].move(*data["move"])
                self._json({"ok": True})
            elif path == "/label/click":
                data = self._body()
                x, y = int(data.get("x", 0)), int(data.get("y", 0))
                print(f"[{x}, {y}],", flush=True)  # lay_diem.py console format
                self._json({"ok": True, "x": x, "y": y})
            elif path == "/label/nav":
                d = int(self._body().get("dir", 1))
                ok = session.next_image() if d > 0 else session.prev_image()
                self._json({"ok": ok})
            elif path == "/label/save":
                self._json({"ok": True, "saved": session.save_labels()})
            elif path == "/label/mask/start":
                data = self._body()
                if "width" in data and "height" in data:
                    w, h = int(data["width"]), int(data["height"])
                else:
                    w, h = image_size(session.images[session.index])
                session.new_mask(w, h)
                self._json({"ok": True, "width": w, "height": h})
            elif path == "/label/mask/paint":
                if getattr(session, "_mask", None) is None:
                    return self._json({"error": "no active mask"}, 400)
                data = self._body()
                brush = int(data.get("brush", 10))
                shape = data.get("shape", "square")
                erase = bool(data.get("erase", False))
                pts = data.get("points") or []
                for x, y in pts:
                    session.paint(int(x), int(y), brush, shape, erase)
                self._json({"ok": True, "applied": len(pts)})
            elif path == "/label/mask/commit":
                if getattr(session, "_mask", None) is None:
                    return self._json({"error": "no active mask"}, 400)
                data = self._body()
                n = session.mask_to_polygons(
                    label=data.get("label"), min_area=int(data.get("min_area", 20))
                )
                session._mask = None  # one commit per paint session
                self._json({"ok": True, "added": n})
            elif path == "/label/auto":
                if detector is None:
                    self._json({"error": "no detector attached"}, 400)
                else:
                    n = session.auto_label(detector)
                    self._json({"ok": True, "added": n})
            else:
                self._json({"error": "not found"}, 404)

    return Handler


def serve_labeler(session, detector=None, host: str = "0.0.0.0", port: int = 5001):
    server = ThreadingHTTPServer((host, port), make_labeler_handler(session, detector))
    print(f"labeler on http://{host}:{port}/label")
    server.serve_forever()
