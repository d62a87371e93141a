"""The port's labeling session (`data/labeler.py`) and web labeler
(`serve/labeler_app.py`) against the JAX package's, driven the same way
over one directory of JPEG frames: the state file and the label files
byte-equal; `auto_label` and `match_box` through the v8 checkpoint (64 px,
float32; the JAX `Detector` and the port's) within 0.05 px; the segment
auto-label; the paintbrush; every HTTP route's answer equal."""

import io
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import icp_slam_yolo_tpu_torch as port
from icp_slam_yolo_tpu.data import labeler as jlab
from icp_slam_yolo_tpu.models import detect as jdetect
from icp_slam_yolo_tpu.serve import labeler_app as japp
from icp_slam_yolo_tpu_torch.data import labeler as tlab
from icp_slam_yolo_tpu_torch.serve import labeler_app as tapp

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
TOL_PX = 0.05


@pytest.fixture()
def image_dir(tmp_path):
    """Four pallet frames: three JPEG (4:2:0, 4:2:2 progressive, gray) and
    one PNG, sizes that cut MCUs."""
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(5)
    frames = [chip_smoke.pallet_image(rng, 240, 320)[0] for _ in range(4)]
    Image.fromarray(frames[0]).save(d / "a.jpg", quality=90)
    Image.fromarray(frames[1][:237, :315]).save(d / "b.jpg", quality=80, subsampling=1, progressive=True)
    Image.fromarray(frames[2]).convert("L").save(d / "c.jpeg", quality=85)
    Image.fromarray(frames[3]).save(d / "d.png")
    return str(d)


def _sessions(image_dir, tmp_path, **kw):
    return (jlab.LabelSession(image_dir, str(tmp_path / "j"), **kw),
            tlab.LabelSession(image_dir, str(tmp_path / "t"), **kw))


def _tree(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


class FakeDetector:
    def __call__(self, img):
        return {"boxes": np.array([[10.0, 10, 30, 30], [40, 10, 60, 30]], np.float32),
                "scores": np.array([0.9, 0.8]), "classes": np.array([0, 0])}


def test_polygon_ops_equal_jax():
    for op in (lambda p: p.rotate(90), lambda p: p.rotate(-5), lambda p: p.move(5, -5)):
        jp = jlab.Polygon([[0.0, 0], [10, 0], [10, 10], [0, 10]], "pallet")
        tp = tlab.Polygon([[0.0, 0], [10, 0], [10, 10], [0, 10]], "pallet")
        op(jp)
        op(tp)
        assert tp.points == jp.points and tp.bbox() == jp.bbox()
        np.testing.assert_array_equal(tp.center(), jp.center())


def test_session_flow_state_and_labels_byte_equal(image_dir, tmp_path):
    """The same edits in both packages: navigation blocked while a polygon
    is unlabeled, copy/paste, rotate/move, delete, the fake detector's
    auto-label and match, saving on every image (the sizes come from
    `image_size`: JPEG frame headers and a PNG IHDR), and a resumed
    session."""
    j, t = _sessions(image_dir, tmp_path, classes=["pallet", "box"])
    assert t.images == j.images and len(t.images) == 4
    for s in (j, t):
        s.add_polygon([[1, 1], [20, 1], [20, 20], [1, 20]])
        assert not s.can_navigate() and not s.next_image()
        s.set_label(0, "pallet")
        s.add_polygon([[30, 5], [50, 8], [45, 30]], "box")
        s.current[1].rotate(5)
        s.current[1].move(2.5, -1)
        assert s.next_image() and s.index == 1
        s.prev_image()
        s.copy_polygon(1)
        s.next_image()
        assert s.paste_polygon() == 0
        assert s.auto_label(FakeDetector(), default_label="box") == 2
        assert s.match_box([38, 8, 62, 32], FakeDetector()) == 3
        assert s.match_box([0, 40, 5, 45], FakeDetector()) is None
        s.delete_polygon(1)
        for _ in range(4):
            s.save_labels()
            s.next_image()
        s.add_polygon([[3, 3], [9, 3], [9, 9]])
        s.save_state()
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    rj, rt = _sessions(image_dir, tmp_path)
    assert rt.index == rj.index and {k: [p.points for p in v] for k, v in rt.annotations.items()} == {
        k: [p.points for p in v] for k, v in rj.annotations.items()}


def _detectors(conf=1e-6):
    path = os.path.join(REPO, chip_smoke.DETECT_CHECKPOINT)
    kw = dict(conf_threshold=conf, img_size=SIZE)
    return (jdetect.detector_from_checkpoint(path, compute_dtype=jnp.float32, **kw),
            port.detector_from_checkpoint(path, compute_dtype=torch.float32, pallas_convs=True, device="cpu", **kw))


def _assert_polygons_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.label == w.label
        np.testing.assert_allclose(g.points, w.points, atol=TOL_PX)


def test_auto_label_and_match_box_through_the_detectors(image_dir, tmp_path):
    """The v8 checkpoint at 64 px on every frame (JPEG to PIL's pixels):
    the port's fused path on the CPU against the JAX package's detector."""
    jdet, tdet = _detectors()
    j, t = _sessions(image_dir, tmp_path)
    for i in range(len(j.images)):
        j.index = t.index = i
        assert t.auto_label(tdet) == j.auto_label(jdet) > 0
        box = t.current[0].bbox()
        assert t.match_box(box, tdet) == j.match_box(box, jdet) is not None
        _assert_polygons_close(t.current, j.current)


def test_auto_label_segment_equals_jax(image_dir, tmp_path):
    """The segment checkpoint's forward at 64 px (the frame resized by PIL's
    bicubic filter on both sides), NMS, masks and polygons."""
    path = os.path.join(REPO, chip_smoke.SEGMENT_CHECKPOINT)
    jdet = jdetect.detector_from_checkpoint(path, compute_dtype=jnp.float32, img_size=SIZE)
    variables = {"params": jdet.params, "batch_stats": jdet.batch_stats}
    jfwd = jax.jit(lambda x: jdet.model.apply(variables, x, train=False))
    tdet = port.detector_from_checkpoint(path, compute_dtype=torch.float32, pallas_convs=True, device="cpu",
                                         img_size=SIZE)
    j, t = _sessions(image_dir, tmp_path)
    assert t.auto_label_segment(tdet.model, SIZE, conf_threshold=0.99, device="cpu") == 0 == j.auto_label_segment(
        jfwd, SIZE, conf_threshold=0.99)
    total = 0
    for i in range(len(j.images)):
        j.index = t.index = i
        n = t.auto_label_segment(tdet.model, SIZE, conf_threshold=1e-9, max_instances=4, device="cpu")
        assert n == j.auto_label_segment(jfwd, SIZE, conf_threshold=1e-9, max_instances=4)
        total += n
        if n:
            _assert_polygons_close(t.current, j.current)
    assert total > 0


def test_paintbrush_and_mask_to_polygons_equal_jax(image_dir, tmp_path):
    j, t = _sessions(image_dir, tmp_path)
    for s in (j, t):
        s.new_mask(320, 240)
        for x in range(12, 60, 3):
            s.paint(x, 40, brush_size=8)
        for x in range(100, 140, 4):
            s.paint(x, 120, brush_size=12, shape="circle")
        s.paint(30, 40, brush_size=4, erase=True)
        s.paint(200, 200, brush_size=2)  # a speck under min_area
        s.paint(318, 238, brush_size=9, shape="circle")  # clipped at the corner
    np.testing.assert_array_equal(t._mask, j._mask)
    assert t.mask_to_polygons(label="pallet") == j.mask_to_polygons(label="pallet") >= 2
    assert t.mask_to_polygons(min_area=1) == j.mask_to_polygons(min_area=1)
    assert [(p.points, p.label) for p in t.current] == [(p.points, p.label) for p in j.current]


def _serve(module, session, detector):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), module.make_labeler_handler(session, detector))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _call(base, path, payload=None, post=True):
    data = json.dumps(payload or {}).encode() if post else None
    try:
        with urllib.request.urlopen(urllib.request.Request(base + path, data=data), timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


ROUTES = [
    ("GET", "/label/state", None), ("GET", "/label", None), ("GET", "/label/coords", None),
    ("GET", "/label/image?i=0", None), ("GET", "/nothing", None), ("POST", "/nothing", {}),
    ("POST", "/label/mask/paint", {"points": [[1, 1]]}), ("POST", "/label/mask/commit", {}),
    ("GET", "/label/mask", None), ("POST", "/label/mask/start", {}),
    ("POST", "/label/mask/paint", {"points": [[x, y] for x in range(16, 49, 4) for y in range(12, 37, 4)],
                                   "brush": 10, "shape": "circle"}),
    ("POST", "/label/mask/paint", {"points": [[32, 24]], "brush": 6, "erase": True}),
    ("GET", "/label/mask", None), ("POST", "/label/mask/commit", {"label": "pallet"}),
    ("POST", "/label/mask/start", {"width": 64, "height": 48}), ("GET", "/label/mask", None),
    ("POST", "/label/nav", {"dir": 1}), ("POST", "/label/polygon", {"points": [[1, 1], [9, 1], [9, 9]]}),
    ("POST", "/label/nav", {"dir": 1}), ("POST", "/label/polygon/0", {"label": "box", "rotate": 10, "move": [1, 2]}),
    ("GET", "/label/state", None), ("POST", "/label/polygon/0", {"delete": True}), ("POST", "/label/nav", {"dir": -1}),
    ("POST", "/label/auto", {}), ("POST", "/label/save", {}), ("POST", "/label/click", {"x": 17, "y": 42}),
    ("GET", "/label/state", None),
]


def test_every_route_answers_as_jax(image_dir, tmp_path, capsys):
    """The routes in one order on both servers (the fake detector attached):
    status, content type and JSON equal; the mask PNG decoded equal; the
    image bytes and HTML pages the same bytes; then the saved trees
    byte-equal.  Without a detector ``/label/auto`` is a 400 on both."""
    j, t = _sessions(image_dir, tmp_path)
    (js, jb), (ts, tb) = _serve(japp, j, FakeDetector()), _serve(tapp, t, FakeDetector())
    try:
        for method, path, payload in ROUTES:
            got = _call(tb, path, payload, method == "POST")
            want = _call(jb, path, payload, method == "POST")
            assert got[:2] == want[:2], (method, path)
            if got[1] == "application/json":
                assert json.loads(got[2]) == json.loads(want[2]), (method, path)
            elif got[1] == "image/png":
                assert np.array_equal(np.asarray(Image.open(io.BytesIO(got[2]))),
                                      np.asarray(Image.open(io.BytesIO(want[2])))), path
            else:
                assert got[2] == want[2], (method, path)
    finally:
        js.shutdown()
        ts.shutdown()
    assert capsys.readouterr().out.count("[17, 42],") == 2
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    (js, jb), (ts, tb) = _serve(japp, j, None), _serve(tapp, t, None)
    try:
        got, want = _call(tb, "/label/auto"), _call(jb, "/label/auto")
        assert got[0] == want[0] == 400 and json.loads(got[2]) == json.loads(want[2])
    finally:
        js.shutdown()
        ts.shutdown()
