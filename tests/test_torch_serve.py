"""The port's server (`serve/state.py`, `serve/app.py`) against the JAX
package's, side by side on the same seeded synthetic scans, on the CPU.

Configuration: `test_torch_slam._configs` (the offline slice cut to a 12 m
map and 2048 map slots; the JAX side on its fused Pallas paths in interpret
mode).  Tolerances: accept flags equal; poses, POIs and distances 2 mm /
2e-3 rad (`test_torch_slam._compare`'s); pixel payloads within 1 px for the
pose and 2 px for scan points (a 2 mm / 2e-3 rad pose gap moves a point 10 m
away by 22 mm, under 2 px of 12 mm); RMSE strings within 0.1 mm; the map
PNG's gray levels equal on at least 99.5 % of cells, a tile's within 1
level on 99.5 % (the port downscales with its own triangle filter, within
1 level of PIL's bilinear resize that the JAX server uses); camera data within
0.1 (they are rounded to 0.1 mm and 0.01 degree); JSON bodies and status
codes of the HTTP routes equal."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from icp_slam_yolo_tpu.acquisition import camera as jcamera
from icp_slam_yolo_tpu.serve import app as japp
from icp_slam_yolo_tpu.serve import state as jstate
from icp_slam_yolo_tpu_torch.acquisition import camera as tcamera
from icp_slam_yolo_tpu_torch.serve import app as tapp
from icp_slam_yolo_tpu_torch.serve import state as tstate
from icp_slam_yolo_tpu_torch.utils.images import decode_png
from test_fused_serving import FakePoseStereoDetector, FakeStereoDetector
from test_torch_slam import ANG_RAD, POS_MM, _configs

torch.set_num_threads(2)
N_SCANS = 8


@pytest.fixture(scope="module")
def scans():
    padded, _ = chip_smoke.padded_sequence(N_SCANS + 4, 11, 512)
    return padded


def _pair(tmp_path):
    jcfg, tcfg = _configs()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    return (jstate.ServerState(jcfg, work_dir=str(tmp_path / "j")),
            tstate.ServerState(tcfg, work_dir=str(tmp_path / "t"), device="cpu"))


def _same_payload(t: dict, j: dict):
    assert set(t) == set(j)
    for k in ("x", "y", "ex", "ey"):
        assert abs(t["pose"][k] - j["pose"][k]) <= 1, (t["pose"], j["pose"])
    if "points" in j:
        tp, jp = np.asarray(t["points"]), np.asarray(j["points"])
        assert tp.shape == jp.shape and np.abs(tp - jp).max() <= 2
    if "distance" in j:
        assert abs(float(t["distance"]) - float(j["distance"])) <= 2 * POS_MM
    if "rmse" in j:
        assert abs(float(t["rmse"]) - float(j["rmse"])) <= 0.1


def _map_png_agrees(t_bytes: bytes, j_bytes: bytes):
    t = decode_png(t_bytes)
    j = np.asarray(Image.open(io.BytesIO(j_bytes)))
    assert t.shape == j.shape and t.dtype == np.uint8
    assert (t == j).mean() >= 0.995, (t != j).mean()


def test_server_state_matches_jax(tmp_path, scans):
    """Scans, POIs, targets, the trigger, stream payloads, tiles' metadata
    and the map PNG, scan by scan."""
    js, ts = _pair(tmp_path)
    assert ts.map_tiles_meta() == js.map_tiles_meta()
    _same_payload(ts.stream_payload(), js.stream_payload())
    distances = []
    for k in range(N_SCANS):
        jo, to = js.feed_scan(scans[k]), ts.feed_scan(scans[k])
        assert to["accepted"] == bool(jo["accepted"])
        dp = np.abs(to["pose"] - np.asarray(jo["pose"]))
        assert dp[:2].max() <= POS_MM and dp[2] <= ANG_RAD, dp
        if k == 2:
            pj, pt = js.add_poi(), ts.add_poi()
            assert np.abs(np.subtract(pt, pj)).max() <= POS_MM
            assert js.set_target(0) and ts.set_target(0)
            assert not js.set_target(5) and not ts.set_target(5)
            assert js.set_target(0) and ts.set_target(0)
            js._update_target_distance()
            ts._update_target_distance()
            assert ts.camera_trigger and js.camera_trigger
        _same_payload(ts.stream_payload(), js.stream_payload())
        if ts.distance_to_target is not None:
            assert abs(ts.distance_to_target - js.distance_to_target) <= 2 * POS_MM
            assert ts.camera_trigger == js.camera_trigger
            distances.append(ts.distance_to_target)
    assert distances[0] < 1.0 and distances[-1] > 500.0  # set at the robot, then left behind
    assert ts.points_of_interest == json.load(open(ts.poi_path))
    _map_png_agrees(ts.map_png_bytes(), js.map_png_bytes())
    meta = ts.map_tiles_meta()
    for z, x, y in ((meta["zmax"], 1, 1), (meta["zmax"] - 1, 0, 1), (0, 0, 0)):
        t = decode_png(ts.map_tile_png(z, x, y)).astype(int)
        j = np.asarray(Image.open(io.BytesIO(js.map_tile_png(z, x, y)))).astype(int)
        assert t.shape == j.shape == (256, 256)
        assert (np.abs(t - j) <= 1).mean() >= 0.995, (z, x, y)


@pytest.mark.parametrize("kind", ["png", "pcd"])
def test_saved_maps_load_across_servers(kind, tmp_path, scans):
    """A map saved by either server loads into the other and switches it to
    localization; the two then track the next scans alike.  So does a JPEG
    of the map, which both servers read."""
    js, ts = _pair(tmp_path)
    for k in range(N_SCANS):
        js.feed_scan(scans[k])
        ts.feed_scan(scans[k])
    if kind == "png":
        js.save_map("jmap")
        ts.save_map("tmap")
        paths = {"j": str(tmp_path / "j" / "jmap.png"), "t": str(tmp_path / "t" / "tmap.png")}
    else:
        js.engine.save_pcd(str(tmp_path / "j" / "jmap.pcd"))
        ts.engine.save_pcd(str(tmp_path / "t" / "tmap.pcd"))
        paths = {"j": str(tmp_path / "j" / "jmap.pcd"), "t": str(tmp_path / "t" / "tmap.pcd")}
    for source in ("j", "t"):  # each loads the other's file into a fresh server
        jl, tl = _pair(tmp_path / source)
        other = paths["t" if source == "j" else "j"]
        jl.load_map(other)
        tl.load_map(other)
        assert jl.update_mode == tl.update_mode == 0
        assert tl.engine.cfg.localization_only and jl.engine.cfg.localization_only
        np.testing.assert_array_equal(tl.engine.map_points(), np.asarray(jl.engine.map_points()))
        np.testing.assert_array_equal(tl.engine.occupancy(), np.asarray(jl.engine.occupancy()))
        for k in range(N_SCANS, N_SCANS + 3):
            jo, to = jl.feed_scan(scans[k]), tl.feed_scan(scans[k])
            assert to["accepted"] == bool(jo["accepted"])
            dp = np.abs(to["pose"] - np.asarray(jo["pose"]))
            assert dp[:2].max() <= POS_MM and dp[2] <= ANG_RAD, dp
        np.testing.assert_array_equal(tl.engine.map_points(), np.asarray(jl.engine.map_points()))
        tl.resume_mapping()
        assert tl.update_mode == 1 and not tl.engine.cfg.localization_only
    # a JPEG map (RGB, so `convert("L")`'s luma runs on both sides): the same
    # occupancy and point map, the same tracking; "png" keeps the point dump
    # beside it, "pcd" leaves the occupied cells' corners to stand for it
    ts.save_map("forjpg")
    jpg = tmp_path / "jpg_map" / "map.jpg"
    jpg.parent.mkdir()
    Image.open(tmp_path / "t" / "forjpg.png").convert("RGB").save(jpg, quality=90)
    if kind == "png":
        (jpg.parent / "map.npy").write_bytes((tmp_path / "t" / "forjpg.npy").read_bytes())
    (tmp_path / "jpg").mkdir()
    jl, tl = _pair(tmp_path / "jpg")
    jl.load_map(str(jpg))
    tl.load_map(str(jpg))
    assert jl.update_mode == tl.update_mode == 0 and tl.engine.cfg.localization_only
    np.testing.assert_array_equal(tl.engine.occupancy(), np.asarray(jl.engine.occupancy()))
    np.testing.assert_array_equal(tl.engine.map_points(), np.asarray(jl.engine.map_points()))
    for k in range(N_SCANS, N_SCANS + 3):
        jo, to = jl.feed_scan(scans[k]), tl.feed_scan(scans[k])
        assert to["accepted"] == bool(jo["accepted"])
        dp = np.abs(to["pose"] - np.asarray(jo["pose"]))
        assert dp[:2].max() <= POS_MM and dp[2] <= ANG_RAD, dp
    with pytest.raises(ValueError, match="unsupported map format"):
        tl.load_map(str(tmp_path / "t" / "map.gif"))


def _serve(state):
    srv = (tapp if isinstance(state, tstate.ServerState) else japp).make_server(state, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _request(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


GETS = ["/", "/map_image", "/map_viewer", "/map_tiles_meta", "/map_tiles?z=1&x=0&y=0", "/map_tiles?z=x",
        "/map_tiles?z=99", "/icp_image", "/camera_image?eye=0", "/landmarks", "/save_map",
        "/save_map?filename=saved.png", "/save_map?filename=../escape.png", "/save_map?filename=a/b.png",
        "/list_saved_files", "/get_points_of_interest", "/stop_stream", "/resume_stream", "/capture_map",
        "/load_map/..%2F..%2Fetc%2Fpasswd", "/load_map/../outside.png", "/load_map/missing.png",
        "/load_map/saved.png", "/resume_mapping", "/get_map_points/saved", "/get_map_points/..%2Fsaved",
        "/get_map_points/nothing", "/get_map_image/../outside.png", "/get_map_image/..%2Foutside.png",
        "/get_map_image/saved.png", "/save_frame", "/nowhere"]
POSTS = [("/add_point", {}), ("/set_active_target", {"id": 0}), ("/set_active_target", {"id": 7}),
         ("/set_active_target", {"id": "x"}), ("/set_active_target", {"id": None}),
         ("/toggle_visibility", {"map": False}), ("/load_map_for_imshow", {"filename": "../outside.png"}),
         ("/load_map_for_imshow", {"filename": "saved.png"}), ("/nowhere", {})]
BINARY = ("image/png", "text/html")


def test_routes_status_codes_and_bodies_match_jax(tmp_path, scans):
    """Every route of both servers, traversal attempts included: the same
    status codes and content types, and the same JSON bodies (maps and
    pages compared by kind; the map PNGs by their gray levels)."""
    js, ts = _pair(tmp_path)
    for k in range(3):
        js.feed_scan(scans[k])
        ts.feed_scan(scans[k])
    (tmp_path / "outside.png").write_bytes(b"not for the server")
    servers = [_serve(js), _serve(ts)]
    try:
        for path in GETS:
            (sj, cj, bj), (st, ct, bt) = (_request(base + path) for _, base in servers)
            assert (st, ct) == (sj, cj), path
            if ct == "application/json":
                got, want = json.loads(bt), json.loads(bj)
                if path == "/get_points_of_interest":
                    for g, w in zip(got["points"], want["points"]):
                        assert np.abs(np.subtract(g["pos_px"], w["pos_px"])).max() <= 1
                        g["pos_px"] = w["pos_px"]
                if path == "/get_map_points/saved":
                    assert abs(len(got["points"]) - len(want["points"])) <= 0.01 * len(want["points"]) + 5
                    continue
                if path == "/save_frame":  # capture_<seconds>.png: the two calls may straddle a second
                    assert got["status"] == want["status"] == "success"
                    continue
                assert got == want, path
            elif path == "/map_image":
                _map_png_agrees(bt, bj)
            elif ct in BINARY:
                assert len(bt) > 0 and bt[:8] == bj[:8], path
        events = []
        for _, base in servers:  # one event of the stream from each
            with urllib.request.urlopen(base + "/points_stream", timeout=30) as r:
                line = r.readline()
                while not line.startswith(b"data: "):
                    line = r.readline()
            events.append(json.loads(line[6:]))
        _same_payload(events[1], events[0])
        for path, payload in POSTS:
            (sj, cj, bj), (st, ct, bt) = (_request(base + path, payload) for _, base in servers)
            assert (st, ct) == (sj, cj), path
            got, want = json.loads(bt), json.loads(bj)
            if path == "/add_point":
                assert np.abs(np.subtract(got.pop("new_point"), want.pop("new_point"))).max() <= POS_MM
            assert got == want, (path, payload)
    finally:
        for state, (srv, _) in zip((js, ts), servers):
            state.stopped.set()
            srv.shutdown()
    assert ts.update_mode == 1  # /resume_mapping after /load_map/saved.png


def _stereo(tmp_path, module):
    d = tmp_path / "cams"
    d.mkdir(parents=True)
    for i in range(3):
        Image.new("RGB", (640, 480), (10 * i, 40, 90)).save(d / f"anh_1_{i}.png")
        Image.new("RGB", (640, 480), (10 * i, 40, 90)).save(d / f"anh_2_{i}.png")
    return module.StereoCapture(module.ReplayCamera(str(d), "anh_1"), module.ReplayCamera(str(d), "anh_2"),
                                str(tmp_path / "save"))


@pytest.mark.parametrize("detector", [FakeStereoDetector, FakePoseStereoDetector], ids=["boxes", "keypoints"])
def test_fused_loop_matches_jax(detector, tmp_path, scans):
    """The trigger-gated camera loop with the JAX tests' fake stereo
    detectors: the same camera data on the stream, the same landmark, an
    annotated JPEG of the frame's size for each eye."""
    js, ts = _pair(tmp_path)
    results = []
    for state, module, sub in ((js, jcamera, "cam_j"), (ts, tcamera, "cam_t")):
        state.feed_scan(scans[0])
        state.attach_camera(detector(), _stereo(tmp_path / sub, module), poll_s=0.02)
        state.camera_trigger = True
        deadline = time.time() + 20
        while (state.last_camera_data is None or state.camera_frame_jpeg(1) is None) and time.time() < deadline:
            time.sleep(0.02)
        state.stopped.set()
        assert state.last_camera_data is not None and "camera_data" in state.stream_payload()
        results.append((dict(state.last_camera_data), state.landmarks.landmarks[0], state.landmark_markers()))
    (jcd, jlm, jmark), (tcd, tlm, tmark) = results
    assert set(tcd) == set(jcd) and tcd["direction"] == jcd["direction"]
    for key in ("yaw_deg", "distance_mm", "lateral_mm"):
        assert abs(tcd[key] - jcd[key]) <= 0.1, (key, tcd, jcd)
    assert 900 < tcd["distance_mm"] < 1100  # the fake detectors' 1 m target
    np.testing.assert_allclose(tlm.xy_mm, jlm.xy_mm, rtol=1e-6, atol=1e-6)
    assert (tlm.class_id, tlm.score) == (jlm.class_id, jlm.score)
    assert [(m["px"], m["py"], m["class"]) for m in tmark[:1]] == [(m["px"], m["py"], m["class"]) for m in jmark[:1]]
    for eye in (0, 1):
        assert chip_smoke.jpeg_size(ts.camera_frame_jpeg(eye)) == (480, 640)
        assert np.asarray(Image.open(io.BytesIO(ts.camera_frame_jpeg(eye)))).shape == (480, 640, 3)


def test_replay_camera_reads_jpeg_and_save_pair_writes_jpeg(tmp_path):
    """A folder of JPEG frames (and a PNG and a gray one) replays the same
    RGB frames through both packages' `ReplayCamera`; `save_pair` writes
    ``anh_{1,2}_N.jpg`` in both, the port's encoder at PIL's save
    defaults: decoded, the pixels of PIL's files (within one level on
    average and 40 dB is the bound; the encoders' arithmetic is the same,
    so they are equal)."""
    d = tmp_path / "cams"
    d.mkdir()
    for i in range(2):
        for eye in (1, 2):
            frame = chip_smoke.synthetic_frame(10 * eye + i)
            Image.fromarray(frame if i == 0 else frame[..., 0]).save(d / f"anh_{eye}_{i}.jpg", quality=88)
    Image.fromarray(chip_smoke.synthetic_frame(99)).save(d / "anh_1_2.png")
    captures = {}
    for module, side in ((jcamera, "j"), (tcamera, "t")):
        stereo = module.StereoCapture(module.ReplayCamera(str(d), "anh_1"), module.ReplayCamera(str(d), "anh_2"),
                                      str(tmp_path / side))
        stereo.open()
        frames = [stereo.left.read() for _ in range(3)]
        assert stereo.save_pair() == (str(tmp_path / side / "anh_1_0.jpg"), str(tmp_path / side / "anh_2_0.jpg"))
        captures[side] = frames, [np.asarray(Image.open(tmp_path / side / f"anh_{e}_0.jpg")) for e in (1, 2)]
    for got, want in zip(captures["t"][0], captures["j"][0]):
        assert got.shape == want.shape and got.shape[2] == 3 and np.array_equal(got, want)
    for got, want in zip(captures["t"][1], captures["j"][1]):
        assert got.shape == want.shape == (480, 640, 3) and np.array_equal(got, want)


class SpyDetector:
    def __init__(self):
        self.calls = []

    def __call__(self, frame):
        self.calls.append(("call", frame.shape))
        return {"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "classes": np.zeros(0, np.int32)}

    def detect_pair(self, f1, f2):
        self.calls.append(("detect_pair", f1.shape, f2.shape))
        return self(f1), self(f2)


def test_warmup_runs_detect_pair_and_resets(tmp_path):
    _, tcfg = _configs()
    ts = tstate.ServerState(tcfg, work_dir=str(tmp_path), device="cpu")
    spy = SpyDetector()
    took = ts.warmup(spy)
    assert ("detect_pair", (480, 640, 3), (480, 640, 3)) in spy.calls and spy.calls[0] == ("call", (480, 640, 3))
    assert set(took) == {"build_s", "slam_s", "detector_s", "total_s"} and took["build_s"] < 0.01  # no build on the CPU
    assert ts.engine.state is None and ts.engine.trajectory == [] and ts.last_scan_points_px == []
    ts.warmup()  # no detector: the SLAM part alone


def test_replay_thread_equals_direct_run(tmp_path, scans):
    """`start_replay` over a folder of ``.npy`` scans gives the poses and
    accept flags of one `Slam.run` of the same scans."""
    from icp_slam_yolo_tpu_torch.slam.api import Slam

    _, tcfg = _configs()
    d = tmp_path / "scans"
    d.mkdir()
    for k in range(N_SCANS):
        np.save(d / f"Scan_data_{k + 1}.npy", scans[k])
    ts = tstate.ServerState(tcfg, work_dir=str(tmp_path), device="cpu")
    outs = []
    feed = ts.feed_scan
    ts.feed_scan = lambda scan: outs.append(feed(scan)) or outs[-1]
    ts.start_replay(str(d), rate_hz=float("inf"))
    ts._thread.join(120)
    _, direct = Slam(tcfg, device="cpu").run(scans[:N_SCANS])
    assert len(outs) == N_SCANS
    np.testing.assert_array_equal([o["accepted"] for o in outs[1:]], direct.accepted.numpy())
    np.testing.assert_allclose(np.array([o["pose"] for o in outs[1:]]), direct.pose.numpy(), rtol=0, atol=1e-3)
