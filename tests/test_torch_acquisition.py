"""The port's acquisition layer (`acquisition/lidar.py`, the live camera of
`acquisition/camera.py`) against the JAX package's: `tests/test_acquisition.py`'s
cases on the port, and the hardware backends under the same fake
``rplidar`` module and the same patched ``cv2.VideoCapture`` for both
packages (host code: the results must be equal).  Also the trace exporter
of `utils/profiling.py`."""

import json
import sys
import time
import types

import numpy as np
import pytest
import torch

import icp_slam_yolo_tpu.acquisition.camera as jcamera
import icp_slam_yolo_tpu.acquisition.lidar as jlidar
import icp_slam_yolo_tpu_torch.acquisition.camera as tcamera
import icp_slam_yolo_tpu_torch.acquisition.lidar as tlidar
from icp_slam_yolo_tpu_torch.acquisition import LidarScanner, ReplayLidar, ScanRecorder
from icp_slam_yolo_tpu_torch.acquisition.lidar import LidarBackend
from icp_slam_yolo_tpu_torch.utils.profiling import trace


@pytest.fixture()
def scan_dir(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(1, 6):
        np.save(tmp_path / f"Scan_data_{i}.npy", rng.uniform(0, 9000, (50, 3)))
    return str(tmp_path)


def test_constants_equal_jax():
    assert (tlidar.BAUDRATE, tlidar.CONNECT_RETRIES, tlidar.RETRY_DELAY_S) == \
        (jlidar.BAUDRATE, jlidar.CONNECT_RETRIES, jlidar.RETRY_DELAY_S)


def test_replay_scanner(scan_dir):
    scanner = LidarScanner(ReplayLidar(scan_dir, rate_hz=200.0))
    scanner.connect()
    scanner.start()
    deadline = time.time() + 3
    scan = None
    while scan is None and time.time() < deadline:
        scan = scanner.get_scan()
        time.sleep(0.01)
    scanner.stop()
    assert scan is not None and scan.shape == (50, 3)
    assert scanner.scan_count >= 1


def test_replay_order_equals_jax(scan_dir):
    """Both replays yield the same files in the same order (no loop)."""
    ours, theirs = ReplayLidar(scan_dir, loop=False, rate_hz=1e4), jlidar.ReplayLidar(scan_dir, loop=False, rate_hz=1e4)
    assert ours.paths == theirs.paths
    ours.connect()
    theirs.connect()
    a, b = list(ours.iter_scans()), list(theirs.iter_scans())
    assert len(a) == len(b) == 5 and all(np.array_equal(x, y) for x, y in zip(a, b))
    with pytest.raises(FileNotFoundError):
        ReplayLidar(str(scan_dir) + "/missing")


def test_scanner_reconnects_on_failure():
    class Flaky(LidarBackend):
        def __init__(self):
            self.connects = 0

        def connect(self):
            self.connects += 1

        def disconnect(self):
            pass

        def iter_scans(self):
            yield np.zeros((20, 3))
            raise IOError("serial glitch")

    backend = Flaky()
    scanner = LidarScanner(backend)
    scanner.connect()
    scanner.start()
    time.sleep(0.5)
    scanner.stop()
    assert scanner.reconnects >= 1
    assert backend.connects >= 2  # initial + at least one reconnect


def test_connect_retries(monkeypatch):
    class Dead(LidarBackend):
        def __init__(self):
            self.attempts = 0

        def connect(self):
            self.attempts += 1
            raise IOError("no port")

    monkeypatch.setattr(tlidar, "RETRY_DELAY_S", 0.01)
    backend = Dead()
    with pytest.raises(ConnectionError):
        LidarScanner(backend).connect()
    assert backend.attempts == tlidar.CONNECT_RETRIES == 5


def test_health_check_failure_reconnects():
    """Every ``health_check_every`` scans an unhealthy backend is
    disconnected and connected again."""
    class Sick(LidarBackend):
        def __init__(self):
            self.connects, self.disconnects = 0, 0

        def connect(self):
            self.connects += 1

        def disconnect(self):
            self.disconnects += 1

        def healthy(self):
            return False

        def iter_scans(self):
            for _ in range(4):
                yield np.ones((3, 3))

    backend = Sick()
    scanner = LidarScanner(backend, health_check_every=2)
    scanner.connect()
    scanner.start()
    time.sleep(0.3)
    scanner.stop()
    assert scanner.reconnects >= 1 and backend.connects >= 2 and backend.disconnects >= 1


def test_recorder(tmp_path):
    rec = ScanRecorder(str(tmp_path / "rec"), interval_s=0.0)
    p1 = rec.maybe_save(np.zeros((10, 3)))
    p2 = rec.maybe_save(np.ones((12, 3)))
    assert p1.endswith("Scan_data_1.npy") and p2.endswith("Scan_data_2.npy")
    assert np.load(p2).shape == (12, 3) and np.load(p2).dtype == np.float64
    assert rec.maybe_save(None) is None


def test_recorder_interval(tmp_path):
    rec = ScanRecorder(str(tmp_path), interval_s=10.0)
    assert rec.maybe_save(np.zeros((5, 3))) is not None
    assert rec.maybe_save(np.zeros((5, 3))) is None  # too soon


def _fake_rplidar(calls: list, health: str = "Good"):
    """A stand-in for the ``rplidar`` package: ``RPLidar`` records every
    call and yields two scans of (quality, angle, distance) tuples."""
    mod = types.ModuleType("rplidar")

    class RPLidar:
        def __init__(self, port, baudrate):
            calls.append(("init", port, baudrate))

        def start_motor(self):
            calls.append(("start_motor",))

        def get_health(self):
            calls.append(("get_health",))
            return health, 0

        def iter_scans(self):
            yield [(15, 0.5, 1200.0), (14, 1.5, 1300.0)]
            yield [(13, 2.0, 900.0)]

        def stop(self):
            calls.append(("stop",))

        def stop_motor(self):
            calls.append(("stop_motor",))

        def disconnect(self):
            calls.append(("disconnect",))

    mod.RPLidar = RPLidar
    return mod


@pytest.mark.parametrize("health", ["Good", "Warning"])
def test_rplidar_backend_under_a_fake_module_as_jax(monkeypatch, health):
    results = []
    for pkg in (jlidar, tlidar):
        calls = []
        monkeypatch.setitem(sys.modules, "rplidar", _fake_rplidar(calls, health))
        backend = pkg.RplidarBackend(port="/dev/ttyFAKE0")
        assert not backend.healthy()  # before connect
        backend.connect()
        healthy = backend.healthy()
        scans = list(backend.iter_scans())
        backend.disconnect()
        backend.disconnect()  # a second disconnect is a no-op
        results.append((calls, healthy, [s.tolist() for s in scans], [s.dtype for s in scans]))
    assert results[0] == results[1]
    assert results[1][1] == (health == "Good")
    assert results[1][0][0] == ("init", "/dev/ttyFAKE0", 256000)


def test_rplidar_backend_without_the_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "rplidar", None)  # import raises ImportError
    with pytest.raises(RuntimeError, match="rplidar package not installed"):
        tlidar.RplidarBackend(port="/dev/ttyFAKE0").connect()
    monkeypatch.setitem(sys.modules, "rplidar", _fake_rplidar([]))
    monkeypatch.setattr(tlidar.RplidarBackend, "autodetect_port", staticmethod(lambda: None))
    with pytest.raises(RuntimeError, match="no serial port"):
        tlidar.RplidarBackend().connect()


class _FakeCapture:
    """``cv2.VideoCapture`` stand-in: opens on the ``opens_at``-th attempt;
    ``read`` gives seeded BGR frames, then a failed read."""

    attempts = 0
    opens_at = 1

    def __init__(self, device):
        type(self).attempts += 1
        self.device = device
        self.opened = type(self).attempts >= type(self).opens_at
        self.rng = np.random.default_rng(device)
        self.reads = 0
        self.released = False

    def isOpened(self):
        return self.opened

    def read(self):
        self.reads += 1
        if self.reads > 2:
            return False, None
        return True, self.rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)

    def release(self):
        self.released = True


@pytest.mark.parametrize("opens_at", [1, 3, 4])
def test_opencv_camera_under_a_patched_cv2_as_jax(monkeypatch, opens_at):
    """Retried open (3 attempts, half a second apart), BGR -> RGB frames, a
    failed read as None, release; the same for both packages."""
    import cv2

    monkeypatch.setattr(cv2, "VideoCapture", _FakeCapture)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    results = []
    for pkg in (jcamera, tcamera):
        _FakeCapture.attempts, _FakeCapture.opens_at = 0, opens_at
        cam = pkg.OpenCVCamera(2)
        assert not cam.is_open and cam.read() is None
        if opens_at > cam.retries:
            with pytest.raises(RuntimeError, match="camera 2 failed to open"):
                cam.open()
            results.append(("failed", _FakeCapture.attempts))
            continue
        cam.open()
        cap = cam._cap
        frames = [cam.read() for _ in range(3)]
        cam.release()
        assert cap.released and not cam.is_open
        results.append(([None if f is None else f.tolist() for f in frames], _FakeCapture.attempts))
    assert results[0] == results[1]
    if opens_at <= 3:
        first = np.asarray(results[1][0][0])
        bgr = np.random.default_rng(2).integers(0, 256, (6, 8, 3), dtype=np.uint8)
        assert np.array_equal(first, bgr[..., ::-1]) and results[1][0][2] is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
