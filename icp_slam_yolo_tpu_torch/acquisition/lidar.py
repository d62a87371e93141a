"""LiDAR acquisition: the `LidarScanner` API with pluggable backends; the
counterpart of the JAX package's ``acquisition/lidar.py`` (host code, no
device work: the same behaviour and constants, in a copy of its own).

The reference's acquisition layer:
  * simple scanner `duc/code python/read_lidar.py:19-78`: connect/start/stop,
    daemon read thread keeping ``latest_scan`` behind a lock, ``get_scan()``
    returning a copy;
  * hardened variant `duc/code python/b.py:45-160`: serial-port auto-detect,
    connect retry x5 with delay, motor start, ``get_health()`` gating, in-loop
    health check with reconnect.

Backends: `RplidarBackend` drives a real RPLidar over serial (requires the
``rplidar`` package + hardware — gated, as in the reference's deployment);
`ReplayLidar` replays recorded ``.npy`` scans at a configurable rate, which is
the reference's own hardware-free strategy (record raw scans, replay from
files — SURVEY.md section 4).  `ScanRecorder` mirrors the acquisition main
loop (`read_lidar.py:132-143`): persist the latest scan every ``interval_s``.
"""

from __future__ import annotations

import glob
import os
import threading
import time

import numpy as np

BAUDRATE = 256000  # `read_lidar.py:21`
CONNECT_RETRIES = 5  # `b.py:56-95`
RETRY_DELAY_S = 1.0


class LidarBackend:
    """Minimal backend contract: yields `(N, 3)` [quality, angle, dist] scans."""

    def connect(self) -> None: ...
    def disconnect(self) -> None: ...
    def healthy(self) -> bool:
        return True
    def iter_scans(self):
        raise NotImplementedError


class ReplayLidar(LidarBackend):
    """Replays recorded scans from a directory at ``rate_hz`` (loops)."""

    def __init__(self, directory: str, rate_hz: float = 10.0, loop: bool = True):
        from icp_slam_yolo_tpu_torch.io import scans as scans_io

        self.paths = scans_io.discover_sequence(directory)
        if not self.paths:
            raise FileNotFoundError(f"no scans under {directory}")
        self.rate_hz = rate_hz
        self.loop = loop
        self.connected = False

    def connect(self) -> None:
        self.connected = True

    def disconnect(self) -> None:
        self.connected = False

    def iter_scans(self):
        while True:
            for p in self.paths:
                if not self.connected:
                    return
                yield np.load(p)
                time.sleep(1.0 / self.rate_hz)
            if not self.loop:
                return


class RplidarBackend(LidarBackend):
    """Real RPLidar over serial (hardware + ``rplidar`` package required).

    Port auto-detect scans /dev/ttyUSB* (`b.py:32-43`); health is gated on
    ``get_health()`` (`b.py:101-110`).
    """

    def __init__(self, port: str | None = None, baudrate: int = BAUDRATE):
        self.port = port
        self.baudrate = baudrate
        self._lidar = None

    @staticmethod
    def autodetect_port() -> str | None:
        candidates = sorted(glob.glob("/dev/ttyUSB*") + glob.glob("/dev/ttyACM*"))
        return candidates[0] if candidates else None

    def connect(self) -> None:
        try:
            from rplidar import RPLidar  # type: ignore
        except ImportError as e:
            raise RuntimeError("rplidar package not installed (hardware path)") from e
        port = self.port or self.autodetect_port()
        if port is None:
            raise RuntimeError("no serial port found for RPLidar")
        self._lidar = RPLidar(port, baudrate=self.baudrate)
        self._lidar.start_motor()

    def healthy(self) -> bool:
        if self._lidar is None:
            return False
        try:
            status, _ = self._lidar.get_health()
            return status == "Good"
        except Exception:
            return False

    def iter_scans(self):
        for scan in self._lidar.iter_scans():
            yield np.asarray(scan, dtype=np.float64)

    def disconnect(self) -> None:
        if self._lidar is not None:
            try:
                self._lidar.stop()
                self._lidar.stop_motor()
                self._lidar.disconnect()
            except Exception:
                pass
            self._lidar = None


class LidarScanner:
    """`read_lidar.py`-compatible scanner: background read thread + get_scan().

    Adds the hardened behaviours of `b.py:45-160`: connect retries, health
    checks every ``health_check_every`` scans with reconnect on failure.
    """

    def __init__(self, backend: LidarBackend, health_check_every: int = 50):
        self.backend = backend
        self.health_check_every = health_check_every
        self._latest: np.ndarray | None = None
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._running = threading.Event()
        self.scan_count = 0
        self.reconnects = 0

    def connect(self) -> None:
        last = None
        for _ in range(CONNECT_RETRIES):
            try:
                self.backend.connect()
                return
            except Exception as e:  # retry with delay (`b.py:56-95`)
                last = e
                time.sleep(RETRY_DELAY_S)
        raise ConnectionError(f"lidar connect failed after {CONNECT_RETRIES} retries: {last}")

    def start(self) -> None:
        self._running.set()
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _read_loop(self) -> None:
        while self._running.is_set():
            try:
                for scan in self.backend.iter_scans():
                    if not self._running.is_set():
                        return
                    with self._lock:
                        self._latest = np.asarray(scan)
                    self.scan_count += 1
                    if self.scan_count % self.health_check_every == 0 and not self.backend.healthy():
                        raise ConnectionError("lidar health check failed")
                return  # backend iterator exhausted
            except Exception:
                # reconnect path (`b.py:125-146`)
                self.reconnects += 1
                self.backend.disconnect()
                try:
                    self.connect()
                except ConnectionError:
                    return

    def get_scan(self) -> np.ndarray | None:
        """Latest raw scan (copy) or None before the first one (`read_lidar.py:75-78`)."""
        with self._lock:
            return None if self._latest is None else self._latest.copy()

    def stop(self) -> None:
        self._running.clear()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.backend.disconnect()


class ScanRecorder:
    """Persist scans as ``<prefix>_{i}.npy`` every ``interval_s``
    (`read_lidar.py:132-143` writes one raw scan every 0.1 s)."""

    def __init__(self, directory: str, prefix: str = "Scan_data", interval_s: float = 0.1):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.prefix = prefix
        self.interval_s = interval_s
        self.index = 1
        self._last_save = 0.0

    def maybe_save(self, scan: np.ndarray | None) -> str | None:
        now = time.monotonic()
        if scan is None or now - self._last_save < self.interval_s:
            return None
        path = os.path.join(self.directory, f"{self.prefix}_{self.index}.npy")
        np.save(path, np.asarray(scan, dtype=np.float64))
        self.index += 1
        self._last_save = now
        return path
