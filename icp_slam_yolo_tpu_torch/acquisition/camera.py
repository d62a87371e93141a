"""Stereo camera capture; the counterpart of the JAX package's
``acquisition/camera.py``.

The reference opens two cameras and saves paired frames ``anh_1_N`` /
``anh_2_N``.  Here: a `StereoCapture` with a pluggable frame source
(`ReplayCamera` serves recorded JPEG, PNG or ``.npy`` frames through
`utils.images.read_image`), and the reference's camera-worker behaviour
(event-gated lazy open, frame-pair grab, release when the trigger clears)
as `TriggeredCameraWorker`.  `OpenCVCamera` is the live camera: it imports
OpenCV (``cv2``) only when it opens, retries the open, and turns OpenCV's
BGR frames into RGB; nothing else here needs OpenCV.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from icp_slam_yolo_tpu_torch.utils.images import read_image, to_rgb, write_image


class CameraBackend:
    def open(self) -> None: ...
    def release(self) -> None: ...
    def read(self) -> np.ndarray | None:
        raise NotImplementedError

    @property
    def is_open(self) -> bool:
        return False


class ReplayCamera(CameraBackend):
    """Serves frames from a directory of images (loops): JPEG, PNG or
    ``.npy`` (uint8 HWC), as RGB."""

    def __init__(self, directory: str, pattern_prefix: str = ""):
        frames = sorted(n for n in os.listdir(directory)
                        if n.startswith(pattern_prefix) and n.lower().endswith((".jpg", ".jpeg", ".png", ".npy")))
        if not frames:
            raise FileNotFoundError(f"no frames under {directory}")
        self.paths = [os.path.join(directory, n) for n in frames]
        self.idx = 0
        self._open = False

    def open(self) -> None:
        self._open = True

    def release(self) -> None:
        self._open = False

    @property
    def is_open(self) -> bool:
        return self._open

    def read(self) -> np.ndarray | None:
        if not self._open:
            return None
        frame = to_rgb(np.asarray(read_image(self.paths[self.idx % len(self.paths)]), np.uint8))
        self.idx += 1
        return frame


class OpenCVCamera(CameraBackend):
    """A live camera through ``cv2.VideoCapture`` (hardware), opened with up
    to ``retries`` attempts half a second apart, as the reference retries."""

    def __init__(self, device: int, retries: int = 3):
        self.device = device
        self.retries = retries
        self._cap = None

    def open(self) -> None:
        import cv2  # type: ignore

        for _ in range(self.retries):
            cap = cv2.VideoCapture(self.device)
            if cap.isOpened():
                self._cap = cap
                return
            time.sleep(0.5)
        raise RuntimeError(f"camera {self.device} failed to open")

    @property
    def is_open(self) -> bool:
        return self._cap is not None

    def read(self) -> np.ndarray | None:
        if self._cap is None:
            return None
        ok, frame = self._cap.read()
        return frame[..., ::-1] if ok else None  # BGR -> RGB

    def release(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None


class StereoCapture:
    """Paired capture + save (the reference's file naming: ``anh_1_N.jpg`` /
    ``anh_2_N.jpg``, JPEG at PIL's save defaults: quality 75, 4:2:0)."""

    def __init__(self, left: CameraBackend, right: CameraBackend, save_dir: str):
        self.left = left
        self.right = right
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self.counter = 0

    def open(self) -> None:
        self.left.open()
        self.right.open()

    def grab_pair(self):
        return self.left.read(), self.right.read()

    def save_pair(self) -> tuple[str, str] | None:
        f1, f2 = self.grab_pair()
        if f1 is None or f2 is None:
            return None
        p1 = os.path.join(self.save_dir, f"anh_1_{self.counter}.jpg")
        p2 = os.path.join(self.save_dir, f"anh_2_{self.counter}.jpg")
        write_image(p1, np.asarray(f1, np.uint8))
        write_image(p2, np.asarray(f2, np.uint8))
        self.counter += 1
        return p1, p2

    def release(self) -> None:
        self.left.release()
        self.right.release()


class TriggeredCameraWorker:
    """The reference's camera-worker loop: wait on a trigger event, lazily
    open both cameras, per tick grab a pair and run the callback (detector +
    stereo math); release the cameras when the trigger clears."""

    def __init__(self, stereo: StereoCapture, trigger: threading.Event,
                 stop: threading.Event, on_pair, poll_s: float = 0.1):
        self.stereo = stereo
        self.trigger = trigger
        self.stop = stop
        self.on_pair = on_pair
        self.poll_s = poll_s
        self.pairs_processed = 0
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        opened = False
        while not self.stop.is_set():
            if not self.trigger.wait(self.poll_s):
                if opened:  # trigger cleared: release the cameras
                    self.stereo.release()
                    opened = False
                continue
            if not opened:
                self.stereo.open()
                opened = True
            f1, f2 = self.stereo.grab_pair()
            if f1 is not None and f2 is not None:
                self.on_pair(f1, f2)
                self.pairs_processed += 1
        if opened:
            self.stereo.release()

    def join(self, timeout: float = 2.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
