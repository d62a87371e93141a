"""ctypes bindings for the native comm link (ESP32-firmware-equivalent
layer); the counterpart of the JAX package's ``native/robotlink.py``, over the
same ``native/robotlink.cpp``, so either package's client talks to either's
server.

`RobotLinkServer` is the robot-side hub (the ESP_AP softAP+TCP role:
up to 2 clients, telemetry broadcast, inbound command lines) and
`RobotLinkClient` the station role (ESP_HOST2: connect, periodic telemetry,
`handshake()` = the firmware's send/echo-verify/retry protocol).
"""

from __future__ import annotations

import ctypes

from icp_slam_yolo_tpu_torch.native.build import build_library

_lib = None


def _load():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build_library("robotlink"))
        _lib.rl_server_start.restype = ctypes.c_void_p
        _lib.rl_server_start.argtypes = [ctypes.c_uint16]
        _lib.rl_server_broadcast.restype = ctypes.c_int
        _lib.rl_server_broadcast.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        _lib.rl_server_read_line.restype = ctypes.c_int
        _lib.rl_server_read_line.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        _lib.rl_server_client_count.restype = ctypes.c_int
        _lib.rl_server_client_count.argtypes = [ctypes.c_void_p]
        _lib.rl_server_stop.argtypes = [ctypes.c_void_p]
        _lib.rl_client_connect.restype = ctypes.c_void_p
        _lib.rl_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int]
        _lib.rl_client_send.restype = ctypes.c_int
        _lib.rl_client_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        _lib.rl_client_read_line.restype = ctypes.c_int
        _lib.rl_client_read_line.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        _lib.rl_client_handshake.restype = ctypes.c_int
        _lib.rl_client_handshake.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        _lib.rl_client_close.argtypes = [ctypes.c_void_p]
    return _lib


class RobotLinkServer:
    """Robot-side hub (`ESP_AP` role): telemetry out, command lines in."""

    def __init__(self, port: int):
        lib = _load()
        self._h = lib.rl_server_start(port)
        if not self._h:
            raise OSError(f"could not bind robotlink server on port {port}")
        self.port = port

    def broadcast(self, line: str) -> int:
        """Send one telemetry line to every connected client; returns sends."""
        return _load().rl_server_broadcast(self._h, line.encode())

    def read_command(self) -> str | None:
        buf = ctypes.create_string_buffer(1024)
        n = _load().rl_server_read_line(self._h, buf, 1024)
        return buf.value.decode() if n >= 0 else None

    @property
    def client_count(self) -> int:
        return _load().rl_server_client_count(self._h)

    def close(self) -> None:
        if self._h:
            _load().rl_server_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RobotLinkClient:
    """Station client (`ESP_HOST2` role) with the echo-verify handshake."""

    def __init__(self, host: str, port: int, timeout_ms: int = 2000):
        lib = _load()
        self._h = lib.rl_client_connect(host.encode(), port, timeout_ms)
        if not self._h:
            raise ConnectionError(f"robotlink connect to {host}:{port} failed")

    def send(self, line: str) -> None:
        if _load().rl_client_send(self._h, line.encode()) != 0:
            raise ConnectionError("send failed")

    def read_line(self, timeout_ms: int = 1000) -> str | None:
        buf = ctypes.create_string_buffer(1024)
        n = _load().rl_client_read_line(self._h, buf, 1024, timeout_ms)
        return buf.value.decode() if n >= 0 else None

    def handshake(self, message: str = "DX:0") -> int:
        """The firmware handshake (`ESP_AP/src/main.cpp:34-92`): send, await
        exact echo within 1 s, retry twice.  Returns retries used, raises on
        failure."""
        rc = _load().rl_client_handshake(self._h, message.encode())
        if rc < 0:
            raise TimeoutError(f"handshake '{message}' failed after retries")
        return rc

    def close(self) -> None:
        if self._h:
            _load().rl_client_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
