"""The port's native bindings (`native/`) against the JAX package's:
`tests/test_native.py`'s cases on the port, the port's client against the
JAX server and the JAX client against the port's (one wire protocol, one C++
source), and `load_batch_native` against the port's `io/scans` loader.  The
libraries are built into the port's own build directory."""

import os
import threading
import time

import numpy as np
import pytest

from icp_slam_yolo_tpu.native import robotlink as jlink
from icp_slam_yolo_tpu_torch.io import scans as scans_io
from icp_slam_yolo_tpu_torch.native import build as tbuild
from icp_slam_yolo_tpu_torch.native import robotlink as tlink
from icp_slam_yolo_tpu_torch.native.build import library_available
from icp_slam_yolo_tpu_torch.native.scanloader import load_batch_native

pytestmark = pytest.mark.skipif(not library_available(), reason="g++ unavailable")


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(cond, seconds: float = 2.0):
    deadline = time.time() + seconds
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


def test_libraries_build_into_the_ports_directory():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("robotlink", "scanloader"):
        path = tbuild.build_library(name)
        assert path == os.path.join(root, "icp_slam_yolo_tpu_torch", "_build", "native", f"lib{name}.so")
        assert os.path.getmtime(path) >= os.path.getmtime(os.path.join(root, "native", f"{name}.cpp"))
    assert tbuild.build_library("robotlink") == path.replace("scanloader", "robotlink")  # cached


# server package, client package
PAIRS = [(tlink, tlink), (jlink, tlink), (tlink, jlink)]
IDS = ["port-port", "jax_server-port_client", "port_server-jax_client"]


@pytest.mark.parametrize("server_mod,client_mod", PAIRS, ids=IDS)
def test_robotlink_telemetry_and_commands(server_mod, client_mod):
    port = _free_port()
    with server_mod.RobotLinkServer(port) as server:
        with client_mod.RobotLinkClient("127.0.0.1", port) as client:
            assert _wait(lambda: server.client_count >= 1) and server.client_count == 1
            # telemetry out (AP -> station)
            assert server.broadcast("pose:1.0,2.0,0.5") == 1
            assert client.read_line(2000) == "pose:1.0,2.0,0.5"
            # command in (station -> AP)
            client.send("CMD:forward")
            deadline, cmd = time.time() + 2, None
            while cmd is None and time.time() < deadline:
                cmd = server.read_command()
                time.sleep(0.01)
            assert cmd == "CMD:forward"


@pytest.mark.parametrize("server_mod,client_mod", PAIRS, ids=IDS)
def test_robotlink_handshake_echo(server_mod, client_mod):
    """The firmware's send/echo-verify protocol."""
    port = _free_port()
    with server_mod.RobotLinkServer(port) as server:
        stop = threading.Event()

        def echo_loop():  # the AP-side UART echo partner
            while not stop.is_set():
                line = server.read_command()
                if line is not None:
                    server.broadcast(line)
                time.sleep(0.005)

        t = threading.Thread(target=echo_loop, daemon=True)
        t.start()
        try:
            with client_mod.RobotLinkClient("127.0.0.1", port) as client:
                assert client.handshake("DX:0") == 0
        finally:
            stop.set()
            t.join(1.0)


def test_robotlink_max_two_clients():
    port = _free_port()
    with tlink.RobotLinkServer(port) as server:
        c1 = tlink.RobotLinkClient("127.0.0.1", port)
        c2 = jlink.RobotLinkClient("127.0.0.1", port)
        time.sleep(0.3)
        assert server.client_count == 2
        c3 = tlink.RobotLinkClient("127.0.0.1", port)  # connects at TCP level...
        time.sleep(0.3)
        assert server.client_count == 2  # ...but the hub refuses a third slot
        assert server.broadcast("x") == 2
        for c in (c1, c2, c3):
            c.close()


def test_handshake_timeout():
    port = _free_port()
    with tlink.RobotLinkServer(port):  # nobody echoes
        with tlink.RobotLinkClient("127.0.0.1", port) as client:
            t0 = time.time()
            with pytest.raises(TimeoutError):
                client.handshake("DX:0")
            # 3 attempts x 1 s timeout
            assert 2.5 < time.time() - t0 < 6.0


def test_connect_refused_and_port_in_use():
    port = _free_port()
    with pytest.raises(ConnectionError):
        tlink.RobotLinkClient("127.0.0.1", port, timeout_ms=300)
    with tlink.RobotLinkServer(port):
        with pytest.raises(OSError, match="could not bind"):
            tlink.RobotLinkServer(port)


def _scan_files(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(5):
        n = int(rng.integers(10, 400))
        p = str(tmp_path / f"scan_{i}.npy")
        np.save(p, rng.uniform(0, 9000, (n, 3)))
        paths.append(p)
    np.save(str(tmp_path / "wide.npy"), rng.uniform(0, 9000, (700, 3)))  # more rows than n_max
    return paths + [str(tmp_path / "wide.npy"), str(tmp_path / "missing.npy")]


@pytest.mark.parametrize("native", [True, False], ids=["g++", "python-fallback"])
def test_scanloader_matches_the_ports_loader(tmp_path, monkeypatch, native):
    """The C++ loader and the fallback both give the port's `io/scans`
    rows (``pad_scan`` of ``load_scan``) and counts; a missing file is a
    zero row with count -1."""
    import icp_slam_yolo_tpu_torch.native.scanloader as sl

    if not native:
        monkeypatch.setattr(sl, "library_available", lambda: False)
    paths = _scan_files(tmp_path)
    out, counts = load_batch_native(paths, 512)
    assert out.shape == (7, 512, 3) and out.dtype == np.float32
    assert counts[-1] == -1 and not out[-1].any()
    for i, p in enumerate(paths[:-1]):
        raw = scans_io.load_scan(p)
        np.testing.assert_allclose(out[i], scans_io.pad_scan(raw, 512), rtol=1e-6)
        assert counts[i] == len(np.load(p))
