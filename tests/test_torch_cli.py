"""The port's command line (``python -m icp_slam_yolo_tpu_torch.cli``, run
as a subprocess with ``--device cpu``) against the JAX package's CLI on the
same inputs, and the port's import rule.

Inputs: a folder of seeded synthetic scans (`chip_smoke.synthetic_sequence`
saved as ``.npy``), seeded PNG and JPEG frames, label files and a small
image pool.  Tolerances: trajectories 2 mm /
2e-3 rad (`test_torch_slam._compare`'s); the map PNG's gray levels equal on
at least 99.5 % of cells; the map point count within 1 % + 5; detections as
`test_torch_detect.py` holds them (boxes 0.02 px, scores 1e-4); the
registration 1 mm / 2e-3 rad and its RMSE 0.1 mm."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from icp_slam_yolo_tpu import cli as jcli
from icp_slam_yolo_tpu_torch.io import maps as tmaps
from icp_slam_yolo_tpu_torch.utils.images import decode_png
from test_torch_slam import ANG_RAD, POS_MM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_cli(*args, check=True):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "icp_slam_yolo_tpu_torch.cli", *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    if check:
        assert r.returncode == 0, r.stdout + r.stderr
    return r


@pytest.fixture(scope="module")
def scan_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scans")
    scans, _ = chip_smoke.synthetic_sequence(10, seed=3)
    for k, scan in enumerate(scans):
        np.save(d / f"Scan_data_{k + 1}.npy", scan)
    return str(d)


def _fields(out: str) -> dict:
    """The numbers of `replay`'s printed lines, by name."""
    got = {"loaded": int(re.search(r"loaded (\d+) scans", out).group(1))}
    m = re.search(r"replayed (\d+) scans in [\d.]+s.*\(([\d.]+) scans/s.*accepted (\d+)/(\d+), "
                  r"median rmse ([\d.]+) mm, map (\d+) points", out)
    got.update(replayed=int(m.group(1)), accepted=(int(m.group(3)), int(m.group(4))), rmse=float(m.group(5)),
               map_points=int(m.group(6)))
    got["saved"] = re.search(r"saved (\S+)\.png / \.npy / \.pcd / _trajectory\.npy", out) is not None
    return got


def test_replay_matches_the_jax_cli(scan_dir, tmp_path, capsys):
    jout, tout = str(tmp_path / "j_map"), str(tmp_path / "t_map")
    jcli.main(["replay", scan_dir, "--output", jout, "--map-capacity", "2048"])
    want = _fields(capsys.readouterr().out)
    r = _port_cli("replay", scan_dir, "--output", tout, "--map-capacity", "2048", "--device", "cpu")
    got = _fields(r.stdout)
    assert want["saved"] and got["saved"]
    for key in ("loaded", "replayed", "accepted"):
        assert got[key] == want[key], key
    assert abs(got["rmse"] - want["rmse"]) <= 0.1
    assert abs(got["map_points"] - want["map_points"]) <= 0.01 * want["map_points"] + 5
    tt, jt = np.load(tout + "_trajectory.npy"), np.load(jout + "_trajectory.npy")
    assert tt.shape == jt.shape == (10, 3)
    dp = np.abs(tt - jt)
    assert dp[:, :2].max() <= POS_MM and dp[:, 2].max() <= ANG_RAD, dp.max(0)
    t_img = decode_png(open(tout + ".png", "rb").read())
    j_img = np.asarray(Image.open(jout + ".png"))
    assert t_img.shape == j_img.shape and (t_img == j_img).mean() >= 0.995
    assert abs(len(np.load(tout + ".npy")) - len(np.load(jout + ".npy"))) <= 0.01 * len(np.load(jout + ".npy")) + 5
    assert tmaps.load_pcd(tout + ".pcd").shape == (got["map_points"], 3)


def test_replay_needs_the_card_unless_told(scan_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _port_cli("replay", scan_dir, "--output", str(tmp_path / "m"), check=False)
    assert r.returncode != 0 and "device='cpu'" in r.stderr


def test_detect_matches_the_jax_cli(tmp_path, capsys):
    """The trained detector on synthetic frames (no pallet in them: it scores
    them near 1e-5, so the threshold is 1e-6 to leave candidates), PNG and
    JPEG (decoded to PIL's pixels on both sides)."""
    paths = []
    for seed, ext in ((0, "png"), (1, "png"), (0, "jpg")):
        path = str(tmp_path / f"frame_{seed}.{ext}")
        Image.fromarray(chip_smoke.synthetic_frame(seed)).save(path)
        paths.append(path)
    weights = os.path.join(REPO, chip_smoke.DETECT_CHECKPOINT)
    args = ["detect", *paths, "--weights", weights, "--img-size", "64", "--conf", "1e-6", "--f32"]
    jcli.main(args)
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    got = [json.loads(line) for line in _port_cli(*args, "--device", "cpu").stdout.splitlines()]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["image"] == w["image"] and set(g) == set(w)
        assert len(g["boxes"]) == len(w["boxes"]) > 0
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=0.02)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
        assert g["classes"] == w["classes"]


@pytest.mark.parametrize("fix", [False, True])
def test_label_check_matches_the_jax_cli(fix, tmp_path, capsys):
    """The report's lines, the exit code (1 on out-of-range coordinates
    without ``--fix``) and the repaired files equal the JAX CLI's."""
    for side in ("j", "t"):
        d = tmp_path / side
        d.mkdir()
        (d / "good.txt").write_text("0 0.5 0.5 0.2 0.2\n")
        (d / "bad.txt").write_text("0 1.5 0.5 0.2 -0.1\n")
    args = ["label-check"] + (["--fix"] if fix else [])
    try:
        jcli.main(args + [str(tmp_path / "j")])
        jcode = 0
    except SystemExit as e:
        jcode = e.code
    want = capsys.readouterr().out
    r = _port_cli(*args, str(tmp_path / "t"), check=False)
    assert r.returncode == jcode == (0 if fix else 1)
    assert r.stdout.replace(str(tmp_path / "t"), "") == want.replace(str(tmp_path / "j"), "")
    assert (tmp_path / "t" / "bad.txt").read_bytes() == (tmp_path / "j" / "bad.txt").read_bytes()


def test_split_matches_the_jax_cli(tmp_path, capsys):
    src = tmp_path / "src"
    (src / "images").mkdir(parents=True)
    (src / "labels").mkdir()
    for i in range(7):
        Image.new("RGB", (8, 8), (i * 30, 0, 0)).save(src / "images" / f"img{i}.jpg")
        (src / "labels" / f"img{i}.txt").write_text(f"0 0.5 0.5 0.1 0.{i}\n")
    args = ["--ratio", "0.7", "--seed", "3"]
    jcli.main(["split", str(src), str(tmp_path / "j"), *args])
    want = capsys.readouterr().out
    r = _port_cli("split", str(src), str(tmp_path / "t"), *args)
    assert r.stdout.replace(str(tmp_path / "t"), "") == want.replace(str(tmp_path / "j"), "")
    for split in ("train", "val"):
        for sub in ("images", "labels"):
            assert sorted(os.listdir(tmp_path / "t" / split / sub)) == sorted(os.listdir(tmp_path / "j" / split / sub))


def test_labeler_help_matches_the_jax_cli():
    """The JAX CLI's arguments and defaults, plus ``--device``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    want = subprocess.run([sys.executable, "-m", "icp_slam_yolo_tpu.cli", "labeler", "--help"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    got = _port_cli("labeler", "--help")
    options = lambda text: set(re.findall(r"(--[a-z-]+|image_dir)", text))  # noqa: E731
    assert want.returncode == 0 and options(got.stdout) == options(want.stdout) | {"--device"}
    for default in ("labels_out", "5001", "0.0.0.0"):
        assert (default in got.stdout) == (default in want.stdout)


def test_train_then_eval(tmp_path, capsys):
    """``train`` (float32, the dataset on the device; 64 px, batch 2, two
    steps) writes a checkpoint that flax reads, its metadata and the results
    CSV; ``eval`` on it prints the metrics JSON with the JAX CLI's keys and,
    for the same checkpoint, the JAX CLI's values (both bfloat16, unfused;
    within 2e-3)."""
    from flax import serialization

    root = chip_smoke.pallet_dataset(str(tmp_path / "pallets"), seed=9, n_train=4, n_val=3, h=120, w=160)
    ckpt = str(tmp_path / "trained.msgpack")
    r = _port_cli("train", f"{root}/train", "--img-size", "64", "--batch-size", "2", "--steps", "2", "--output", ckpt,
                  "--device", "cpu")
    assert "step 1/2: " in r.stdout and f"saved checkpoint to {ckpt}" in r.stdout
    assert set(serialization.msgpack_restore(open(ckpt, "rb").read())) == {"params", "batch_stats"}
    assert json.load(open(ckpt + ".json")) == {"img_size": 64, "num_classes": 1, "variant": "n", "task": "detect",
                                               "family": "v8"}
    assert open(ckpt + ".results.csv").readline().startswith("step,")
    out = str(tmp_path / "metrics.json")
    got = json.loads(_port_cli("eval", "--weights", ckpt, "--data", f"{root}/val", "--device", "cpu").stdout.split("\nwrote")[0])
    jcli.main(["eval", "--weights", ckpt, "--data", f"{root}/val", "--output", out])
    want = json.loads(capsys.readouterr().out.split("\nwrote")[0])
    assert got["task"] == want["task"] == "detect" and set(got) == set(want)
    for k in ("precision", "recall", "mAP50", "mAP50_95"):
        assert abs(got[k] - want[k]) <= 2e-3, k


def test_register_matches_the_jax_cli(scan_dir, tmp_path, capsys):
    src, dst = os.path.join(scan_dir, "Scan_data_3.npy"), os.path.join(scan_dir, "Scan_data_1.npy")
    jcli.main(["register", src, dst, "--output", str(tmp_path / "j.png")])
    want = json.loads(capsys.readouterr().out.splitlines()[0])
    out = _port_cli("register", src, dst, "--output", str(tmp_path / "t.png"), "--device", "cpu").stdout
    got = json.loads(out.splitlines()[0])
    assert "overlay saved to" in out
    assert (got["source_points"], got["target_points"]) == (want["source_points"], want["target_points"])
    assert abs(got["rmse_mm"] - want["rmse_mm"]) <= 0.1 and abs(got["theta_rad"] - want["theta_rad"]) <= ANG_RAD
    assert np.abs(np.subtract(got["t_mm"], want["t_mm"])).max() <= 1.0
    t_img = decode_png((tmp_path / "t.png").read_bytes())
    j_img = np.asarray(Image.open(tmp_path / "j.png"))
    assert t_img.shape == j_img.shape == (800, 800, 3) and (t_img == j_img).all(axis=-1).mean() >= 0.999


def _sources():
    pkg = os.path.join(REPO, "icp_slam_yolo_tpu_torch")
    files = [os.path.join(root, f) for root, _, names in os.walk(pkg) for f in names if f.endswith(".py")]
    scripts = [os.path.join(REPO, "scripts", f"torch_train_{n}.py") for n in ("pallet", "obb", "pose", "segment")]
    workers = [os.path.join(REPO, "tests", "torch_dist_workers.py")]  # every rank of the multi-process tests imports it
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")] + scripts + workers


FORBIDDEN = ("jax", "flax", "optax", "PIL", "cv2", "icp_slam_yolo_tpu")
# the one allowed exception: the live camera imports OpenCV when it opens
# (the JAX package's `OpenCVCamera.open` does the same)
LAZY_CV2 = (os.path.join("icp_slam_yolo_tpu_torch", "acquisition", "camera.py"), "OpenCVCamera", "open")


def _lazy_cv2_nodes(tree, rel: str) -> set:
    if rel != LAZY_CV2[0]:
        return set()
    return {id(n) for c in tree.body if isinstance(c, ast.ClassDef) and c.name == LAZY_CV2[1]
            for f in c.body if isinstance(f, ast.FunctionDef) and f.name == LAZY_CV2[2]
            for n in ast.walk(f) if isinstance(n, ast.Import) and [a.name for a in n.names] == ["cv2"]}


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_nothing_forbidden(path):
    """No import (at any depth of the file) of JAX, flax, optax, PIL, OpenCV
    or the JAX package: the port runs on a machine that has none of them.
    The one exception is ``OpenCVCamera.open``'s import of ``cv2`` (a live
    camera needs OpenCV; nothing else imports it)."""
    tree = ast.parse(open(path).read(), path)
    allowed = _lazy_cv2_nodes(tree, os.path.relpath(path, REPO))
    assert bool(allowed) == (os.path.relpath(path, REPO) == LAZY_CV2[0])
    for node in ast.walk(tree):
        if id(node) in allowed:
            continue
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}"


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("hub", ["port", "jax"])
def test_comm_hub_and_send_match_the_jax_cli(hub):
    """``comm-hub --echo`` in one package, ``comm-send`` from both against
    it: the handshake and the echoed line, and the hub's printout, as the
    JAX CLI prints them."""
    import signal

    if hub == "port":
        from icp_slam_yolo_tpu_torch.native.build import library_available
    else:
        from icp_slam_yolo_tpu.native.build import library_available
    if not library_available():
        pytest.skip("g++ unavailable")
    env = dict(os.environ, PYTHONPATH=REPO)
    port = str(_free_port())
    mod = "icp_slam_yolo_tpu_torch.cli" if hub == "port" else "icp_slam_yolo_tpu.cli"
    proc = subprocess.Popen([sys.executable, "-u", "-m", mod, "comm-hub", "--port", port, "--echo"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline() == f"comm hub on 127.0.0.1:{port} (max 2 clients); echoing handshakes\n"
        args = ["comm-send", "--port", port, "--handshake", "DX:0", "--message", "CMD:forward", "--timeout-ms", "2000"]
        got = _port_cli(*args).stdout
        want = subprocess.run([sys.executable, "-m", "icp_slam_yolo_tpu.cli", *args], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert want.returncode == 0, want.stderr
        assert got == want.stdout == "handshake 'DX:0' ok (0 retries)\n-> CMD:forward\n<- CMD:forward\n"
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert out == "<- DX:0\n<- CMD:forward\n" * 2


def test_comm_help_matches_the_jax_cli():
    """``comm-hub`` and ``comm-send`` take the JAX CLI's flags and defaults."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for sub in ("comm-hub", "comm-send"):
        want = subprocess.run([sys.executable, "-m", "icp_slam_yolo_tpu.cli", sub, "--help"], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
        got = _port_cli(sub, "--help")
        assert want.returncode == 0
        options = lambda text: set(re.findall(r"--[a-z-]+", text))  # noqa: E731
        assert options(got.stdout) == options(want.stdout) and options(got.stdout) >= {"--port", "--help"}
        for default in ("8900", "127.0.0.1", "1000"):
            assert (default in got.stdout) == (default in want.stdout), (sub, default)
