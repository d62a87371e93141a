"""The port's map persistence (`io/maps.py`), rendering (`io/render.py`) and
`Slam`'s artifacts (`pose44`, `save_map`, `save_pcd`) against the JAX
package's, on seeded data.

Tolerances: `pose44` within 1e-6 (float32 sine and cosine of two math
libraries differ in the last place); files and arrays equal (bytes after
decoding for PNGs; the ``.npy`` and PCD files each package writes are read
by the other and give equal arrays); renderings pixel-equal; `annotate_detections` pixel-equal
outside the rows its text takes (12 below each text origin: the two
packages draw text with different fonts)."""

import struct

import numpy as np
import pytest

from icp_slam_yolo_tpu import config as jc
from icp_slam_yolo_tpu.io import maps as jmaps
from icp_slam_yolo_tpu.io import render as jrender
from icp_slam_yolo_tpu.slam import api as japi
from icp_slam_yolo_tpu_torch import config as tc
from icp_slam_yolo_tpu_torch.io import maps as tmaps
from icp_slam_yolo_tpu_torch.io import render as trender
from icp_slam_yolo_tpu_torch.slam.api import Slam
from icp_slam_yolo_tpu_torch.utils.images import decode_png

MAPS = [(tc.MapConfig(), jc.MapConfig()),
        (tc.MapConfig(width_mm=6000.0, height_mm=4000.0, resolution_mm_per_px=20.0),
         jc.MapConfig(width_mm=6000.0, height_mm=4000.0, resolution_mm_per_px=20.0))]


def _points(rng, n=500, spread=6000.0):
    return rng.uniform(-spread, spread, (n, 2)).astype(np.float32)


@pytest.mark.parametrize("which", range(len(MAPS)))
def test_pixel_conversions_match_jax(which, rng):
    tm, jm = MAPS[which]
    pts = _points(rng)
    px = tmaps.points_to_pixels(pts, tm)
    assert px.dtype == np.int32 and np.array_equal(px, jmaps.points_to_pixels(pts, jm))
    assert np.array_equal(tmaps.pixels_to_points(px, tm), jmaps.pixels_to_points(px, jm))


def test_occupancy_png_both_ways(tmp_path, rng):
    occ = rng.random((70, 90)).astype(np.float32)
    occ[:5] = 0.5
    assert np.array_equal(tmaps.occupancy_to_image(occ), jmaps.occupancy_to_image(occ))
    tmaps.save_occupancy_png(occ, str(tmp_path / "t.png"))
    jmaps.save_occupancy_png(occ, str(tmp_path / "j.png"))
    for name in ("t.png", "j.png"):
        path = str(tmp_path / name)
        assert np.array_equal(tmaps.load_occupancy_png(path), jmaps.load_occupancy_png(path))


def test_rgb_map_png_reads_as_jax_reads_it(tmp_path, rng):
    from PIL import Image

    Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)).save(tmp_path / "rgb.png")
    path = str(tmp_path / "rgb.png")
    assert np.array_equal(tmaps.load_occupancy_png(path), jmaps.load_occupancy_png(path))


@pytest.mark.parametrize("which", range(len(MAPS)))
def test_map_points_npy_cross_read(which, tmp_path, rng):
    tm, jm = MAPS[which]
    pts = _points(rng)
    tmaps.save_map_points_npy(pts, str(tmp_path / "t.npy"), tm)
    jmaps.save_map_points_npy(pts, str(tmp_path / "j.npy"), jm)
    assert np.array_equal(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"))
    for name in ("t.npy", "j.npy"):
        path = str(tmp_path / name)
        assert np.array_equal(tmaps.load_map_points_npy(path, tm), jmaps.load_map_points_npy(path, jm))


@pytest.mark.parametrize("dims", [2, 3])
def test_ascii_pcd_cross_read(dims, tmp_path, rng):
    pts = rng.uniform(-5000, 5000, (300, dims)).astype(np.float32)
    tmaps.save_pcd(pts, str(tmp_path / "t.pcd"))
    jmaps.save_pcd(pts, str(tmp_path / "j.pcd"))
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    for name in ("t.pcd", "j.pcd"):
        path = str(tmp_path / name)
        got = tmaps.load_pcd(path)
        assert np.array_equal(got, jmaps.load_pcd(path)) and got.shape == (300, 3)


@pytest.mark.parametrize("layout", ["xyz", "xyz+intensity", "normals count 3"])
def test_binary_pcd_matches_jax(layout, tmp_path, rng):
    """A ``DATA binary`` PCD written here field by field (Open3D's layout):
    plain xyz, xyz with a uint8 field between, and a COUNT 3 field."""
    n = 64
    xyz = rng.uniform(-3000, 3000, (n, 3)).astype(np.float32)
    if layout == "xyz":
        fields = [("x", "F", 4, 1), ("y", "F", 4, 1), ("z", "F", 4, 1)]
        rec = np.zeros(n, [("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
    elif layout == "xyz+intensity":
        fields = [("x", "F", 4, 1), ("i", "U", 1, 1), ("y", "F", 4, 1), ("z", "F", 4, 1)]
        rec = np.zeros(n, [("x", "<f4"), ("i", "<u1"), ("y", "<f4"), ("z", "<f4")])
        rec["i"] = rng.integers(0, 255, n)
    else:
        fields = [("n", "F", 4, 3), ("x", "F", 4, 1), ("y", "F", 4, 1), ("z", "F", 4, 1)]
        rec = np.zeros(n, [("n", "<f4", (3,)), ("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
        rec["n"] = rng.normal(size=(n, 3))
    rec["x"], rec["y"], rec["z"] = xyz.T
    header = ("VERSION 0.7\nFIELDS " + " ".join(f[0] for f in fields) + "\nSIZE "
              + " ".join(str(f[2]) for f in fields) + "\nTYPE " + " ".join(f[1] for f in fields)
              + "\nCOUNT " + " ".join(str(f[3]) for f in fields)
              + f"\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
    path = str(tmp_path / "b.pcd")
    with open(path, "wb") as f:
        f.write(header.encode() + rec.tobytes())
    got = tmaps.load_pcd(path)
    assert np.array_equal(got, xyz) and np.array_equal(got, jmaps.load_pcd(path))


def test_pcd_without_coordinates_is_refused_by_both(tmp_path):
    path = str(tmp_path / "bad.pcd")
    with open(path, "wb") as f:
        f.write(b"FIELDS x y\nSIZE 4 4\nTYPE F F\nCOUNT 1 1\nPOINTS 1\nDATA binary\n" + struct.pack("<ff", 1, 2))
    for load in (tmaps.load_pcd, jmaps.load_pcd):
        with pytest.raises(ValueError, match="missing coordinate"):
            load(path)


@pytest.mark.parametrize("which", range(len(MAPS)))
def test_map_renderings_match_jax(which, rng):
    tm, jm = MAPS[which]
    occ = rng.random((tm.height_px, tm.width_px)).astype(np.float32)
    t, j = trender.occupancy_rgb(occ), jrender.occupancy_rgb(occ)
    assert np.array_equal(t, j)
    pts = _points(rng, spread=8000.0)  # some fall off the map
    for k in range(6):
        pose = (float(rng.uniform(-3000, 3000)), float(rng.uniform(-2000, 2000)), float(rng.uniform(-3.2, 3.2)))
        t = trender.draw_points(t, pts[k::6], tm, color=(0, 255 - k, k), radius=k % 3)
        j = jrender.draw_points(j, pts[k::6], jm, color=(0, 255 - k, k), radius=k % 3)
        t = trender.draw_robot_pose(t, pose, tm, axis_length_mm=300.0 + 100 * k)
        j = jrender.draw_robot_pose(j, pose, jm, axis_length_mm=300.0 + 100 * k)
        t = trender.draw_target(t, pose[:2], tm)
        j = jrender.draw_target(j, pose[:2], jm)
    assert np.array_equal(t, j)


@pytest.mark.parametrize("size,mm", [(600, 30.0), (800, 15.0)])
def test_icp_debug_view_matches_jax(size, mm, rng):
    map_pts = _points(rng, 800, 9000.0)
    scan = rng.uniform(-6000, 6000, (300, 2))
    pose = (1234.5, -678.9, 0.7)
    assert np.array_equal(trender.icp_debug_view(map_pts, scan, pose, size, mm),
                          jrender.icp_debug_view(map_pts, scan, pose, size, mm))
    assert np.array_equal(trender.icp_debug_view(np.zeros((0, 2)), np.zeros((0, 2)), pose),
                          jrender.icp_debug_view(np.zeros((0, 2)), np.zeros((0, 2)), pose))


def _detections(rng, n, h, w, keypoints):
    x0, y0 = rng.uniform(-20, w - 10, n), rng.uniform(-20, h - 10, n)
    bw, bh = rng.uniform(0, 160, n), rng.uniform(0, 120, n)
    dets = {"boxes": np.stack([x0, y0, x0 + bw, y0 + bh], axis=1).astype(np.float32),
            "scores": rng.random(n).astype(np.float32), "classes": np.zeros(n, np.int32)}
    if keypoints:
        kx = rng.uniform(-5, w + 5, (n, 4))
        ky = rng.uniform(-5, h + 5, (n, 4))
        dets["keypoints"] = np.stack([kx, ky, rng.random((n, 4))], axis=-1).astype(np.float32)
    return dets


@pytest.mark.parametrize("seed", range(4))
def test_annotate_detections_matches_jax_outside_text(seed):
    """Boxes (some off the frame's edges, some a pixel or two wide), keypoint
    dots (some straddling an edge) and the readout panel."""
    rng = np.random.default_rng(seed)
    h, w = 240, 320
    frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    dets = _detections(rng, 6, h, w, keypoints=seed % 2 == 0)
    if seed == 3:
        dets["boxes"][:2, 2:] = dets["boxes"][:2, :2] + np.float32([[1.5, 0.2], [0.0, 3.0]])
    camera = None if seed == 1 else {"yaw_deg": -12.34, "distance_mm": 1520.6, "lateral_mm": -40.2,
                                     "direction": seed - 1}
    got = trender.annotate_detections(frame, dets, camera)
    want = jrender.annotate_detections(frame, dets, camera)
    assert got.shape == want.shape and got.dtype == np.uint8
    text = np.zeros(h, bool)
    for x0, y0, *_ in dets["boxes"]:
        top = int(max(0.0, float(y0) - 12))
        text[top:top + trender.TEXT_ROWS] = True
    if camera is not None:
        for i in range(4):
            text[6 + 13 * i:6 + 13 * i + trender.TEXT_ROWS] = True
    assert np.array_equal(got[~text], want[~text])
    assert (got[text] != frame[text]).any()  # the port's text is drawn


@pytest.mark.parametrize("a", range(0, 14))
def test_ellipse_masks_match_pil(a):
    from PIL import Image, ImageDraw

    for b in range(0, 14):
        im = Image.new("L", (20, 20))
        ImageDraw.Draw(im).ellipse([3, 3, 3 + a, 3 + b], fill=255)
        want = np.asarray(im) > 0
        got = np.zeros((20, 20), bool)
        got[3:4 + b, 3:4 + a] = trender._ellipse_mask(a, b)
        assert np.array_equal(got, want), (a, b)


def test_slam_artifacts_match_jax(tmp_path, rng):
    """The same state in both `Slam`s: `pose44`, `save_map`'s PNG and
    ``.npy``, `save_pcd`'s file."""
    cfg_t = tc.SlamConfig(map=tc.MapConfig(width_mm=6000.0, height_mm=6000.0), map_capacity=512, n_max=128)
    cfg_j = jc.SlamConfig(map=jc.MapConfig(width_mm=6000.0, height_mm=6000.0), map_capacity=512, n_max=128)
    valid = rng.random(512) < 0.6
    state = {"pose": np.float32([812.25, -301.5, 0.4]), "prev_pose": np.zeros(3, np.float32),
             "map_xy": rng.uniform(-2900, 2900, (512, 2)).astype(np.float32), "map_valid": valid,
             "occ": rng.random((cfg_t.map.height_px, cfg_t.map.width_px)).astype(np.float32),
             "prev_xy": np.zeros((128, 2), np.float32), "prev_valid": np.zeros(128, bool),
             "step": np.int32(5), "maint_count": np.int32(5), "reject_run": np.int32(0)}
    np.savez(tmp_path / "s.npz", **state)
    t, j = Slam(cfg_t, device="cpu"), japi.Slam(cfg_j)
    assert np.array_equal(t.pose44, np.eye(4, dtype=np.float32))
    t.load_state(str(tmp_path / "s.npz"))
    j.load_state(str(tmp_path / "s.npz"))
    assert t.pose44.dtype == np.float32
    np.testing.assert_allclose(t.pose44, j.pose44, rtol=0, atol=1e-6)  # float32 sin/cos of two libraries
    t.save_map(str(tmp_path / "t"))
    j.save_map(str(tmp_path / "j"))
    t.save_pcd(str(tmp_path / "t.pcd"))
    j.save_pcd(str(tmp_path / "j.pcd"))
    assert np.array_equal(decode_png((tmp_path / "t.png").read_bytes()), decode_png((tmp_path / "j.png").read_bytes()))
    assert np.array_equal(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"))
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    assert len(np.load(tmp_path / "t.npy")) == valid.sum()
