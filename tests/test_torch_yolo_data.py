"""The port's YOLO datasets (`io/yolo_data.py`) against the JAX package's:
label parsing, PIL's letterbox resize and polygon fill written in numpy,
and the batches of `DeviceYoloDataset` and `YoloDataset` for a seed.

Tolerances: parsers, letterboxed pixels, polygon masks and the host
dataset's batches equal; the device dataset's images within 2e-6 (the
zoom-out's antialiased bilinear resize: ``F.interpolate`` against
``jax.image.resize``, float32 weights summed in another order), its
labels within 1e-5 px and its masks equal."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from icp_slam_yolo_tpu.io import yolo_data as jdata
from icp_slam_yolo_tpu_torch.io import yolo_data as tdata
from icp_slam_yolo_tpu_torch.utils.images import encode_png

torch.set_num_threads(2)
TASK_LABELS = {"detect": "labels", "obb": "labels_poly", "segment": "labels_poly", "pose": "labels_pose"}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """`chip_smoke.pallet_dataset` at 120 x 160: 7 train frames, 3 val."""
    return chip_smoke.pallet_dataset(str(tmp_path_factory.mktemp("pallets")), seed=4, n_train=7, n_val=3, h=120, w=160)


def _write_labels(path, rows):
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def test_label_parsers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    rows = ["0 0.5 0.5 0.2 0.3", "1 0.1 0.2 0.4 0.25 0.35 0.6 0.05 0.5", "short 1", "",
            "2 " + " ".join(f"{v:.5f}" for v in rng.random(12))]
    _write_labels(tmp_path / "a.txt", rows)
    pose = ["0 0.5 0.5 0.4 0.3 0.3 0.35 2 0.7 0.36 2 0.71 0.64 2 0.29 0.65 0",   # tl, tr, br, bl
            "0 0.5 0.5 0.4 0.3 0.3 0.35 2 0.29 0.65 2 0.71 0.64 2 0.7 0.36 2",   # counter-clockwise
            "0 0.4 0.4 0.2 0.2 0.3 0.3 1 0.5 0.3 1 0.5 0.5 1 0.3 0.5 1", "bad row"]
    _write_labels(tmp_path / "p.txt", pose)
    for fn, path in ((tdata.parse_label_file, "a.txt"), (tdata.parse_polygons, "a.txt"), (tdata.parse_pose_label, "p.txt"),
                     (tdata.parse_label_file, "missing.txt")):
        got, want = fn(str(tmp_path / path)), getattr(jdata, fn.__name__)(str(tmp_path / path))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, list):
                assert len(g) == len(w) and all(np.array_equal(a, b) for a, b in zip(g, w))
            else:
                assert g.dtype == w.dtype and np.array_equal(g, w)
    for poly in rng.uniform(0, 1, (50, 4, 2)):
        assert tdata.polygon_angle(poly) == jdata.polygon_angle(poly)
        for w0, h0, s in ((640, 480, 64), (517, 333, 640), (200, 150, 640)):
            assert np.array_equal(tdata.map_polygon(poly, w0, h0, s), jdata.map_polygon(poly, w0, h0, s))
    assert tdata.KPT_FLIP_PERM.tolist() == jdata.KPT_FLIP_PERM.tolist()
    assert tdata.LETTERBOX_FILL == jdata.LETTERBOX_FILL


def test_find_pairs_matches_jax(dataset):
    for args in ((f"{dataset}/train",), (f"{dataset}/train/images", f"{dataset}/train/labels_pose"),
                 (f"{dataset}/train/images",)):
        assert tdata.find_pairs(*args) == jdata.find_pairs(*args)


@pytest.mark.parametrize("shape", [(480, 640), (333, 517), (150, 200), (64, 64)])
@pytest.mark.parametrize("size", [64, 640])
def test_letterbox_equals_pil(tmp_path, shape, size):
    """The letterboxed pixels of a PNG frame equal the JAX package's PIL
    path (downscales, an upscale, an unchanged size)."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(encode_png(img))
    want = jdata.letterbox_image(Image.open(path).convert("RGB"), size)
    got = tdata.letterbox_image(tdata.to_rgb(tdata.read_image(path)), size)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_resize_bilinear_equals_pil_on_gray_and_odd_sizes():
    rng = np.random.default_rng(7)
    for (h, w), (nw, nh) in (((37, 91), (13, 5)), ((5, 7), (300, 211)), ((100, 100), (33, 67)), ((9, 400), (400, 9))):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
        assert np.array_equal(tdata.resize_bilinear(img, nw, nh), want)


def _hull(p):
    p = sorted(map(tuple, p))

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lo, up = [], []
    for q in p:
        while len(lo) >= 2 and cross(lo[-2], lo[-1], q) <= 0:
            lo.pop()
        lo.append(q)
    for q in reversed(p):
        while len(up) >= 2 and cross(up[-2], up[-1], q) <= 0:
            up.pop()
        up.append(q)
    return np.array(lo[:-1] + up[:-1])


def test_rasterize_polygon_equals_pil():
    """Seeded polygons: turned rectangles (the labels' shape), axis-aligned
    rectangles, convex hulls with float and integer vertices (either
    orientation) and self-intersecting ones, partly outside the mask."""
    rng = np.random.default_rng(11)
    n_checked = 0
    for t in range(1000):
        size = int(rng.integers(8, 80))
        kind = t % 5
        if kind == 0:
            c, (w, h), a = rng.uniform(0, size, 2), rng.uniform(1, size, 2), rng.uniform(0, np.pi)
            rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
            poly = c + np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2 @ rot.T
        elif kind == 1:
            x0, y0 = rng.uniform(-2, size, 2)
            x1, y1 = x0 + rng.uniform(0, size), y0 + rng.uniform(0, size)
            poly = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
        elif kind == 2:
            poly = _hull(rng.uniform(-5, size + 5, (int(rng.integers(3, 12)), 2)))
        elif kind == 3:
            poly = _hull(rng.integers(-3, size + 3, (int(rng.integers(3, 12)), 2)).astype(float))
            poly = poly[::-1] if rng.random() < 0.5 else poly
        else:
            poly = rng.uniform(-3, size + 3, (int(rng.integers(3, 7)), 2))
        if len(poly) < 3:
            continue
        want = jdata.rasterize_polygon(poly, size)
        got = tdata.rasterize_polygon(poly, size)
        assert got.dtype == want.dtype and np.array_equal(got, want), (kind, size, poly.tolist())
        n_checked += 1
    assert n_checked > 950


def _jax_batch(b):
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("task", ["detect", "obb", "segment", "pose"])
def test_device_dataset_batches_match_jax(dataset, task):
    """Three batches from one seed, with the flip and the zoom-out on."""
    pairs = tdata.find_pairs(f"{dataset}/train/images", label_root=f"{dataset}/train/{TASK_LABELS[task]}")
    kw = dict(img_size=64, batch_size=4, max_gt=4, seed=3, augment=True, task=task, pairs=pairs,
              scale_aug=(0.5, 0.67, 0.83, 1.0))
    want = jdata.DeviceYoloDataset("", **kw)
    got = tdata.DeviceYoloDataset("", device="cpu", **kw)
    draws = tdata.DeviceYoloDataset("", device="cpu", **kw)
    d = np.concatenate([draws.draws() for _ in range(3)], axis=1)
    assert d[1].any() and not d[1].all() and (d[2] != 3).any()  # flips and zooms both happen in these batches
    for n, (w, g) in enumerate(zip(iter(want), iter(got))):
        w, g = _jax_batch(w), {k: v.numpy() for k, v in g.items()}
        assert set(w) == set(g)
        for k in w:
            assert w[k].shape == g[k].shape and w[k].dtype == g[k].dtype, k
        np.testing.assert_allclose(g["images"], w["images"], atol=2e-6, rtol=0)
        for k in ("boxes", "angles", "kpts"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=0, err_msg=k)
        for k in ("classes", "valid", "masks"):
            if k in w:
                assert np.array_equal(g[k], w[k]), k
        if n == 2:
            break
    # the draws were the same: both generators are at the same point
    assert np.array_equal(got.rng.random(4), want.rng.random(4))


@pytest.mark.parametrize("task", ["detect", "obb", "pose"])
def test_host_dataset_batches_match_jax(dataset, tmp_path, task):
    """`YoloDataset` reads ``root/{images,labels}``: a root a task, with
    the task's labels as ``labels``."""
    root = tmp_path / task
    root.mkdir()
    os.symlink(f"{dataset}/train/images", root / "images")
    os.symlink(f"{dataset}/train/{TASK_LABELS[task]}", root / "labels")
    kw = dict(img_size=64, batch_size=3, max_gt=4, seed=5, augment=True, task=task)
    for n, (w, g) in enumerate(zip(iter(jdata.YoloDataset(str(root), **kw)), iter(tdata.YoloDataset(str(root), **kw)))):
        assert set(w) == set(g)
        for k in w:
            assert w[k].dtype == g[k].dtype and np.array_equal(w[k], g[k]), k
        if n == 2:
            break


def test_masks_and_keypoints_reach_the_batch(dataset):
    """Sanity of the labels the datasets carry: masks with pixels set inside
    each valid box, keypoints at the box's corners."""
    pairs = tdata.find_pairs(f"{dataset}/train/images", label_root=f"{dataset}/train/labels_poly")
    b = next(iter(tdata.DeviceYoloDataset("", img_size=64, batch_size=2, max_gt=4, task="segment", pairs=pairs,
                                          device="cpu")))
    area = b["masks"].sum(dim=(2, 3))
    assert bool((area[b["valid"]] > 0).all()) and bool((area[~b["valid"]] == 0).all())
    pairs = tdata.find_pairs(f"{dataset}/train/images", label_root=f"{dataset}/train/labels_pose")
    b = next(iter(tdata.DeviceYoloDataset("", img_size=64, batch_size=2, max_gt=4, task="pose", pairs=pairs,
                                          device="cpu")))
    v = b["valid"]
    kx, bx = b["kpts"][..., 0][v], b["boxes"][v]
    assert bool((kx.min(-1).values >= bx[:, 0] - 1e-3).all()) and bool((kx.max(-1).values <= bx[:, 2] + 1e-3).all())


def test_jpeg_is_refused_by_name(tmp_path):
    """A JPEG dataset loads as JAX's does (the name is the refusal this test
    checked before the port decoded JPEG): the examples the port loads
    from ``.jpg``/``.jpeg`` frames (4:2:0, progressive 4:2:2, gray) equal
    the JAX package's `load_example` (PIL's decode and letterbox), and the
    device dataset reads them."""
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    rng = np.random.default_rng(8)
    opts = [dict(quality=90), dict(quality=80, subsampling=1, progressive=True), dict(quality=85)]
    for i, kw in enumerate(opts):
        img, corners = chip_smoke.pallet_image(rng, 120, 160)
        im = Image.fromarray(img).convert("L") if i == 2 else Image.fromarray(img)
        im.save(tmp_path / "images" / f"frame_{i}.{'jpeg' if i == 1 else 'jpg'}", **kw)
        lo, hi = corners[0].min(0) / [160, 120], corners[0].max(0) / [160, 120]
        _write_labels(tmp_path / "labels" / f"frame_{i}.txt",
                      [f"0 {(lo[0] + hi[0]) / 2:.6f} {(lo[1] + hi[1]) / 2:.6f} {hi[0] - lo[0]:.6f} {hi[1] - lo[1]:.6f}"])
    pairs = tdata.find_pairs(str(tmp_path))
    assert pairs == jdata.find_pairs(str(tmp_path)) and len(pairs) == 3
    for pair in pairs:
        got, want = tdata.load_example(*pair, 64), jdata.load_example(*pair, 64)
        assert np.array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    batch = next(iter(tdata.DeviceYoloDataset(str(tmp_path), img_size=64, batch_size=3, device="cpu")))
    assert tuple(batch["images"].shape) == (3, 64, 64, 3)
