"""The image helpers of the port's `utils/images.py` against the JAX
package's (`icp_slam_yolo_tpu.utils.images`, which uses PIL): resizes
bit-equal (PIL's bicubic and bilinear filters in fixed point), the HSV
helpers and the directory helpers equal, JPEG writes (the port's encoder
at PIL's save defaults) decoded to PIL's pixels, and the MJPEG video's
container and frames."""

import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from icp_slam_yolo_tpu.utils import images as jimages
from icp_slam_yolo_tpu_torch.utils import images

FRAME = chip_smoke.synthetic_frame(11)


def _same_decoded(got: np.ndarray, want: np.ndarray):
    """Two encoders' output for one image, decoded: the port's encoder does
    libjpeg's arithmetic, so the pixels are equal (the bytes are not)."""
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["bicubic", "bilinear"])
@pytest.mark.parametrize("shape,size", [((37, 91), (13, 5)), ((5, 7, 3), (300, 211)), ((100, 100, 3), (33, 67)),
                                        ((9, 400), (400, 9)), ((480, 640, 3), (640, 640)), ((2, 3, 3), (1, 1))])
def test_resize_equals_pil(kind, shape, size):
    img = np.random.default_rng(shape[0] * 7 + size[0]).integers(0, 256, shape, dtype=np.uint8)
    fn = images.resize_bicubic if kind == "bicubic" else images.resize_bilinear
    want = Image.fromarray(img).resize(size, Image.BICUBIC if kind == "bicubic" else Image.BILINEAR)
    assert np.array_equal(fn(img, *size), np.asarray(want))
    if kind == "bicubic":  # PIL's default filter
        assert np.array_equal(fn(img, *size), np.asarray(Image.fromarray(img).resize(size)))


@pytest.mark.parametrize("width", [200, 640, 1000])
def test_resize_to_width_and_exact_equal_jax(width):
    for img in (FRAME, FRAME[..., 0], FRAME[:97, :333]):
        got, f = images.resize_to_width(img, width)
        want, g = jimages.resize_to_width(img, width)
        assert f == g and np.array_equal(got, want)
        got, f = images.resize_to_width_exact(img, width)
        want, g = jimages.resize_to_width_exact(img, width)
        assert f == g and np.array_equal(got, want)


@pytest.mark.parametrize("bgr", [False, True])
def test_resize_frame_equals_jax(bgr):
    for size in ((320, 240), (641, 479), (64, 64)):
        assert np.array_equal(images.resize_frame(FRAME, size, bgr), jimages.resize_frame(FRAME, size, bgr))


@pytest.mark.parametrize("ext", [".png", ".jpg", ".jpeg"])
def test_load_resized_equals_jax(ext, tmp_path):
    path = str(tmp_path / ("f" + ext))
    Image.fromarray(FRAME).save(path, format="PNG" if ext == ".png" else "JPEG")
    assert np.array_equal(images.load_resized(path, (200, 150)), jimages.load_resized(path, (200, 150)))
    Image.fromarray(FRAME[..., 0]).save(path, format="PNG" if ext == ".png" else "JPEG")  # gray -> RGB
    assert np.array_equal(images.load_resized(path, (99, 61)), jimages.load_resized(path, (99, 61)))


def test_resize_images_equal_jax(tmp_path):
    """PNG outputs equal to PIL's pixels; JPEG outputs (PIL's save defaults,
    quality 75 and 4:2:0, against the port's encoder) decoded equal; other
    files skipped."""
    src = tmp_path / "src"
    src.mkdir()
    Image.fromarray(FRAME).save(src / "a.png")
    Image.fromarray(FRAME[100:300, 50:400]).save(src / "b.jpg")
    Image.fromarray(FRAME[..., 2]).save(src / "c.JPEG")
    (src / "notes.txt").write_text("not an image")
    assert images.resize_images(str(src), str(tmp_path / "t"), (160, 120)) == 3
    assert jimages.resize_images(str(src), str(tmp_path / "j"), (160, 120)) == 3
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == ["a.png", "b.jpg", "c.JPEG"]
    assert np.array_equal(images.read_image(str(tmp_path / "t" / "a.png")),
                          np.asarray(Image.open(tmp_path / "j" / "a.png")))
    for name in ("b.jpg", "c.JPEG"):
        got = np.asarray(Image.open(tmp_path / "t" / name))
        want = np.asarray(Image.open(tmp_path / "j" / name))
        _same_decoded(got, want)


def _avi_frames(path: str) -> tuple[dict, list[bytes]]:
    """The ``avih`` header's fields and the ``00dc`` JPEG payloads."""
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    i = data.index(b"avih")
    fields = struct.unpack("<14I", data[i + 8:i + 8 + 56])
    frames, pos = [], data.index(b"movi") + 4
    while data[pos:pos + 4] == b"00dc":
        (n,) = struct.unpack("<I", data[pos + 4:pos + 8])
        frames.append(data[pos + 8:pos + 8 + n])
        pos += 8 + n + (n & 1)
    assert data[pos:pos + 4] == b"idx1"
    return dict(zip(("usec", "rate", "pad", "flags", "frames", "init", "streams", "buf", "w", "h"), fields)), frames


def test_images_to_video_round_trip_and_matches_jax(tmp_path):
    """The same frames (an array, a file, a directory) through both
    packages: the container's fields equal but the sizes that count JPEG
    bytes, every frame decoded by the port as PIL decodes it, and the
    port's frames decoded equal to PIL's."""
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(3):
        Image.fromarray(chip_smoke.synthetic_frame(20 + i)[:240, :320]).save(d / f"{i}.png")
    frames = [chip_smoke.synthetic_frame(30)[:240, :320], str(d / "0.png"), chip_smoke.synthetic_frame(31)]
    for src in (frames, str(d)):
        n = images.images_to_video(src, str(tmp_path / "t.avi"), fps=12.0)
        assert n == jimages.images_to_video(src, str(tmp_path / "j.avi"), fps=12.0) == 3
        (th, tf), (jh, jf) = _avi_frames(str(tmp_path / "t.avi")), _avi_frames(str(tmp_path / "j.avi"))
        assert {k: v for k, v in th.items() if k not in ("rate", "buf")} == {
            k: v for k, v in jh.items() if k not in ("rate", "buf")}
        assert th["w"] == 320 and th["h"] == 240 and th["frames"] == 3
        for a, b in zip(tf, jf):
            assert np.array_equal(images.decode_jpeg(a), np.asarray(Image.open(io.BytesIO(a))))
            assert np.array_equal(images.decode_jpeg(b), np.asarray(Image.open(io.BytesIO(b))))
            _same_decoded(images.decode_jpeg(a), images.decode_jpeg(b))
    with pytest.raises(ValueError, match="no frames"):
        images.images_to_video([], str(tmp_path / "none.avi"))


def test_hsv_helpers_equal_jax():
    lower, upper = (0, 40, 60), (30, 255, 255)
    for img in (FRAME, FRAME[::7, ::5]):
        np.testing.assert_array_equal(images.rgb_to_hsv(img), jimages.rgb_to_hsv(img))
        assert np.array_equal(images.hsv_mask(img, lower, upper), jimages.hsv_mask(img, lower, upper))
    small = FRAME[::4, ::4]
    for min_area in (1, 50):
        boxes = images.hsv_edge_boxes(small, lower, upper, min_area)
        assert boxes == jimages.hsv_edge_boxes(small, lower, upper, min_area) and len(boxes) > 0


def test_directory_helpers_equal_jax(tmp_path):
    for name in ("b.png", "a.txt", "c"):
        (tmp_path / name).write_text("x")
    assert images.list_dir_paths(str(tmp_path)) == jimages.list_dir_paths(str(tmp_path))
    assert images.list_dir_paths(str(tmp_path / "missing")) == [] == jimages.list_dir_paths(str(tmp_path / "missing"))
    for reset in (images.reset_directory, jimages.reset_directory):
        target = tmp_path / "out"
        target.mkdir(exist_ok=True)
        (target / "old.txt").write_text("x")
        reset(str(target))
        assert os.listdir(target) == []
        reset(str(tmp_path / "new" / "deep"))
        assert os.path.isdir(tmp_path / "new" / "deep")
