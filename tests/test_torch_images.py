"""The port's image codecs (`utils/images.py`) against an independent codec
(PIL): PNG both ways, the port's baseline JPEG decoded by PIL, and
`read_image`'s formats (JPEG decoded as PIL decodes it).

Tolerances: decoded PNGs equal bytes; JPEG at quality 90 at least 30 dB
PSNR on a seeded camera-like frame, and a flat frame within 1 level of its
value (what the DCT's rounding and the colour conversion leave)."""

import io

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from icp_slam_yolo_tpu.io import maps as jmaps
from icp_slam_yolo_tpu_torch.utils import images


def _pil_png(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (37, 53, 4), (1, 1), (1, 200, 3)])
def test_encode_png_decodes_equal_in_pil(shape, rng):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    data = images.encode_png(img)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    assert np.array_equal(images.decode_png(data), img)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "frame"])
def test_pil_png_decodes_equal(mode, rng):
    """PIL filters rows adaptively (here Sub, Up and Paeth rows); the
    decoder undoes them (all five types: the next test)."""
    if mode == "frame":
        frame = chip_smoke.synthetic_frame(1)
        assert np.array_equal(images.decode_png(_pil_png(frame)), frame)
        return
    yy, xx = np.mgrid[0:64, 0:96]
    base = (yy * 3 + xx * 2 + rng.integers(0, 9, (64, 96))) % 256
    chans = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    img = np.stack([(base + 40 * c) % 256 for c in range(chans)], axis=-1).astype(np.uint8)
    img = img[..., 0] if chans == 1 else img
    data = _pil_png(img)
    assert np.array_equal(images.decode_png(data), img)


def test_every_filter_type_is_undone(rng):
    """A PNG whose rows use filter types 0-4 in turn (written here by hand)
    reads equal in PIL and in the port."""
    import struct
    import zlib

    h, w, bpp = 10, 13, 3
    img = rng.integers(0, 256, (h, w, bpp), dtype=np.uint8)
    rows, prev = [], np.zeros(w * bpp, np.int64)
    for y in range(h):
        kind, cur = y % 5, img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))
    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    assert np.array_equal(images.decode_png(data), img)


def test_jax_occupancy_png_decodes_equal(tmp_path, rng):
    occ = rng.random((60, 80)).astype(np.float32)
    path = str(tmp_path / "occ.png")
    jmaps.save_occupancy_png(occ, path)
    with open(path, "rb") as f:
        assert np.array_equal(images.decode_png(f.read()), jmaps.occupancy_to_image(occ))


def test_png_refusals():
    with pytest.raises(ValueError, match="not a PNG"):
        images.decode_png(b"GIF89a....")
    buf = io.BytesIO()
    Image.new("P", (4, 4)).save(buf, format="PNG")
    with pytest.raises(ValueError, match="colour type 3"):
        images.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="uint8"):
        images.encode_png(np.zeros((2, 2), np.float32))


def _psnr(a, b) -> float:
    return float(10 * np.log10(255.0**2 / np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)))


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
def test_jpeg_decodes_in_pil_at_30_db(subsampling):
    frame = chip_smoke.synthetic_frame(7)
    data = images.encode_jpeg(frame, quality=90, subsampling=subsampling)
    decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert decoded.shape == frame.shape
    assert _psnr(decoded, frame) >= 30.0
    assert chip_smoke.jpeg_size(data) == frame.shape[:2]


@pytest.mark.parametrize("shape,value", [((48, 64, 3), (120, 60, 200)), ((37, 53, 3), (0, 255, 17)),
                                         ((21, 30), (90,))])
def test_flat_jpeg_within_one_level(shape, value):
    frame = np.zeros(shape, np.uint8) + np.array(value, np.uint8)
    decoded = np.asarray(Image.open(io.BytesIO(images.encode_jpeg(frame, quality=90)))).astype(int)
    assert decoded.shape == frame.shape
    assert np.abs(decoded - frame).max() <= 1


def test_read_image_formats(tmp_path, rng):
    img = rng.integers(0, 256, (8, 9, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    np.save(tmp_path / "b.npy", img)
    Image.fromarray(img).save(tmp_path / "c.jpg")
    assert np.array_equal(images.read_image(str(tmp_path / "a.png")), img)
    assert np.array_equal(images.read_image(str(tmp_path / "b.npy")), img)
    assert np.array_equal(images.read_image(str(tmp_path / "c.jpg")), np.asarray(Image.open(tmp_path / "c.jpg")))
    (tmp_path / "d.gif").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="d.gif"):
        images.read_image(str(tmp_path / "d.gif"))
