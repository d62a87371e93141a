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
    Image.fromarray(np.full((4, 4), 300, np.uint16)).save(buf, format="PNG")  # PIL writes I;16 as 16-bit gray
    with pytest.raises(ValueError, match="16-bit PNG"):
        images.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="uint8"):
        images.encode_png(np.zeros((2, 2), np.float32))


# ------------------------------------------------ what PIL's convert reads
#
# Each file below is read by the port (`read_image` -> `to_rgb`, and the
# map loader) and by PIL (``convert("RGB")``, ``convert("L")``), and the
# pixels must be equal.  PIL writes the palette, 1-bit, tRNS and CMYK
# files; PIL writes no 2- or 4-bit gray and no interlaced PNG, so `_png`
# below writes those, and PIL's reading of its bytes is the judge.

def _png_chunk(kind: bytes, body: bytes) -> bytes:
    import struct
    import zlib

    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filtered(rows: np.ndarray, bpp: int) -> bytes:
    """Rows of packed bytes, filtered with types 0-4 in turn."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y, cur in enumerate(rows.astype(np.int64)):
        kind = y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])[:len(cur)]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[:len(cur)]
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
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def _png(samples: np.ndarray, color: int, depth: int, interlace: bool, palette=None, trns=None) -> bytes:
    """A PNG of ``samples (H, W, C)`` (values below ``2**depth``), written
    with Adam7's seven passes when ``interlace``."""
    import struct
    import zlib

    h, w, c = samples.shape
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)) \
        if interlace else ((0, 0, 1, 1),)
    body = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        flat = sub.reshape(sub.shape[0], -1)
        if depth < 8:
            bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
            rows = np.packbits(bits.reshape(flat.shape[0], -1), axis=1)
        else:
            rows = flat.astype(np.uint8)
        body += _filtered(rows, max(1, c * depth // 8))
    data = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        data += _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += _png_chunk(b"tRNS", np.asarray(trns, np.uint8).tobytes())
    return data + _png_chunk(b"IDAT", zlib.compress(body)) + _png_chunk(b"IEND", b"")


def _frame(shape, seed: int) -> np.ndarray:
    """A seeded RGB frame of any size: gradients and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = np.stack([yy * 7 + xx * 3, 200 - yy * 2, xx * 5 + 40], axis=-1)
    return ((base + rng.integers(0, 40, (*shape, 3))) % 256).astype(np.uint8)


def _assert_reads_as_pil(path) -> None:
    """`read_image` + `to_rgb` give PIL's ``convert("RGB")``; the port's
    map loader gives the JAX package's (PIL's ``convert("L")``)."""
    from icp_slam_yolo_tpu_torch.io import maps as pmaps

    path = str(path)
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"))
    assert np.array_equal(images.to_rgb(images.read_image(path)), rgb)
    assert np.array_equal(pmaps.load_occupancy_png(path), jmaps.load_occupancy_png(path))


@pytest.mark.parametrize("colors", [2, 4, 16, 200])
@pytest.mark.parametrize("transparency", [None, "index", "table"])
def test_pil_palette_pngs_read_as_pil(tmp_path, colors, transparency, rng):
    """PIL writes 1-, 2-, 4- and 8-bit palette PNGs (2, 4, 16 and 200
    colours), with no ``tRNS``, one transparent index, or an alpha table."""
    frame = _frame((37, 53), 3)
    im = Image.fromarray(frame).quantize(colors)
    kw = {}
    if transparency == "index":
        kw["transparency"] = 1
    elif transparency == "table":
        kw["transparency"] = bytes(rng.integers(0, 256, colors // 2 + 1, dtype=np.uint8))
    im.save(tmp_path / "p.png", **kw)
    data = (tmp_path / "p.png").read_bytes()
    assert data[24] == {2: 1, 4: 2, 16: 4, 200: 8}[colors] and data[25] == 3  # IHDR: depth, colour type 3
    assert (b"tRNS" in data) == (transparency is not None)
    _assert_reads_as_pil(tmp_path / "p.png")


def test_short_palette_and_indices_past_it(tmp_path):
    """An index past a 3-colour palette reads black, as in PIL."""
    data = _png(np.arange(16, dtype=np.uint8).reshape(2, 8, 1), 3, 4, False,
                palette=[[10, 20, 30], [200, 100, 50], [7, 8, 9]], trns=[128])
    (tmp_path / "s.png").write_bytes(data)
    _assert_reads_as_pil(tmp_path / "s.png")


def test_pil_one_bit_png_reads_as_pil(tmp_path, rng):
    Image.fromarray(rng.random((29, 43)) > 0.5).save(tmp_path / "b.png")
    assert (tmp_path / "b.png").read_bytes()[24:26] == bytes([1, 0])
    _assert_reads_as_pil(tmp_path / "b.png")


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("with_trns", [False, True])
def test_low_bit_gray_pngs_read_as_pil(tmp_path, depth, with_trns, rng):
    samples = rng.integers(0, 1 << depth, (17, 31, 1), dtype=np.uint8)
    (tmp_path / "g.png").write_bytes(_png(samples, 0, depth, False, trns=[0, 1] if with_trns else None))
    _assert_reads_as_pil(tmp_path / "g.png")


_ADAM7_CASES = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (6, 8)]


@pytest.mark.parametrize("color,depth", _ADAM7_CASES, ids=[f"type{c}-{d}bit" for c, d in _ADAM7_CASES])
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (9, 17), (23, 40)])
def test_adam7_interlaced_pngs_read_as_pil(tmp_path, color, depth, shape, rng):
    """Every colour type at every depth the port reads, Adam7-interlaced
    (sizes that leave some passes empty), each pass's rows filtered with
    types 0-4 in turn."""
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    samples = rng.integers(0, 1 << depth, (*shape, chans), dtype=np.uint8)
    palette = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8) if color == 3 else None
    trns = rng.integers(0, 256, 1 << (depth - 1), dtype=np.uint8) if color == 3 else None
    data = _png(samples, color, depth, True, palette=palette, trns=trns)
    (tmp_path / "i.png").write_bytes(data)
    _assert_reads_as_pil(tmp_path / "i.png")
    flat = images.decode_png(_png(samples, color, depth, False, palette=palette, trns=trns))
    assert np.array_equal(images.decode_png(data), flat)


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("shape", [(5, 7), (37, 53), (120, 160)])
def test_pil_cmyk_jpegs_read_as_pil(tmp_path, quality, shape, rng):
    """PIL writes CMYK JPEGs with an Adobe marker of transform 0 and the
    inks inverted; the port gives PIL's ``convert("RGB")`` and ``("L")``."""
    frame = _frame(shape, 5)
    ink = np.concatenate([255 - frame, rng.integers(0, 256, (*shape, 1), dtype=np.uint8)], axis=-1)
    Image.fromarray(ink, "CMYK").save(tmp_path / "c.jpg", quality=quality)
    with Image.open(tmp_path / "c.jpg") as im:
        assert im.mode == "CMYK" and im.info.get("adobe_transform") == 0
    _assert_reads_as_pil(tmp_path / "c.jpg")


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
