"""`utils.images.decode_jpeg` against the installed PIL (libjpeg-turbo):
bit-equal pixels over a grid of files that PIL encodes (subsampling,
quality, progressive, optimized tables, restart intervals, sizes that cut
MCUs, noise, a camera-like frame and flat fields at the range limit), an
Adobe RGB file, the port's own encoder's output, the refusals by name,
`image_size`, and the committed fixtures of ``tests/data/torch_jpeg``
(``scripts/torch_jpeg_fixtures.py``) against PIL's decode here."""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image, ImageFile

import chip_smoke
from icp_slam_yolo_tpu_torch.utils import images

ImageFile.MAXBLOCK = 1 << 24  # PIL's encoder needs the whole file in one buffer for restart markers
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "gray": None}
_FRAME = chip_smoke.synthetic_frame(7)


def _content(kind: str, h: int, w: int) -> np.ndarray:
    if kind == "noise":
        return np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "frame":  # a crop across the frame's boxes and slats, or a whole frame
        return chip_smoke.synthetic_frame(7, h, w) if min(h, w) >= 240 else _FRAME[240:240 + h, 200:200 + w]
    return np.full((h, w, 3), 0 if kind == "flat0" else 255, np.uint8)


def _pil_jpeg(img: np.ndarray, sub: str, **opts) -> bytes:
    im = Image.fromarray(img)
    if sub == "gray":
        im = im.convert("L")
    else:
        opts["subsampling"] = SUBSAMPLING[sub]
    buf = io.BytesIO()
    im.save(buf, format="JPEG", **opts)
    return buf.getvalue()


def _assert_decodes_as_pil(data: bytes):
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = images.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), f"{int((got != want).sum())} samples differ"


@pytest.mark.parametrize("optimize", [False, True], ids=["tables", "optimized"])
@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
def test_small_files_decode_as_pil(sub, quality, progressive, optimize):
    """1 x 1, 7 x 9 and 17 x 33 (partial MCUs on both edges) of every
    content, in every mode of the grid."""
    for h, w in ((1, 1), (7, 9), (17, 33)):
        for kind in ("noise", "frame", "flat0", "flat255"):
            _assert_decodes_as_pil(_pil_jpeg(_content(kind, h, w), sub, quality=quality, progressive=progressive,
                                             optimize=optimize))


@pytest.mark.parametrize("restart", ["blocks", "rows"])
@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
def test_restart_intervals_decode_as_pil(sub, progressive, restart):
    """DRI/RSTn: an interval of 1 and 5 MCUs (``restart_marker_blocks``) or
    of 1 and 2 MCU rows (``restart_marker_rows``)."""
    for n in (1, 5) if restart == "blocks" else (1, 2):
        for h, w in ((17, 33), (40, 72)):
            _assert_decodes_as_pil(_pil_jpeg(_content("frame", h, w), sub, quality=80, progressive=progressive,
                                             **{f"restart_marker_{restart}": n}))


@pytest.mark.parametrize("content", ["noise", "frame", "flat0", "flat255"])
@pytest.mark.parametrize("mode", [("4:2:0", 75, False, False, {}), ("4:2:2", 95, True, False, {}),
                                  ("gray", 50, False, True, {"restart_marker_rows": 3}),
                                  ("4:4:4", 100, True, True, {})],
                         ids=["420-q75", "422-q95-progressive", "gray-q50-optimized-restart", "444-q100-progressive"])
def test_479x641_decodes_as_pil(mode, content):
    sub, quality, progressive, optimize, extra = mode
    _assert_decodes_as_pil(_pil_jpeg(_content(content, 479, 641), sub, quality=quality, progressive=progressive,
                                     optimize=optimize, **extra))


def test_adobe_rgb_file_is_rgb_as_stored():
    """``keep_rgb`` writes an Adobe APP14 marker with transform 0 and no
    JFIF: the samples are RGB, not YCbCr."""
    data = _pil_jpeg(_content("frame", 40, 56), "4:4:4", quality=90, keep_rgb=True)
    assert b"Adobe" in data[:200] and b"JFIF" not in data[:200]
    _assert_decodes_as_pil(data)


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4", "gray"])
def test_port_encoder_gives_pils_pixels(subsampling, quality):
    """The port's `encode_jpeg` output decodes as PIL decodes it, and to the
    pixels of PIL's own save at the same quality and subsampling (the same
    colour conversion, downsampling, DCT and quantisation as libjpeg)."""
    for content in ("frame", "noise"):
        for h, w in ((7, 9), (40, 24), (120, 160), (123, 217)):
            img = _content(content, h, w)
            img = img[..., 1] if subsampling == "gray" else img
            data = images.encode_jpeg(img, quality=quality, subsampling="4:4:4" if subsampling == "4:4:4" else "4:2:0")
            _assert_decodes_as_pil(data)
            assert np.array_equal(images.decode_jpeg(data),
                                  images.decode_jpeg(_pil_jpeg(img if subsampling != "gray" else np.stack([img] * 3, -1),
                                                               subsampling, quality=quality)))


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _frame_header(marker: int, precision: int = 8, n: int = 3, adobe: int | None = None) -> bytes:
    comps = b"".join(bytes([i + 1, 0x11, 0]) for i in range(n))
    app14 = b"" if adobe is None else _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe]))
    return b"\xff\xd8" + app14 + _segment(marker, struct.pack(">BHHB", precision, 16, 16, n) + comps) + b"\xff\xd9"


@pytest.mark.parametrize("data,match", [
    (_frame_header(0xC9), "arithmetic-coded"),
    (_frame_header(0xC3), "lossless"),
    (_frame_header(0xC5), "hierarchical"),
    (_frame_header(0xC1, precision=12), "12-bit"),
    (_frame_header(0xC0, n=4, adobe=2), "YCCK"),
    (_frame_header(0xC0, n=4, adobe=1), "YCCK"),
], ids=["sof9", "sof3", "sof5", "12-bit", "cmyk", "ycck-transform-1"])
def test_refused_by_name(data, match):
    with pytest.raises(ValueError, match=match):
        images.decode_jpeg(data)


@pytest.mark.parametrize("cut", [0.5, 0.95])
def test_truncated_file_is_refused(cut):
    """PIL refuses these too (``image file is truncated``)."""
    data = _pil_jpeg(_content("frame", 64, 96), "4:2:0", quality=90)
    data = data[:int(len(data) * cut)]
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match="truncated"):
        images.decode_jpeg(data)


@pytest.mark.parametrize("kind", ["png-rgb", "png-gray", "jpeg", "jpeg-progressive", "jpeg-exif"])
def test_image_size_equals_pil(kind, tmp_path):
    img = _content("frame", 37, 59)
    path = str(tmp_path / ("x.png" if kind.startswith("png") else "x.jpg"))
    im = Image.fromarray(img[..., 0] if kind == "png-gray" else img)
    opts = {"progressive": True} if kind == "jpeg-progressive" else {}
    if kind == "jpeg-exif":
        exif = Image.Exif()
        exif[0x010F] = "camera"
        opts["exif"] = exif
    im.save(path, **opts)
    assert images.image_size(path) == Image.open(path).size == (59, 37)


def test_read_image_takes_jpeg_extensions(tmp_path):
    img = _content("frame", 30, 40)
    for name in ("a.jpg", "b.JPEG"):
        Image.fromarray(img).save(tmp_path / name, format="JPEG")
        assert np.array_equal(images.read_image(str(tmp_path / name)), np.asarray(Image.open(tmp_path / name)))
    (tmp_path / "c.jpg").write_bytes(_frame_header(0xC9))
    with pytest.raises(ValueError, match="c.jpg: arithmetic"):
        images.read_image(str(tmp_path / "c.jpg"))


def test_committed_fixtures_hold_pils_pixels():
    """The digests in ``pixels.json`` are PIL's decode here, and the port's
    decode gives the same arrays (the card's run holds its decode to the
    same digests); the fixtures stay under 1 MB."""
    with open(os.path.join(FIXTURES, "pixels.json")) as f:
        digests = json.load(f)
    assert len(digests) >= 9
    total = 0
    for name, entry in digests.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        total += len(data)
        for arr in (np.asarray(Image.open(io.BytesIO(data))), images.decode_jpeg(data)):
            assert list(arr.shape) == entry["shape"]
            assert hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest() == entry["sha256"], name
    assert total < 1 << 20
