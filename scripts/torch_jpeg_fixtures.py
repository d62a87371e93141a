"""Write the JPEG fixtures of the port's decoder: files that PIL (on
libjpeg-turbo) encodes, and the digest of the pixels PIL decodes from each.

    python3 scripts/torch_jpeg_fixtures.py [--out tests/data/torch_jpeg]

Writes ``*.jpg`` and ``pixels.json`` (each file's decoded ``shape`` and the
sha256 of the array's bytes).  ``chip_smoke.py`` (phase 13) decodes the
files with `utils.images.decode_jpeg` on a machine without PIL and holds
them to the digests; ``tests/test_torch_jpeg.py`` holds the digests to the
installed PIL.  Run it again, and commit what it writes, when the installed
PIL or its libjpeg changes what it decodes (that test then fails).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image, ImageFile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import synthetic_frame  # noqa: E402

SMALL = (61, 83)  # odd sizes: MCUs cut at both edges
# name -> (which frame, mode, save options)
FIXTURES = {
    "baseline_420.jpg": ("small", "RGB", dict(quality=85, subsampling=2)),
    "baseline_422.jpg": ("small", "RGB", dict(quality=85, subsampling=1)),
    "baseline_444.jpg": ("small", "RGB", dict(quality=85, subsampling=0)),
    "gray.jpg": ("small", "L", dict(quality=85)),
    "progressive_420.jpg": ("small", "RGB", dict(quality=90, subsampling=2, progressive=True)),
    "restart_420.jpg": ("small", "RGB", dict(quality=90, subsampling=2, restart_marker_blocks=3)),
    "optimized_420.jpg": ("small", "RGB", dict(quality=90, subsampling=2, optimize=True)),
    "frame_480x640_q95.jpg": ("frame", "RGB", dict(quality=95, subsampling=2)),
    "frame_480x640_q95_progressive.jpg": ("frame", "RGB", dict(quality=95, subsampling=2, progressive=True)),
}


def encode(name: str) -> bytes:
    """The bytes of one fixture, as PIL writes them."""
    which, mode, opts = FIXTURES[name]
    frame = synthetic_frame(5)
    img = frame[:SMALL[0], :SMALL[1]] if which == "small" else frame
    ImageFile.MAXBLOCK = max(ImageFile.MAXBLOCK, 1 << 22)  # restart markers need the whole file in one buffer
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="JPEG", **opts)
    return buf.getvalue()


def digest(data: bytes) -> dict:
    """The shape and sha256 of the pixels PIL decodes from ``data``."""
    arr = np.asarray(Image.open(io.BytesIO(data)))
    return {"shape": list(arr.shape), "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "tests", "data", "torch_jpeg"))
    out = parser.parse_args(argv).out
    os.makedirs(out, exist_ok=True)
    pixels = {}
    for name in FIXTURES:
        data = encode(name)
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        pixels[name] = digest(data)
    with open(os.path.join(out, "pixels.json"), "w") as f:
        json.dump(pixels, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(out, n)) for n in os.listdir(out))
    print(f"wrote {len(FIXTURES)} fixtures and pixels.json to {out} ({total} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
