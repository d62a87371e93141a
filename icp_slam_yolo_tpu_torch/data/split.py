"""Dataset splitter; a copy of the JAX package's ``data/split.py``
(`labels_segmentation/chia.py:5-45` parity).

Shuffled train/val copy of an images+labels pool into the YOLO layout
(``out/{train,val}/{images,labels}``), default 80/20 at seed 42 like the
reference.
"""

from __future__ import annotations

import os
import random
import shutil

_IMG_EXTS = (".jpg", ".jpeg", ".png")


def split_dataset(source: str, output: str, train_ratio: float = 0.8, seed: int = 42):
    """Returns ``(n_train, n_val)``."""
    img_dir = os.path.join(source, "images")
    lbl_dir = os.path.join(source, "labels")
    if not os.path.isdir(img_dir):
        img_dir = lbl_dir = source  # flat layout: txt next to jpg

    stems = [
        os.path.splitext(n)[0]
        for n in sorted(os.listdir(img_dir))
        if os.path.splitext(n)[1].lower() in _IMG_EXTS
    ]
    rng = random.Random(seed)
    rng.shuffle(stems)
    n_train = int(len(stems) * train_ratio)
    splits = {"train": stems[:n_train], "val": stems[n_train:]}

    for split, names in splits.items():
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(output, split, sub), exist_ok=True)
        for stem in names:
            for ext in _IMG_EXTS:
                src = os.path.join(img_dir, stem + ext)
                if os.path.exists(src):
                    shutil.copy2(src, os.path.join(output, split, "images", stem + ext))
                    break
            lbl = os.path.join(lbl_dir, stem + ".txt")
            if os.path.exists(lbl):
                shutil.copy2(lbl, os.path.join(output, split, "labels", stem + ".txt"))
    return len(splits["train"]), len(splits["val"])
