"""Seeded camera frames made on the device: a pool of letterboxed ``(B, S,
S, 3)`` float32 batches in ``[0, 1]``, each frame a smooth random scene
(noise at an eighth of the size, upsampled) with fine noise over it and
the letterbox's grey bands of a 4:3 camera above and below."""

from __future__ import annotations

import torch
import torch.nn.functional as F

LETTERBOX_FILL = 114.0 / 255.0


def frame_pool(traffic: dict, img_size: int, seed: int, device) -> torch.Tensor:
    """``(pool, batch, S, S, 3)``: the batches the window cycles through."""
    pool, batch = int(traffic["pool"]), int(traffic["batch"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    n = pool * batch
    coarse = torch.rand((n, 3, img_size // 8, img_size // 8), generator=gen, device=device)
    fine = torch.rand((n, 3, img_size, img_size), generator=gen, device=device)
    img = 0.8 * F.interpolate(coarse, size=(img_size, img_size), mode="bilinear", align_corners=False) + 0.2 * fine
    band = round(img_size * (1.0 - traffic["aspect"]) / 2.0)
    if band > 0:
        img[:, :, :band] = LETTERBOX_FILL
        img[:, :, img_size - band:] = LETTERBOX_FILL
    return img.permute(0, 2, 3, 1).contiguous().reshape(pool, batch, img_size, img_size, 3)
