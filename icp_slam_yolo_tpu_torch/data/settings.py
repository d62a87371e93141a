"""Whitespace key-value settings files; a copy of the JAX package's
``data/settings.py`` (`labels_segmentation.py:216-223` parity).

The reference's labelers read configs like ``setting/setting_segmentation.txt``:
one ``key value`` pair per line, whitespace-separated, plus a CSV "path
registry" that injects per-tool paths (`labels_segmentation/path.py:28-42`).
"""

from __future__ import annotations

import os


def read_settings(path: str) -> dict[str, str]:
    """Parse ``key value`` lines; later duplicates win; blanks/comments skipped."""
    out: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(None, 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def write_settings(path: str, settings: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        for k, v in settings.items():
            f.write(f"{k} {v}\n")


class PathRegistry:
    """Named path registry backed by a settings file (the reference's
    `path.py` injects these as globals; here they're looked up)."""

    def __init__(self, path: str):
        self.path = path
        self.paths = read_settings(path) if os.path.exists(path) else {}

    def get(self, name: str, default: str | None = None) -> str | None:
        return self.paths.get(name, default)

    def set(self, name: str, value: str) -> None:
        self.paths[name] = value
        write_settings(self.path, self.paths)
