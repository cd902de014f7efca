"""``images.txt`` manifests: one path per line, relative to the manifest.

Own copy of ``denoising_diffusion_deep_fake_tpu/data/manifest.py:17-77``.
A balanced manifest, which the balancer writes, carries
``<path>\\t<difficulty_class>`` lines; ``read_image_manifest`` keeps the
path column of either kind.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, Sequence


def read_image_manifest(manifest_path) -> list[Path]:
    """Image paths of a manifest, resolved against its directory."""
    return read_image_manifest_with_classes(manifest_path)[0]


def write_image_manifest(manifest_path, image_paths: Sequence,
                         difficulty_classes: Iterable[int] | None = None
                         ) -> None:
    """Write paths relative to the manifest's directory; with
    ``difficulty_classes``, as ``<path>\\t<class>`` lines."""
    manifest_path = Path(manifest_path)
    manifest_path.parent.mkdir(parents=True, exist_ok=True)
    base = manifest_path.parent
    with open(manifest_path, "w") as f:
        if difficulty_classes is None:
            for p in image_paths:
                f.write(f"{os.path.relpath(Path(p), base)}\n")
        else:
            for p, c in zip(image_paths, difficulty_classes):
                f.write(f"{os.path.relpath(Path(p), base)}\t{int(c)}\n")


def split_manifest_line(line: str) -> tuple[str, int | None]:
    """``(relative_path, difficulty_class or None)`` of one line."""
    parts = line.rstrip("\n").split("\t")
    if len(parts) == 2:
        return parts[0], int(parts[1])
    return parts[0], None


def read_image_manifest_with_classes(manifest_path):
    """``(paths, classes)``; ``classes`` is None unless every line has one."""
    manifest_path = Path(manifest_path)
    base = manifest_path.parent
    paths, classes = [], []
    with open(manifest_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rel, cls = split_manifest_line(line)
            paths.append(base / rel)
            classes.append(cls)
    if any(c is None for c in classes):
        return paths, None
    return paths, classes
