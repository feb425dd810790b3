"""Animation export: frame sequences -> GIF (and PNG sequences).

The reference leaves its 220 PNGs for external assembly; this writes an
animated GIF directly from TrajectoryScanRenderer output (or any list of
HxWx3 uint8 frames).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float = 30.0,
              loop: int = 0) -> str:
    from PIL import Image

    if not frames:
        raise ValueError("no frames")
    imgs = [Image.fromarray(np.asarray(f), mode="RGB") for f in frames]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(int(1000 / fps), 1), loop=loop)
    return path


def write_frame_sequence(folder: str, frames: Sequence[np.ndarray],
                         pattern: str = "frame_{:04d}.png") -> list:
    from pointcloud_render.io import png

    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, f in enumerate(frames):
        p = os.path.join(folder, pattern.format(i))
        png.write_png(p, np.asarray(f), srgb=False)
        paths.append(p)
    return paths
