"""Ground-truth image loading (counterpart of webdgs_tpu/io/images.py).

jpg/png decoded to RGB float32 in [0, 1], sorted by numeric-aware filename
comparison so the image order lines up with the COLMAP camera order.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image


def numeric_key(name: str):
    """Split into (text, number) runs: 'img10.png' sorts after 'img2.png'."""
    parts = re.split(r"(\d+)", os.path.basename(name))
    return [int(p) if p.isdigit() else p for p in parts]


def load_image(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def load_images(paths_or_dir) -> list[dict]:
    """Returns [{name, image (H,W,3) f32, width, height}] name-sorted."""
    if isinstance(paths_or_dir, (str, os.PathLike)) and \
            os.path.isdir(paths_or_dir):
        d = str(paths_or_dir)
        paths = [os.path.join(d, f) for f in os.listdir(d)
                 if f.lower().endswith((".jpg", ".jpeg", ".png"))]
    else:
        paths = [str(p) for p in paths_or_dir]
    paths.sort(key=numeric_key)
    # PIL releases the GIL while decoding: threads decode in parallel
    workers = min(8, max(1, len(paths)))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        images = list(pool.map(load_image, paths))
    return [{"name": os.path.basename(p), "image": img,
             "width": img.shape[1], "height": img.shape[0]}
            for p, img in zip(paths, images)]
