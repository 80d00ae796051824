"""Image strips, grids and files (reference utils.py:12-105).

Counterpart of ``aid_tpu.utils.images``, on the (N, H, W, 3) uint8 numpy
frames the pipelines return. PIL is imported inside each function that
needs it, never when this module is imported.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def to_pil(images) -> list:
    """(N, H, W, 3) uint8, or floats in [0, 1] -> a list of PIL images."""
    from PIL import Image

    x = np.asarray(images)
    if x.dtype != np.uint8:
        x = (np.clip(x, 0.0, 1.0) * 255).round().astype(np.uint8)
    return [Image.fromarray(im) for im in x]


def _pil_list(images) -> list:
    from PIL import Image

    return list(images) if isinstance(images[0], Image.Image) else to_pil(np.asarray(images))


def show_images_horizontally(images, output_file: Optional[str] = None, interact: bool = False, upscale: int = 1):
    """One horizontal strip of a frame sequence, saved as ``output_file``
    when given and shown in IPython with ``interact`` (reference
    utils.py:12-45, without matplotlib)."""
    from PIL import Image

    pil = _pil_list(images)
    if upscale != 1:
        pil = [im.resize((im.width * upscale, im.height * upscale), Image.NEAREST) for im in pil]
    w, h = pil[0].size
    strip = Image.new("RGB", (w * len(pil), h))
    for i, im in enumerate(pil):
        strip.paste(im, (i * w, 0))
    if output_file:
        strip.save(output_file)
    if interact:
        try:
            from IPython.display import display

            display(strip)
        except ImportError:
            pass
    return strip


def image_grids(images, rows: Optional[int] = None, cols: Optional[int] = None):
    """The frames pasted row by row into a grid, ``cols`` defaulting to
    int(sqrt(n)) (reference utils.py:48-68)."""
    from PIL import Image

    if images is None or len(images) == 0:
        raise ValueError("The image list is empty.")
    pil = _pil_list(images)
    cols = cols or int(len(pil) ** 0.5)
    rows = rows or (len(pil) + cols - 1) // cols
    w, h = pil[0].size
    grid = Image.new("RGB", (cols * w, rows * h))
    for i, im in enumerate(pil):
        r, c = divmod(i, cols)
        grid.paste(im, (c * w, r * h))
    return grid


def save_image(image: np.ndarray, file_name: str) -> None:
    """Save one (H, W, 3) frame (reference utils.py:71-80)."""
    from PIL import Image

    Image.fromarray(np.asarray(image)).save(file_name)


def load_and_process_images(load_dir: str) -> List[np.ndarray]:
    """The ``<n>.jpg`` files of ``load_dir`` in numeric order, as floats in
    [0, 1] (reference utils.py:83-105)."""
    from PIL import Image

    names = sorted((f for f in os.listdir(load_dir) if f.endswith(".jpg")), key=lambda x: int(x.split(".")[0]))
    images = []
    for name in names:
        with Image.open(os.path.join(load_dir, name)) as img:
            images.append(np.asarray(img) / 255.0)
    return images
