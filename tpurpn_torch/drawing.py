"""Visualization: draw boxes and anchor grids onto images (port of
``tpurpn/drawing.py``).

Rebuild of the reference's ``utils/drawing_utils`` (SURVEY.md §2 row 9),
headless: images render to PNG files. ``draw_bboxes`` and
``draw_bboxes_to_file`` are on the predictor's path and need no PIL: the
outlines are rasterized into a uint8 array with PIL's ``ImageDraw.rectangle``
rule (``width=2``), pixel for pixel, and the PNG is written with ``zlib``.
``draw_bboxes_with_labels`` (text) and ``draw_grid_map`` (ellipses) draw
with PIL, imported when they are called.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np


def _to_uint8(image: np.ndarray) -> np.ndarray:
    """A writable uint8 HWC copy; float images are taken as [0, 1]."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    return np.array(img, np.uint8)


def _hline(img: np.ndarray, x0: int, x1: int, y: int, color) -> None:
    h, w = img.shape[:2]
    if 0 <= y < h:
        x0, x1 = max(x0, 0), min(x1, w - 1)
        if x0 <= x1:
            img[y, x0:x1 + 1] = color


def _vline(img: np.ndarray, x: int, ya: int, yb: int, color) -> None:
    """PIL's vertical line from (x, ya) towards (x, yb): |yb - ya| pixels
    starting at ya, the end point yb left out."""
    h, w = img.shape[:2]
    y0, y1 = (ya, yb - 1) if ya <= yb else (yb + 1, ya)
    if 0 <= x < w:
        y0, y1 = max(y0, 0), min(y1, h - 1)
        if y0 <= y1:
            img[y0:y1 + 1, x] = color


def _outline(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color, width: int) -> None:
    """The outline ``ImageDraw.rectangle(..., width=width)`` draws: per ring
    i, rows y0+i and y1-i from x0 to x1, and columns x1-i and x0+i as lines
    from y0+width towards y1-width+1 (which run backwards on boxes lower
    than 2 * width)."""
    for i in range(width):
        _hline(img, x0, x1, y0 + i, color)
        _hline(img, x0, x1, y1 - i, color)
        _vline(img, x1 - i, y0 + width, y1 - width + 1, color)
        _vline(img, x0 + i, y0 + width, y1 - width + 1, color)


def draw_bboxes(image: np.ndarray, bboxes: np.ndarray, color=(255, 40, 40)) -> np.ndarray:
    """Draw normalized [y1,x1,y2,x2] boxes as 2-pixel outlines.

    Returns a uint8 (H, W, 3) numpy array (``tpurpn``'s returns a PIL image
    of the same pixels). Boxes with y2 <= y1 or x2 <= x1 (padding rows) are
    skipped. (reference: drawing_utils.draw_bboxes —
    tf.image.draw_bounding_boxes + plt)
    """
    img = _to_uint8(image)
    h, w = img.shape[:2]
    for box in np.asarray(bboxes).reshape(-1, 4):
        y1, x1, y2, x2 = box
        if y2 <= y1 or x2 <= x1:
            continue
        # the box's own dtype times the size, then truncation toward zero:
        # PIL takes float corners and casts them with (int)
        corners = [int(v) for v in (x1 * w, y1 * h, x2 * w, y2 * h)]
        _outline(img, *corners, color=np.asarray(color, np.uint8), width=2)
    return img


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """An 8-bit RGB (H, W, 3) uint8 array as PNG bytes: IHDR, one IDAT of
    unfiltered rows (filter byte 0), IEND."""
    img = np.ascontiguousarray(image, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, no interlace
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def draw_bboxes_to_file(image: np.ndarray, bboxes: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(draw_bboxes(image, bboxes)))


def _to_pil(image: np.ndarray):
    from PIL import Image

    return Image.fromarray(_to_uint8(image))


def draw_bboxes_with_labels(
    image: np.ndarray,
    bboxes: np.ndarray,
    labels: Sequence[int],
    class_names: Optional[Sequence[str]] = None,
):
    """Boxes + class-name text; returns a PIL image (reference:
    drawing_utils.draw_bboxes_with_labels)."""
    from PIL import ImageDraw

    pil = _to_pil(draw_bboxes(image, bboxes))
    h, w = pil.height, pil.width
    draw = ImageDraw.Draw(pil)
    for box, lab in zip(np.asarray(bboxes).reshape(-1, 4), labels):
        if lab < 0:
            continue
        # labels are 1-based with 0 = background (data.py: VOC index + 1)
        lab = int(lab)
        if class_names is None:
            name = str(lab)
        elif lab == 0:
            name = "background"
        elif lab - 1 < len(class_names):
            name = class_names[lab - 1]
        else:
            name = str(lab)
        draw.text((box[1] * w + 2, box[0] * h + 2), name, fill=(255, 255, 0))
    return pil


def draw_grid_map(image: np.ndarray, grid_points: np.ndarray, radius: int = 2):
    """Mark anchor-grid centers; returns a PIL image (reference:
    drawing_utils.draw_grid_map)."""
    from PIL import ImageDraw

    pil = _to_pil(image)
    h, w = pil.height, pil.width
    draw = ImageDraw.Draw(pil)
    for cy, cx in np.asarray(grid_points).reshape(-1, 2):
        x, y = cx * w, cy * h
        draw.ellipse([x - radius, y - radius, x + radius, y + radius],
                     fill=(0, 255, 0))
    return pil
