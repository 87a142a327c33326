"""On-device preprocessing (port of ``tpurpn/data.py::preprocess_batch``).

Rebuild of the reference's ``utils/data_utils.preprocessing`` (SURVEY.md §2
row 7): uint8 frames -> [0, 1] floats, bilinear resize to the model's input
size, optional horizontal flip that mirrors the boxes. The datasets of
``tpurpn.data`` arrive with a later slice of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC bilinear resize to (size, size), as ``jax.image.resize``:
    half-pixel centers, and an antialiasing (triangle-kernel widened by the
    scale) filter along a dimension that shrinks.

    torch's antialiased bilinear has no bfloat16 kernel on the CPU, so a
    shrinking resize runs in f32 and is cast back to the input dtype.
    """
    H, W = x.shape[1], x.shape[2]
    xc = x.permute(0, 3, 1, 2)  # channels-last NCHW view
    if H > size or W > size:
        out = F.interpolate(xc.float(), size=(size, size), mode="bilinear",
                            align_corners=False, antialias=True).to(x.dtype)
    else:
        out = F.interpolate(xc, size=(size, size), mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1)


def preprocess_batch(
    images: torch.Tensor,
    gt_boxes: torch.Tensor,
    img_size: int,
    augment: bool = False,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
    flip: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 (B, H, W, 3) batch -> [0,1] ``dtype`` images resized to
    (img_size, img_size); with ``augment`` a per-image random horizontal flip
    mirroring the boxes' x-coordinates.

    Boxes are normalized, so the resize leaves them unchanged; the flip maps
    x -> 1 - x on real rows and keeps zero-padded rows zero. ``flip`` (B,)
    bool gives the flip mask; otherwise it is drawn from ``generator``
    (p = 0.5 per image, on the CPU).
    """
    B = images.shape[0]
    x = images.to(dtype) / torch.tensor(255.0, dtype=dtype, device=images.device)
    x = resize_bilinear(x, img_size)
    if augment:
        if flip is None:
            if generator is None:
                raise ValueError("augment=True requires a generator or a flip mask")
            flip = torch.rand((B,), generator=generator) < 0.5
        flip = flip.to(images.device)
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        y1, x1, y2, x2 = gt_boxes.unbind(-1)
        valid = (gt_boxes != 0.0).any(dim=-1)
        fb = torch.stack([y1, 1.0 - x2, y2, 1.0 - x1], dim=-1)
        fb = torch.where(valid[..., None], fb, 0.0)
        gt_boxes = torch.where(flip[:, None, None], fb, gt_boxes)
    return x, gt_boxes
