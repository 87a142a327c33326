"""On-device preprocessing and the synthetic dataset (port of parts of
``tpurpn/data.py``).

Rebuild of the reference's ``utils/data_utils.preprocessing`` (SURVEY.md §2
row 7): uint8 frames -> [0, 1] floats, bilinear resize to the model's input
size, optional horizontal flip that mirrors the boxes. ``SyntheticVOC``
(with its Python sampler) and ``batch_index_iter`` are copies of
``tpurpn``'s, numpy only, so one seed gives the same samples in both
packages. The native loader and the VOC / COCO / tfds sources arrive with a
later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


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


# ---------------------------------------------------------------------------
# Synthetic VOC-style dataset (a copy of tpurpn.data's, numpy only)
# ---------------------------------------------------------------------------


def _max_iou(box: np.ndarray, others: np.ndarray) -> float:
    y1 = np.maximum(box[0], others[:, 0])
    x1 = np.maximum(box[1], others[:, 1])
    y2 = np.minimum(box[2], others[:, 2])
    x2 = np.minimum(box[3], others[:, 3])
    inter = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
    area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])  # noqa: E731
    union = area(box) + area(others) - inter
    return float((inter / np.maximum(union, 1e-8)).max())


def batch_index_iter(
    num_samples: int,
    batch_size: int,
    *,
    repeat: bool = False,
    drop_remainder: bool = True,
    shuffle: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Yield per-batch sample indices: fixed order, or a fresh deterministic
    permutation per epoch when ``shuffle`` is an integer seed; remainder
    batches dropped by default."""
    epoch = 0
    while True:
        if shuffle is not None:
            order = np.random.default_rng(
                (np.uint32(shuffle), np.uint32(epoch))
            ).permutation(num_samples)
        else:
            order = np.arange(num_samples)
        for start in range(0, num_samples, batch_size):
            idxs = order[start : min(start + batch_size, num_samples)]
            if drop_remainder and len(idxs) < batch_size:
                continue
            yield idxs
        epoch += 1
        if not repeat:
            return


@dataclasses.dataclass
class SyntheticVOC:
    """Procedural detection data: bright axis-aligned rectangles on noise.

    Deterministic per (seed, index), and the same samples as
    ``tpurpn.data.SyntheticVOC``'s Python sampler. Raw images are
    (raw_h, raw_w) like typical VOC photos; preprocessing resizes them.
    """

    num_samples: int = 256
    raw_h: int = 375
    raw_w: int = 500
    max_boxes: int = 8
    min_boxes: int = 1
    seed: int = 0

    def __len__(self) -> int:
        return self.num_samples

    def sample(self, index: int):
        rng = np.random.default_rng(np.uint32(self.seed * 1_000_003 + index))
        img = rng.integers(0, 60, size=(self.raw_h, self.raw_w, 3), dtype=np.uint8)
        n = int(rng.integers(self.min_boxes, self.max_boxes + 1))
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        labels = np.full((self.max_boxes,), -1, np.int32)
        count = 0
        for _ in range(n):
            # rejection-sample boxes with low mutual overlap
            for _attempt in range(8):
                h = rng.uniform(0.12, 0.6)
                w = rng.uniform(0.12, 0.6)
                y1 = rng.uniform(0.0, 1.0 - h)
                x1 = rng.uniform(0.0, 1.0 - w)
                cand = np.array([y1, x1, y1 + h, x1 + w], np.float32)
                if count == 0 or _max_iou(cand, boxes[:count]) < 0.3:
                    break
            else:
                continue
            boxes[count] = cand
            labels[count] = int(rng.integers(1, len(VOC_CLASSES) + 1))  # 0 = bg
            color = rng.integers(120, 255, size=3)
            py1, px1 = int(y1 * self.raw_h), int(x1 * self.raw_w)
            py2, px2 = int((y1 + h) * self.raw_h), int((x1 + w) * self.raw_w)
            img[py1:py2, px1:px2] = color
            count += 1
        return img, boxes, labels

    def batches(
        self,
        batch_size: int,
        *,
        repeat: bool = False,
        drop_remainder: bool = True,
        shuffle: Optional[int] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (images u8 (B,H,W,3), boxes (B,M,4), labels (B,M)) batches
        in the order of ``batch_index_iter``."""
        for idxs in batch_index_iter(
            len(self), batch_size, repeat=repeat,
            drop_remainder=drop_remainder, shuffle=shuffle,
        ):
            samples = [self.sample(i) for i in idxs]
            yield (
                np.stack([s[0] for s in samples]),
                np.stack([s[1] for s in samples]),
                np.stack([s[2] for s in samples]),
            )
