"""Anchors, box coding, IoU, greedy NMS, preprocessing and RPN target
assignment in plain float32 PyTorch and NumPy (Ren et al. 2015, with the
tf-rpn conventions: boxes [y1, x1, y2, x2] normalized to the image, anchors
scale-major over (128, 256, 512) x ratio-minor over (1, 2, 0.5), deltas
divided by the variances (0.1, 0.1, 0.2, 0.2), positives IoU > 0.7 plus the
best anchor of every GT box, negatives IoU < 0.3, 128 + 128 sampled).

Sampling follows the configurations' stated rule: each anchor's 32-bit
word (row 0 for positives, row 1 for negatives) gives a key, its top
(28 - L) bits above its L-bit index (L = max(14, bits of N - 1)), and the
k candidates of smallest key are kept.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-8


def feature_map(backbone: str, img: int) -> int:
    """Stride-16 map size: four SAME stride-2 layers (ceil) for MobileNetV2,
    four VALID 2x2 pools (floor) for VGG16."""
    for _ in range(4):
        img = math.ceil(img / 2) if backbone == "mobilenet_v2" else img // 2
    return img


def anchors(img: int, fm: int, scales=(128.0, 256.0, 512.0), ratios=(1.0, 2.0, 0.5)
            ) -> np.ndarray:
    """(fm*fm*A, 4) f32 anchors, row-major over (y, x, anchor), clipped to [0, 1]."""
    sc = np.repeat(np.asarray(scales, np.float64), len(ratios))
    rt = np.tile(np.asarray(ratios, np.float64), len(scales))
    w, h = sc / np.sqrt(rt), sc * np.sqrt(rt)
    base = (np.stack([-h / 2, -w / 2, h / 2, w / 2], -1) / img).astype(np.float32)
    c = np.arange(fm, dtype=np.float64) / fm + 0.5 / fm
    gx, gy = np.meshgrid(c, c)
    ctr = np.stack([gy.ravel(), gx.ravel(), gy.ravel(), gx.ravel()], -1)
    a = (ctr[:, None, :] + base.astype(np.float64)[None]).reshape(-1, 4)
    return np.clip(a, 0.0, 1.0).astype(np.float32)


def _ctr_size(b: torch.Tensor):
    h = b[..., 2] - b[..., 0]
    w = b[..., 3] - b[..., 1]
    return b[..., 0] + 0.5 * h, b[..., 1] + 0.5 * w, h, w


def decode(anc: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Deltas (already times the variances) against anchors -> boxes."""
    cy, cx, h, w = _ctr_size(anc)
    hh = torch.exp(deltas[..., 2]) * h
    ww = torch.exp(deltas[..., 3]) * w
    y = deltas[..., 0] * h + cy
    x = deltas[..., 1] * w + cx
    return torch.stack([y - 0.5 * hh, x - 0.5 * ww, y + 0.5 * hh, x + 0.5 * ww], -1)


def encode(anc: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """GT boxes as deltas of anchors; zero rows encode to zero deltas."""
    a_cy, a_cx, a_h, a_w = _ctr_size(anc)
    g_cy, g_cx, g_h, g_w = _ctr_size(gt)
    a_h = torch.where(a_h == 0, 1e-3, a_h)
    a_w = torch.where(a_w == 0, 1e-3, a_w)
    dy = torch.where(g_h == 0, 0.0, (g_cy - a_cy) / a_h)
    dx = torch.where(g_w == 0, 0.0, (g_cx - a_cx) / a_w)
    dh = torch.where(g_h == 0, 0.0, torch.log(torch.where(g_h <= 0, 1.0, g_h) / a_h))
    dw = torch.where(g_w == 0, 0.0, torch.log(torch.where(g_w <= 0, 1.0, g_w) / a_w))
    return torch.stack([dy, dx, dh, dw], -1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU."""
    y1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    x1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    y2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    x2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (y2 - y1).clamp(min=0) * (x2 - x1).clamp(min=0)

    def area(t):
        return (t[..., 2] - t[..., 0]).clamp(min=0) * (t[..., 3] - t[..., 1]).clamp(min=0)

    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / union.clamp(min=EPS)


def greedy_nms(boxes, thr: float, max_out: int) -> np.ndarray:
    """Keep flags of greedy NMS over score-sorted (n, 4) boxes (an array or
    a tensor on any device): a box is kept when its IoU (f64) with every
    kept box is <= thr; the walk stops at ``max_out`` keeps (later boxes
    are not kept). The IoU table is computed whole, on the boxes' device,
    and walked on the host."""
    b = torch.as_tensor(boxes).to(torch.float64)
    over = (iou(b, b) > thr).cpu().numpy()
    n = over.shape[0]
    keep = np.zeros(n, bool)
    suppressed = np.zeros(n, bool)
    k = 0
    for i in range(n):
        if suppressed[i]:
            continue
        keep[i] = True
        k += 1
        if k == max_out:
            break
        suppressed |= over[i]
    return keep


def preprocess(frames_u8: torch.Tensor, img: int, boxes: torch.Tensor = None,
               flip: torch.Tensor = None):
    """uint8 NHWC frames -> f32 NHWC in [0, 1], bilinearly resized (half-pixel
    centers) to img x img; with ``flip`` the flagged images and their boxes
    are mirrored left-right (zero box rows stay zero)."""
    x = frames_u8.float() / 255.0
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(img, img), mode="bilinear",
                      align_corners=False, antialias=frames_u8.shape[1] > img
                      or frames_u8.shape[2] > img).permute(0, 2, 3, 1)
    if flip is None:
        return x, boxes
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    y1, x1, y2, x2 = boxes.unbind(-1)
    fb = torch.stack([y1, 1.0 - x2, y2, 1.0 - x1], -1)
    fb = torch.where((boxes != 0).any(-1, keepdim=True), fb, 0.0)
    return x, torch.where(flip[:, None, None], fb, boxes)


def _keys(words: torch.Tensor, n: int) -> torch.Tensor:
    lane = max(14, (n - 1).bit_length())
    u = words.long() & 0xFFFFFFFF
    return ((u >> (32 - (28 - lane))) << lane) | torch.arange(n, device=words.device)


def _smallest(cand: torch.Tensor, keys: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    keys = torch.where(cand, keys, 1 << 40)
    srt = torch.sort(keys, -1).values
    thr = torch.gather(srt, 1, (k.long() - 1).clamp(min=0)[:, None])
    return cand & (keys <= thr) & (k[:, None] > 0)


def targets(anc: torch.Tensor, gt: torch.Tensor, gt_labels: torch.Tensor,
            words: torch.Tensor, pos_thr=0.7, neg_thr=0.3, n_pos=128, n_neg=128,
            variances=(0.1, 0.1, 0.2, 0.2)) -> Tuple[torch.Tensor, torch.Tensor]:
    """(deltas (B, N, 4) / variances at the positives, labels (B, N) in
    {1, 0, -1}) for anchors (N, 4), GT (B, M, 4), GT labels (-1 = padding)
    and (B, 2, N) int32 words."""
    n = anc.shape[0]
    m = iou(anc[None].expand(gt.shape[0], -1, -1), gt)  # (B, N, M)
    best_iou, best_gt = m.max(2)
    best_anchor = m.argmax(1)  # (B, M)
    pos_cand = (best_iou > pos_thr) | _forced(best_anchor, gt_labels != -1, n)
    pos = _smallest(pos_cand, _keys(words[:, 0], n), pos_cand.sum(1).clamp(max=n_pos))
    neg_cand = (best_iou < neg_thr) & ~pos
    neg = _smallest(neg_cand, _keys(words[:, 1], n),
                    torch.minimum(n_pos + n_neg - pos.sum(1), neg_cand.sum(1)))
    labels = torch.where(pos, 1.0, torch.where(neg, 0.0, -1.0))
    matched = torch.gather(gt, 1, best_gt[..., None].expand(-1, -1, 4))
    matched = torch.where(pos[..., None], matched, 0.0)
    var = torch.tensor(variances, dtype=torch.float32, device=anc.device)
    return encode(anc[None], matched) / var, labels


def _forced(best_anchor: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    """(B, N) flags of the anchors that are the best of some valid GT box."""
    hit = best_anchor[:, :, None] == torch.arange(n, device=best_anchor.device)
    return (hit & valid[:, :, None]).any(1)


def huber(e: torch.Tensor) -> torch.Tensor:
    a = e.abs()
    q = a.clamp(max=1.0)
    return 0.5 * q * q + (a - q)


def rpn_loss(deltas: torch.Tensor, labels: torch.Tensor, reg: torch.Tensor,
             cls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(smooth-L1 over the positives / max(1, #positives), BCE over the
    counted anchors / max(1, #counted)) from (B, N, 4) targets, (B, N)
    labels and the head's (B, N, 4) deltas and (B, N) logits."""
    pos = (deltas != 0).any(-1).float()
    l_reg = (huber(deltas - reg).mean(-1) * pos).sum() / pos.sum().clamp(min=1)
    valid = (labels != -1).float()
    z = labels.clamp(0, 1)
    bce = cls.clamp(min=0) - cls * z + torch.log1p(torch.exp(-cls.abs()))
    return l_reg, (bce * valid).sum() / valid.sum().clamp(min=1)
