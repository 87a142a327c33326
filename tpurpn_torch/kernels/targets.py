"""Fused RPN target assignment and IoU matching (port of
``tpurpn/kernels/target_pallas.py``: ``fused_rpn_targets`` and
``fused_iou_matching``).

On CUDA tensors both wrappers launch the hand-written kernels in
``csrc/targets.cu``; on CPU tensors they run their plain versions,
``target.rpn_targets_plain`` and ``target.iou_matching_plain``. There is no
fallback: CUDA tensors the kernels do not take raise, and so does a card on
which no thread-block cluster of 8 or 16 blocks schedules.

Both kernels share one IoU-matching phase, run by one cluster of C blocks an
image (grid (C, B), one launch a call): each block takes a contiguous slice
of the anchors, and the per-GT best anchors of the C slices meet through
distributed shared memory. :func:`cluster_size` reports the C an entry
launches with (chosen by an occupancy query at its first call on a device).
Rank 0 of each target cluster then selects and encodes for the whole image.
The source note of ``csrc/targets.cu`` says what bounds them.

Exactness, as the plain versions on the same words: matching indices,
merged IoU and labels bit for bit (ties to the lowest anchor index across
slices); delta rows 0-1 (divisions) bit for bit; rows 2-3 go through
``logf``, which may round one ulp away from torch's ``log``, so they agree
at rel 1e-6.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ..config import HyperParams
from ..target import _lane_bits_for, iou_matching_plain, rpn_targets_plain


_ENTRIES = ("iou_matching", "rpn_targets")  # the C library's entry numbers


def cluster_size(entry: str) -> int:
    """Blocks a cluster (one cluster an image) of the CUDA entry ``entry``,
    "iou_matching" or "rpn_targets", on the current CUDA device. Raises
    when no cluster size schedules there."""
    if entry not in _ENTRIES:
        raise ValueError(f"no CUDA entry {entry!r}: one of {_ENTRIES}")
    lib = _build.load("targets")
    c = lib.targets_cluster_size(_ENTRIES.index(entry))
    _build.check(lib, "targets", max(-c, 0))
    return c


def _check_boxes(anchors: torch.Tensor, gt_boxes: torch.Tensor, name: str):
    if anchors.ndim != 2 or anchors.shape[1] != 4 or gt_boxes.ndim != 3 or gt_boxes.shape[2] != 4:
        raise ValueError(
            f"{name} takes anchors (N, 4) and gt_boxes (B, M, 4), got "
            f"{tuple(anchors.shape)} / {tuple(gt_boxes.shape)}"
        )
    if anchors.dtype != torch.float32 or gt_boxes.dtype != torch.float32:
        raise ValueError(f"{name} takes f32 boxes, got {anchors.dtype} / {gt_boxes.dtype}")
    if gt_boxes.shape[1] < 1 or anchors.shape[0] < 1:
        raise ValueError(f"{name} needs at least one anchor and one GT row")
    if anchors.device != gt_boxes.device:
        raise ValueError(f"{name}: anchors and gt_boxes must be on one device")


def _aligned(*boxes: torch.Tensor):
    """Contiguous boxes, checked for the kernels' float4 reads."""
    out = tuple(b.contiguous() for b in boxes)
    if any(b.data_ptr() % 16 for b in out):
        raise ValueError("the target kernels read boxes as float4: need 16-byte alignment")
    return out


def fused_iou_matching(
    anchors: torch.Tensor, gt_boxes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Anchor x GT IoU matching without the (B, N, M) IoU tensor.

    Args:
      anchors: (N, 4) f32 [y1, x1, y2, x2]; gt_boxes: (B, M, 4) f32,
        zero-padded rows.

    Returns (merged_iou (B, N) f32, best_gt_per_anchor (B, N) int32,
    best_anchor_per_gt (B, M) int32), each argmax the first maximum. A CUDA
    call counts once in ``launches``.
    """
    if anchors.device.type == "cpu":
        return iou_matching_plain(anchors, gt_boxes)
    _check_boxes(anchors, gt_boxes, "fused_iou_matching")
    anchors, gt_boxes = _aligned(anchors, gt_boxes)
    (N, _), (B, M, _) = anchors.shape, gt_boxes.shape
    dev = anchors.device
    merged = torch.empty((B, N), dtype=torch.float32, device=dev)
    best_gt = torch.empty((B, N), dtype=torch.int32, device=dev)
    best_anchor = torch.empty((B, M), dtype=torch.int32, device=dev)
    lib = _build.load("targets")
    code = lib.iou_matching(
        anchors.data_ptr(), gt_boxes.data_ptr(), merged.data_ptr(),
        best_gt.data_ptr(), best_anchor.data_ptr(), B, N, M,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "targets", code)
    fused_iou_matching.launches += 1
    return merged, best_gt, best_anchor


def fused_rpn_targets(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    rand_bits: torch.Tensor,
    hp: HyperParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matching + forced best anchor per valid GT + balanced subsampling +
    delta encoding in one kernel.

    Args:
      anchors: (N, 4) f32; gt_boxes: (B, M, 4) f32 zero-padded; gt_labels:
        (B, M) int, -1 on padding; rand_bits: (B, 2, N) int32 words (row 0
        ranks positives, row 1 negatives).

    Returns (bbox_deltas (B, N, 4) f32, already / variances; bbox_labels
    (B, N) f32 in {1, 0, -1}). A CUDA call counts once in ``launches``.
    """
    if anchors.device.type == "cpu":
        return rpn_targets_plain(anchors, gt_boxes, gt_labels, rand_bits, hp)
    _check_boxes(anchors, gt_boxes, "fused_rpn_targets")
    (N, _), (B, M, _) = anchors.shape, gt_boxes.shape
    if gt_labels.shape != (B, M) or rand_bits.shape != (B, 2, N):
        raise ValueError(
            f"fused_rpn_targets takes gt_labels (B, M) and rand_bits (B, 2, N), got "
            f"{tuple(gt_labels.shape)} / {tuple(rand_bits.shape)} for B={B} M={M} N={N}"
        )
    if rand_bits.dtype != torch.int32:
        raise ValueError(f"rand_bits must be int32 words, got {rand_bits.dtype}")
    if gt_labels.device != anchors.device or rand_bits.device != anchors.device:
        raise ValueError("fused_rpn_targets: all inputs must be on one device")
    anchors, gt_boxes = _aligned(anchors, gt_boxes)
    gt_labels = gt_labels.to(torch.int32).contiguous()  # -1 marks padding
    rand_bits = rand_bits.contiguous()
    dev = anchors.device
    deltas = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
    labels = torch.empty((B, N), dtype=torch.float32, device=dev)
    # one scratch row of 4-byte words: per-anchor merged IoU (f32) and best
    # GT, per-GT best anchor, and the two selection-key rows (used where
    # they do not fit in shared memory)
    scratch = torch.empty((B * (4 * N + M),), dtype=torch.int32, device=dev)
    v = [float(x) for x in hp.variances]
    lib = _build.load("targets")
    merged, best_gt, best_anchor, keys = (
        scratch.data_ptr() + 4 * B * off for off in (0, N, 2 * N, 2 * N + M))
    code = lib.rpn_targets(
        anchors.data_ptr(), gt_boxes.data_ptr(), gt_labels.data_ptr(), rand_bits.data_ptr(),
        deltas.data_ptr(), labels.data_ptr(), merged, best_gt, best_anchor, keys,
        B, N, M, _lane_bits_for(N),
        float(hp.pos_threshold), float(hp.neg_threshold), int(hp.total_pos_bboxes),
        int(hp.total_pos_bboxes + hp.total_neg_bboxes), v[0], v[1], v[2], v[3],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "targets", code)
    fused_rpn_targets.launches += 1
    return deltas, labels


fused_iou_matching.launches = 0
fused_rpn_targets.launches = 0
