"""Greedy-NMS keep mask over score-sorted boxes (port of
``tpurpn/kernels/nms_pallas.py::nms_pallas_keep``).

``nms_keep`` on CUDA tensors launches the hand-written kernel in
``csrc/nms.cu`` (its source note says what bounds it and how it is laid
out); on CPU tensors it runs ``nms_keep_plain``, the blockwise greedy NMS of
``tpurpn_torch.boxes``. Both give the same keep mask bit for bit, including
the stop rule: blocks of ``block`` boxes are decided whole, and an image
stops after the block in which its count reaches ``max_output``, so the
count may exceed ``max_output``. There is no fallback: CUDA tensors the
kernel does not take raise.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build
from ..boxes import _nms_keep_sorted_batched, _round_up


def nms_keep_plain(
    boxes_sorted: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_output: int,
    block: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The keep mask in plain PyTorch; same signature and result as the kernel."""
    B, n, _ = boxes_sorted.shape
    n_pad = _round_up(max(n, block), block)
    if n_pad > n:
        boxes_sorted = F.pad(boxes_sorted, (0, 0, 0, n_pad - n))
        valid = F.pad(valid, (0, n_pad - n))
    keep = _nms_keep_sorted_batched(boxes_sorted, valid, float(iou_threshold), block,
                                    max_output)[:, :n]
    return keep, keep.sum(dim=-1).to(torch.int32)


def _launch(boxes_sorted, valid, iou_threshold, max_output, block):
    if boxes_sorted.ndim != 3 or boxes_sorted.shape[2] != 4 or boxes_sorted.dtype != torch.float32:
        raise ValueError(
            f"nms_keep takes (B, n, 4) f32 boxes, got {tuple(boxes_sorted.shape)} "
            f"{boxes_sorted.dtype}"
        )
    B, n, _ = boxes_sorted.shape
    if B == 0 or n == 0:
        raise ValueError(f"nms_keep needs boxes, got {tuple(boxes_sorted.shape)}")
    if valid.shape != (B, n) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be (B, n) bool, got {tuple(valid.shape)} {valid.dtype}")
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"block must be a multiple of 32 in [32, 1024], got {block}")
    if valid.device != boxes_sorted.device:
        raise ValueError("boxes and valid must be on one device")
    boxes_sorted, valid = boxes_sorted.contiguous(), valid.contiguous()
    if boxes_sorted.data_ptr() % 16:
        raise ValueError("nms_keep reads boxes as float4: need 16-byte alignment")
    dev = boxes_sorted.device
    keep = torch.empty((B, n), dtype=torch.bool, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    # the kept boxes and areas of an image: fewer than max_output before its
    # last block, plus that block; in shared memory when they fit, else here
    cap = max(1, min(n, max_output + block - 1))
    kept = torch.empty((B * cap * 5,), dtype=torch.float32, device=dev)
    lib = _build.load("nms")
    code = lib.nms_keep(
        boxes_sorted.data_ptr(), valid.data_ptr(), keep.data_ptr(), count.data_ptr(),
        kept.data_ptr(), kept.data_ptr() + 16 * B * cap, B, n, max_output, block, cap,
        float(iou_threshold), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "nms", code)
    return keep, count


def nms_keep(
    boxes_sorted: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_output: int,
    block: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy-NMS keep mask (IoU > ``iou_threshold`` suppresses).

    Args:
      boxes_sorted: (B, n, 4) f32 [y1, x1, y2, x2], descending score order.
      valid: (B, n) bool; invalid boxes are neither kept nor suppress.
      block: width of the blocks decided whole (the stop rule's unit).

    Returns (keep (B, n) bool, kept_count (B,) int32). A CUDA call counts
    once in ``launches``.
    """
    if boxes_sorted.device.type == "cpu":
        return nms_keep_plain(boxes_sorted, valid, iou_threshold, max_output, block)
    out = _launch(boxes_sorted, valid, iou_threshold, max_output, block)
    nms_keep.launches += 1
    return out


nms_keep.launches = 0
