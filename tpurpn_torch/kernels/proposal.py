"""Fused proposal selection: top-``pre`` -> greedy NMS -> compacted proposals
(port of ``tpurpn/kernels/proposal_pallas.py::fused_proposals_packed``).

``fused_proposals`` on CUDA tensors launches the hand-written kernel in
``csrc/proposal.cu`` (its source note says what bounds it and how it is laid
out); on CPU tensors it runs ``fused_proposals_plain``, which is
``tpurpn_torch.predict.generate_proposals``' selection: a stable descending
sort, the blockwise greedy NMS of ``tpurpn_torch.boxes`` and the index
compaction. Both select bit for bit what ``tpurpn.predict.
generate_proposals`` selects on the same f32 candidates. There is no
fallback: CUDA tensors the kernel does not take raise.

The candidate order is computed outside the kernel, as ``tpurpn`` computes
``lax.top_k`` outside its kernel: ``torch.sort(..., descending=True,
stable=True)`` breaks score ties toward the lower index like ``lax.top_k``
(``torch.topk`` promises no tie order). ``_select`` launches the kernel on
an order already computed, so the two can be timed apart.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _build
from ..boxes import batched_non_max_suppression


def top_candidates(scores: torch.Tensor, pre: int) -> torch.Tensor:
    """(B, N) -> (B, pre) int64 indices by descending score, ties to the lower index."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :pre]


def fused_proposals_plain(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    pre: int,
    iou_threshold: float,
    max_output: int,
    block: int = 128,
) -> Dict[str, torch.Tensor]:
    """The selection in plain PyTorch; same signature and result as the kernel."""
    top_idx = top_candidates(scores, pre)
    top_scores = torch.gather(scores, 1, top_idx)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    sel, num_valid = batched_non_max_suppression(
        top_boxes, top_scores, max_output_size=max_output,
        iou_threshold=iou_threshold, block=block, presorted=True, use_kernel=False,
    )
    valid = sel >= 0
    safe_sel = torch.clamp(sel.long(), min=0)
    roi_boxes = torch.gather(top_boxes, 1, safe_sel[..., None].expand(-1, -1, 4))
    roi_scores = torch.gather(top_scores, 1, safe_sel)
    roi_boxes = torch.where(valid[..., None], roi_boxes, 0.0)
    roi_scores = torch.where(valid, roi_scores, 0.0)
    num_valid = torch.clamp(num_valid, max=max_output).to(torch.int32)
    return {"roi_boxes": roi_boxes, "roi_scores": roi_scores, "num_valid": num_valid}


def _check(boxes, scores, pre, max_output):
    B, N = scores.shape
    if boxes.shape != (B, N, 4) or boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise ValueError(
            f"fused_proposals takes (B, N, 4) / (B, N) f32, got "
            f"{tuple(boxes.shape)} {boxes.dtype} / {tuple(scores.shape)} {scores.dtype}"
        )
    if not 0 < pre <= N or max_output <= 0:
        raise ValueError(f"need 0 < pre <= N and max_output > 0: {pre=} {N=} {max_output=}")
    if boxes.device != scores.device:
        raise ValueError("boxes and scores must be on one device")


def _select(boxes, scores, order, iou_threshold, max_output):
    """The selection kernel alone, on inputs ``_check`` passed and the
    candidate order ``top_candidates`` gave (``order`` (B, pre) int64, every
    index in [0, N)); counts one launch."""
    B, N = scores.shape
    pre = order.shape[1]
    boxes, scores, order = boxes.contiguous(), scores.contiguous(), order.contiguous()
    if boxes.data_ptr() % 16:
        raise ValueError("fused_proposals reads boxes as float4: need 16-byte alignment")
    dev = boxes.device
    roi_boxes = torch.empty((B, max_output, 4), dtype=torch.float32, device=dev)
    roi_scores = torch.empty((B, max_output), dtype=torch.float32, device=dev)
    num_valid = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = _build.load("proposal")
    code = lib.proposal_select(
        boxes.data_ptr(), scores.data_ptr(), order.data_ptr(),
        roi_boxes.data_ptr(), roi_scores.data_ptr(), num_valid.data_ptr(),
        B, N, pre, max_output, float(iou_threshold),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "proposal", code)
    fused_proposals.launches += 1
    return {"roi_boxes": roi_boxes, "roi_scores": roi_scores, "num_valid": num_valid}


def fused_proposals(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    pre: int,
    iou_threshold: float,
    max_output: int,
) -> Dict[str, torch.Tensor]:
    """Top-``pre`` -> greedy NMS (IoU > ``iou_threshold`` suppresses) ->
    the first ``max_output`` kept boxes.

    Args:
      boxes: (B, N, 4) f32 decoded candidates [y1, x1, y2, x2].
      scores: (B, N) f32 objectness scores.

    Returns {roi_boxes (B, max_output, 4), roi_scores (B, max_output), both
    zero past num_valid; num_valid (B,) int32}. A CUDA call counts once in
    ``launches``.
    """
    if boxes.device.type == "cpu":
        return fused_proposals_plain(boxes, scores, pre, iou_threshold, max_output)
    _check(boxes, scores, pre, max_output)
    return _select(boxes, scores, top_candidates(scores, pre), iou_threshold, max_output)


fused_proposals.launches = 0
