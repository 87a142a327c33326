"""Evaluation metrics: proposal recall (port of ``tpurpn/eval.py``).

Recall@300 (the fraction of GT boxes matched by at least one of the top-300
proposals at IoU >= 0.5) is the north-star accuracy metric (BASELINE.json:2);
the reference has no metric code (SURVEY.md §4). The IoU is
``boxes.generate_iou_map``, op for op ``tpurpn``'s.
"""

from __future__ import annotations

from typing import Dict

import torch

from .boxes import generate_iou_map


@torch.no_grad()
def proposal_recall(
    roi_boxes: torch.Tensor,
    num_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    iou_threshold: float = 0.5,
) -> Dict[str, torch.Tensor]:
    """Recall of GT boxes by proposals.

    Args:
      roi_boxes: (B, P, 4) proposals (zero rows past num_valid).
      num_valid: (B,) valid proposal counts.
      gt_boxes: (B, M, 4) zero-padded GT.
      gt_labels: (B, M), -1 = padding.
      iou_threshold: a GT counts as recalled if some valid proposal overlaps
        it with IoU >= this.

    Returns dict with 'recall' (0-dim f32), 'num_gt' and 'num_recalled'
    (0-dim int64), on the proposals' device.
    """
    B, P, _ = roi_boxes.shape
    gt_boxes = gt_boxes.to(roi_boxes.device)
    iou = generate_iou_map(roi_boxes, gt_boxes)  # (B, P, M)
    prop_valid = (torch.arange(P, device=roi_boxes.device)[None]
                  < num_valid.to(roi_boxes.device)[:, None])
    iou = torch.where(prop_valid[..., None], iou, 0.0)
    best_per_gt = iou.amax(dim=1)  # (B, M)
    gt_valid = gt_labels.to(roi_boxes.device) != -1
    recalled = (best_per_gt >= iou_threshold) & gt_valid
    num_gt = gt_valid.sum()
    num_recalled = recalled.sum()
    return {
        "recall": num_recalled / torch.clamp(num_gt, min=1),
        "num_gt": num_gt,
        "num_recalled": num_recalled,
    }
