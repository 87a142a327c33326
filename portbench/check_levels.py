"""The numbers that decide ``correct`` for a configuration with a feature
pyramid (``check.py``'s serving numbers, by level): what the timed path
served, judged against the plain reference (``portbench/reference/
vitdet.py``) on the same frames and weights.

Per sampled image, the served proposals P against the reference's
candidates C (every anchor's decoded box, clipped to the resized image, and
its objectness logit) and its level-wise selection R. The distance of a
proposal to a candidate is max(|box - box_c|_inf, |logit - logit_c|), the
served logit being its score's inverse sigmoid (f64): logits, not scores,
since the sigmoid flattens the best candidates' differences. A proposal's
levels are those whose nearest candidate lies within ``LEVEL_MARGIN`` of its
nearest candidate of all: one level, except where candidates of several
levels share nearly one box and logit (large boxes clipped to the whole
image are the common case), where it is ambiguous.

* ``gap_p50``: the median, over P, of the distance to the nearest
  candidate; ``gap_p99``, ``gap_mean`` and the widest, ``cand_gap``,
  beside it;
* ``nms_overlap``: the largest IoU (f64) between two proposals of P of one
  level, both unambiguous: NMS within a level at 0.7 keeps none above 0.7;
* ``cross_level_gap``: |pairs of P above the NMS threshold - R's pairs| over
  R's pairs (at least one), over every checked image. Within a level no
  pair passes NMS, so these pairs are of different levels, which never
  suppress each other: they are served as often as the reference keeps
  them;
* ``valid_gap``: the largest |num_valid - num_valid_ref|;
* ``kept_missed``: the largest share, over the images, of R's proposals
  that no proposal of P of the same level (one of its levels) overlaps by
  more than the NMS threshold; ``kept_missed_mean`` over all of R's
  proposals beside it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .reference import geometry

CHUNK = 1 << 15  # candidates compared with the served proposals at once
LEVEL_MARGIN = 0.1  # about twice the bf16 program's 99th-percentile gap at 1024 px


def nearest_by_level(P: torch.Tensor, S: torch.Tensor, C: torch.Tensor, CS: torch.Tensor,
                     bounds) -> torch.Tensor:
    """(n, levels) distance of each served proposal (boxes P, logits S) to
    the nearest candidate (boxes C, logits CS) of each level, the levels
    being the candidate ranges ``bounds``."""
    out = torch.full((P.shape[0], len(bounds)), float("inf"), device=P.device)
    for lv, (a0, a1) in enumerate(bounds):
        for a in range(a0, a1, CHUNK):
            b = min(a + CHUNK, a1)
            d = torch.maximum((P[:, None, :] - C[None, a:b]).abs().amax(-1),
                              (S[:, None] - CS[None, a:b]).abs())
            out[:, lv] = torch.minimum(out[:, lv], d.amin(1))
    return out


def _iou_off_diagonal(boxes: torch.Tensor) -> torch.Tensor:
    m = geometry.iou(boxes, boxes)
    m.fill_diagonal_(0.0)
    return m


def serve_numbers(cand_boxes: torch.Tensor, cand_logits: torch.Tensor, anchor_level: torch.Tensor,
                  ref_sel: dict, served: Dict[str, np.ndarray], nms_iou: float) -> dict:
    """The numbers' parts over a block of images: ``cand_boxes`` (B, N, 4)
    clipped and ``cand_logits`` (B, N), ``anchor_level`` (N,) (levels in
    order, each a contiguous range), ``ref_sel`` the reference's ``select``
    and ``served`` host arrays roi_boxes, roi_scores, num_valid."""
    dev = cand_boxes.device
    ends = torch.cumsum(torch.bincount(anchor_level.cpu()), 0).tolist()
    bounds = list(zip([0] + ends[:-1], ends))
    gaps, missed = [], []
    overlap, valid_gap, cross, cross_ref = 0.0, 0, 0, 0
    for i in range(cand_boxes.shape[0]):
        nv, nr = int(served["num_valid"][i]), int(ref_sel["num_valid"][i])
        valid_gap = max(valid_gap, abs(nv - nr))
        P = torch.from_numpy(np.asarray(served["roi_boxes"][i, :nv], np.float32)).to(dev)
        S = torch.logit(torch.from_numpy(np.asarray(served["roi_scores"][i, :nv], np.float64)))
        S = S.float().to(dev)
        R = torch.from_numpy(np.asarray(ref_sel["roi_boxes"][i, :nr], np.float64)).to(dev)
        r_lev = torch.from_numpy(ref_sel["level"][i][ref_sel["keep"][i]][:nr]).to(dev)
        cross_ref += int((_iou_off_diagonal(R) > nms_iou).sum()) // 2
        in_level = torch.zeros((nv, len(bounds)), dtype=torch.bool, device=dev)
        if nv:
            d = nearest_by_level(P, S, cand_boxes[i], cand_logits[i], bounds)
            best = d.amin(1)
            gaps.append(best.cpu().numpy())
            in_level = d <= best[:, None] + LEVEL_MARGIN
            m = _iou_off_diagonal(P.double())
            cross += int((m > nms_iou).sum()) // 2
            one = in_level.sum(1) == 1
            lev = in_level.float().argmax(1)
            same = one[:, None] & one[None, :] & (lev[:, None] == lev[None, :])
            overlap = max(overlap, float(torch.where(same, m, 0.0).max()))
        if nr:
            if nv:
                over = geometry.iou(R, P.double()) > nms_iou
                hit = (over & in_level.T[r_lev]).any(1)
            else:
                hit = torch.zeros(nr, dtype=torch.bool)
            missed.append((int((~hit).sum()), nr))
    return {"gaps": np.concatenate(gaps) if gaps else np.zeros(0, np.float32),
            "nms_overlap": overlap, "valid_gap": valid_gap, "missed": missed,
            "cross": cross, "cross_ref": cross_ref}


def merge_serve(parts: List[dict]) -> Dict[str, float]:
    """The numbers over every block."""
    g = np.concatenate([p["gaps"] for p in parts])
    missed = [m for p in parts for m in p["missed"]]
    q = np.quantile(g, [0.5, 0.99]) if g.size else (np.inf, np.inf)
    cross, cross_ref = sum(p["cross"] for p in parts), sum(p["cross_ref"] for p in parts)
    return {"gap_p50": float(q[0]), "gap_p99": float(q[1]),
            "gap_mean": float(g.mean()) if g.size else np.inf,
            "cand_gap": float(g.max()) if g.size else np.inf, "proposals": int(g.size),
            "nms_overlap": max(p["nms_overlap"] for p in parts),
            "cross_level_pairs": cross, "cross_level_pairs_ref": cross_ref,
            "cross_level_gap": abs(cross - cross_ref) / max(cross_ref, 1),
            "valid_gap": max(p["valid_gap"] for p in parts),
            "kept_missed": max((a / b for a, b in missed), default=0.0),
            "kept_missed_mean": sum(a for a, _ in missed) / max(sum(b for _, b in missed), 1)}
