"""The numbers that decide ``correct``: what the timed path produced, judged
against the plain reference (``portbench/reference``) on the same inputs.

Serving, per sampled image (the served proposals P, the reference's f32
candidates C: every anchor's decoded box and score):

* ``gap_p50``: the median, over the proposals of P, of the distance to
  the nearest candidate of C, max(|box - box_c|_inf, |score - score_c|):
  a served proposal has to be one of the image's candidates, with its box
  and score, to the precision the configuration states. ``gap_p99``,
  ``gap_mean`` and the widest, ``cand_gap``, are reported beside it (the
  widest swings with bf16's tail from seed to seed; PERF.md).
* ``nms_overlap``: the largest IoU between two proposals of P (f64). Greedy
  NMS at 0.7 keeps none above the configuration's 0.7.
* ``valid_gap``: the largest |num_valid - num_valid_ref| over the images,
  against the reference's own selection R (top ``pre_nms_topn`` of C,
  greedy NMS at the configuration's threshold, the first ``test_nms_topn``
  kept).
* ``kept_missed``: the largest share, over the images, of R's proposals
  (every one of them) that no proposal of P overlaps by more than the
  NMS threshold: a served box within that IoU of a kept one would have
  suppressed it, or been suppressed by it. ``kept_missed_mean``, over all
  of R's proposals, is reported beside it.

Training, over the first three steps (program and reference from the same
leaves, batches and draws):

* ``loss1_gap`` and ``loss_gap``: |loss - loss_ref| / |loss_ref| of the
  first step, and the widest of the three.
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient, | |g| - |g_ref| |, over max(|g_ref| of the leaf, the median
  leaf's).
* ``change_gap``: the same for the parameters' change over the three
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's. ``grad_gap_median`` and ``change_gap_median``, the
  median leaf's, are reported beside them.

Which numbers a cell judges, and their limits, are in its workload file.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .reference import geometry


def serve_numbers(ref_boxes: torch.Tensor, ref_scores: torch.Tensor, ref_sel: Dict[str, np.ndarray],
                  served: Dict[str, np.ndarray], nms_iou: float) -> Dict[str, float]:
    """The serving numbers' parts over a block of images; ``served`` and
    ``ref_sel`` hold host arrays roi_boxes (B, topn, 4), roi_scores (B, topn),
    num_valid (B,), ``ref_sel`` the reference's selection from the
    candidates ``ref_boxes`` (B, N, 4) and ``ref_scores`` (B, N)."""
    dev = ref_boxes.device
    gaps, missed = [], []
    overlap, valid_gap = 0.0, 0
    for i in range(ref_boxes.shape[0]):
        nv, nr = int(served["num_valid"][i]), int(ref_sel["num_valid"][i])
        valid_gap = max(valid_gap, abs(nv - nr))
        P = torch.from_numpy(np.asarray(served["roi_boxes"][i, :nv], np.float32)).to(dev)
        S = torch.from_numpy(np.asarray(served["roi_scores"][i, :nv], np.float32)).to(dev)
        R = torch.from_numpy(np.asarray(ref_sel["roi_boxes"][i, :nr], np.float64)).to(dev)
        cb, cs = ref_boxes[i], ref_scores[i]
        if nv:
            d = torch.maximum((P[:, None, :] - cb[None]).abs().amax(-1),
                              (S[:, None] - cs[None]).abs())
            gaps.append(d.amin(1).cpu().numpy())
            pd = P.double()
            m = geometry.iou(pd, pd)
            m.fill_diagonal_(0.0)
            overlap = max(overlap, float(m.max()))
        if nr:
            hit = (geometry.iou(R, P.double()).amax(1) > nms_iou if nv
                   else torch.zeros(nr, dtype=torch.bool))
            missed.append((int((~hit).sum()), nr))
    return {"gaps": np.concatenate(gaps) if gaps else np.zeros(0, np.float32),
            "nms_overlap": overlap, "valid_gap": valid_gap, "missed": missed}


def merge_serve(parts: List[dict]) -> Dict[str, float]:
    """The numbers over every block: the gaps' statistics, the largest
    overlap and count gap, the worst image's missed share."""
    g = np.concatenate([p["gaps"] for p in parts])
    missed = [m for p in parts for m in p["missed"]]
    # nothing served: every gap statistic fails its limit
    q = np.quantile(g, [0.5, 0.99]) if g.size else (np.inf, np.inf)
    return {"gap_p50": float(q[0]), "gap_p99": float(q[1]),
            "gap_mean": float(g.mean()) if g.size else np.inf,
            "cand_gap": float(g.max()) if g.size else np.inf, "proposals": int(g.size),
            "nms_overlap": max(p["nms_overlap"] for p in parts),
            "valid_gap": max(p["valid_gap"] for p in parts),
            "kept_missed": max((a / b for a, b in missed), default=0.0),
            "kept_missed_mean": sum(a for a, _ in missed) / max(sum(b for _, b in missed), 1)}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], among=None) -> np.ndarray:
    """Each leaf's | |x| - |x_ref| | / max(|x_ref|, median leaf's |x_ref|)."""
    med = float(np.median(list(ref.values())))
    names = list(ref) if among is None else among
    return np.array([abs(prog[n] - ref[n]) / max(ref[n], med) for n in names])


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (3 floats), ``grad1`` and
    ``change`` ({leaf: norm})."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    med = float(np.median(list(ref["grad1"].values())))
    moving = [n for n, g in ref["grad1"].items() if g >= 1e-3 * med]
    g = leaf_gaps(prog["grad1"], ref["grad1"])
    c = leaf_gaps(prog["change"], ref["change"], moving)
    return {"loss_gap": loss_gap, "loss1_gap": abs(prog["losses"][0] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "grad_gap": float(g.max()), "change_gap": float(c.max()),
            "grad_gap_median": float(np.median(g)), "change_gap_median": float(np.median(c))}
