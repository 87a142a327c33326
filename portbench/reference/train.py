"""The training step in the reference: preprocess (resize, flip) -> targets
-> forward -> smooth-L1 + BCE -> backward -> SGD with momentum 0.9
(trace = g + 0.9 trace; p -= lr trace), in float32 or, with
``quant="fp8"``, the control. Leaves start from what the harness made."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import geometry, nets


def steps(p0: Dict[str, torch.Tensor], batches: Sequence[tuple], cfg: dict,
          quant=None) -> dict:
    """Run ``len(batches)`` steps from leaves ``p0``; each batch is (uint8
    frames, GT boxes, GT labels, flip mask, (B, 2, N) words) on one device.
    Returns ``losses`` (one a step), ``grad1`` (each leaf's first gradient
    norm) and ``change`` (each leaf's |p - p0| after the steps)."""
    img = cfg["img_size"]
    fm = geometry.feature_map(cfg["backbone"], img)
    dev = next(iter(p0.values())).device
    anc = torch.from_numpy(geometry.anchors(img, fm)).to(dev)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    trace = {k: torch.zeros_like(v) for k, v in p.items()}
    if cfg["backbone"] != "vgg16":
        raise ValueError(f"no training reference for {cfg['backbone']!r}")
    net = nets.vgg16
    lr, mom = cfg["learning_rate"], cfg["momentum"]
    losses: List[float] = []
    grad1 = None
    for frames, gt, gt_labels, flip, words in batches:
        x, boxes = geometry.preprocess(frames, img, gt, flip)
        with torch.no_grad():
            deltas, labels = geometry.targets(anc, boxes, gt_labels, words,
                                              n_pos=cfg["total_pos_bboxes"],
                                              n_neg=cfg["total_neg_bboxes"])
        reg, cls = net(p, x, quant)
        l_reg, l_cls = geometry.rpn_loss(deltas, labels, reg, cls)
        loss = l_reg + l_cls
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                trace[k].mul_(mom).add_(g)
                v.sub_(lr * trace[k])
        if grad1 is None:
            grad1 = {k: float(g.norm()) for k, g in zip(p, grads)}
        del x, reg, cls, grads
    change = {k: float((p[k].detach() - p0[k]).norm()) for k in p}
    return {"losses": losses, "grad1": grad1, "change": change}
