"""Proposal generation: decode head outputs -> top-k -> NMS (port of
``tpurpn/predict.py``).

Rebuild of the reference's predictor hot loop (rpn_predictor.py, SURVEY.md
§3.2): reshape head outputs to (B, N, 4) / (B, N), scale deltas by the
variances, decode against the anchor grid, keep the pre_nms_topn
highest-scoring boxes, then greedy NMS down to test_nms_topn. Proposals come
back as fixed-size (B, topn, 4) plus a validity count per image.

``generate_proposals`` is the plain pipeline; ``make_predict_fn`` selects
through ``kernels.proposal.fused_proposals``, which launches the CUDA
kernel on the card (the counterpart of ``tpurpn``'s
``decode_outputs_packed`` + ``generate_proposals_packed``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from .anchors import generate_anchors
from .boxes import get_bboxes_from_deltas
from .config import HyperParams
from .kernels.proposal import fused_proposals, fused_proposals_plain
from .model import RPN, default_device
from .profiling import span


def decode_outputs(
    anchors: torch.Tensor,
    rpn_reg: torch.Tensor,
    rpn_cls_logits: torch.Tensor,
    hp: HyperParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head outputs -> (boxes (B, N, 4), scores (B, N)): deltas times the
    variances, decoded against the anchors; sigmoid objectness."""
    B = rpn_reg.shape[0]
    variances = torch.tensor(hp.variances, dtype=torch.float32, device=rpn_reg.device)
    deltas = rpn_reg.reshape(B, -1, 4) * variances
    scores = torch.sigmoid(rpn_cls_logits.reshape(B, -1))
    boxes = get_bboxes_from_deltas(anchors[None], deltas)
    return boxes, scores


def generate_proposals(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    hp: HyperParams,
    topn: int | None = None,
    nms_block: int = 128,
) -> Dict[str, torch.Tensor]:
    """Top-k + NMS proposal selection in plain PyTorch.

    Returns {roi_boxes (B, topn, 4), roi_scores (B, topn) (0 past
    num_valid), num_valid (B,) int32}.
    """
    if topn is None:
        topn = hp.test_nms_topn
    pre = min(hp.pre_nms_topn, boxes.shape[1])
    return fused_proposals_plain(
        boxes, scores, pre, hp.nms_iou_threshold, topn, block=nms_block
    )


def make_predict_fn(
    model: RPN,
    hp: HyperParams,
    topn: int | None = None,
    fast: bool = False,
    from_uint8: bool = False,
    device=None,
    mesh=None,
) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """Build the inference step: NHWC images -> proposals, on ``device``
    (default: cuda; ``model`` must live there).

    The forward, decode, top-k and NMS all stay on the device; selection goes
    through ``kernels.proposal.fused_proposals`` (the CUDA kernel on the
    card, its plain version on the CPU).

    ``fast=True`` (folded-BN mobilenet_v2 only) swaps the backbone
    mid-stage for the fused inverted-residual kernel (``tpurpn_torch.
    inference``); outputs agree with the plain forward at bf16 tolerance.

    ``from_uint8=True`` takes raw uint8 frames: uint8 -> [0,1] in the compute
    dtype and a bilinear resize to ``hp.img_size`` (``data.preprocess_batch``)
    run before the forward. With ``fast=True``, frames that
    ``inference.s2d_stem_supported`` accepts (even ``img_size``, frames no
    larger) go through ``inference.fast_uint8_forward`` instead: the resize
    emits the 2x2 space-to-depth layout and Conv1 runs folded into a 2x2
    conv, as in ``tpurpn``.

    With ``mesh`` (``train.make_data_mesh``) every rank passes its rows of the
    batch (``train.shard_batch``), serves them, and gets the whole batch's
    proposals, gathered from every rank in rank order. ``fast=True`` with a
    mesh raises, as in ``tpurpn``.
    """
    if fast and mesh is not None:
        raise ValueError("fast=True is the single-device serving path: use fast=False with "
                         "a mesh, or one single-device predict fn per device")
    device = default_device(device)
    anchors = generate_anchors(hp, device)
    out_topn = hp.test_nms_topn if topn is None else topn
    pre = min(hp.pre_nms_topn, hp.total_anchors)
    dtype = getattr(torch, hp.compute_dtype)
    if fast and not (hp.backbone == "mobilenet_v2" and model.fold_bn):
        raise ValueError("fast=True requires the folded-BN mobilenet_v2 model")

    def forward(images: torch.Tensor):
        if from_uint8:
            # a hard error: a float frame would be silently renormalized by
            # /255 into a near-black image
            if images.dtype != torch.uint8:
                raise TypeError(
                    f"from_uint8=True expects raw uint8 frames; got {images.dtype}"
                )
            from . import inference

            if fast and inference.s2d_stem_supported(hp, images.shape):
                return inference.fast_uint8_forward(model, images)
            from .data import preprocess_batch

            with span("rpn.stem"):
                images, _ = preprocess_batch(
                    images, torch.zeros((images.shape[0], 1, 4), device=device),
                    hp.img_size, dtype=dtype,
                )
        if fast:
            from .inference import fast_mobilenet_forward

            return fast_mobilenet_forward(model, images)
        return model(images)

    @torch.no_grad()
    def predict_fn(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with span("rpn.predict"):
            with span("rpn.upload"):
                images = images.to(device)
            rpn_reg, rpn_cls = forward(images)
            with span("rpn.decode"):
                boxes, scores = decode_outputs(anchors, rpn_reg, rpn_cls, hp)
            with span("rpn.select"):
                out = fused_proposals(boxes, scores, pre, hp.nms_iou_threshold, out_topn)
            if mesh is None:
                return out
            group = mesh.get_group()
            gathered = {}
            for k, v in out.items():
                parts = [torch.empty_like(v) for _ in range(mesh.size())]
                dist.all_gather(parts, v.contiguous(), group=group)
                gathered[k] = torch.cat(parts)
            return gathered

    return predict_fn
