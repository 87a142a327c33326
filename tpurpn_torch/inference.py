"""Fused serving forward for MobileNetV2 (port of ``tpurpn/inference.py``).

  torch prefix (Conv1 .. block_6, cuDNN convs)
  -> kernels.ir_stage.fused_ir_stage (blocks 7-12 + block_13_expand)
  -> RPN head (3x3 conv + 1x1 cls/reg)

Equivalent to the folded model's plain forward at bf16 tolerance
(tests/test_torch_model.py). The space-to-depth uint8 stem of ``tpurpn``
(``s2d_uint8_stem``, ``fast_uint8_forward``) is not ported yet: raw frames go
through ``data.preprocess_batch`` and then this forward.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .kernels.ir_stage import fused_ir_stage, stage_weights_cached
from .model import RPN, apply_rpn_head

_FUSED_BLOCKS = ("block_7", "block_8", "block_9", "block_10", "block_11",
                 "block_12")


def _fused_stage_from(
    model: RPN, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images -> logits through the prefix (to block_6), the fused stage
    and the head: the stage boundary (block_6/7 split, block_13_expand tail)
    lives here only. The stage's weights are packed once and reused until a
    parameter changes (``stage_weights_cached``)."""
    bb = model.backbone
    feat6 = bb(x, stop_after_block=6)
    weights, blocks = stage_weights_cached(bb, _FUSED_BLOCKS, tail_expand="block_13_expand")
    feat = fused_ir_stage(feat6.to(torch.bfloat16).contiguous(), weights, blocks)
    return apply_rpn_head(model, feat)


@torch.no_grad()
def fast_mobilenet_forward(
    model: RPN, images: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC images -> (rpn_reg, rpn_cls_logits) via the fused mid-stage kernel.

    ``model`` must be the folded-BN mobilenet_v2 RPN (``model.fold_batch_norm``).
    """
    if not (model.hp.backbone == "mobilenet_v2" and model.fold_bn):
        raise ValueError("fast_mobilenet_forward needs the folded-BN mobilenet_v2 model")
    return _fused_stage_from(model, images)
