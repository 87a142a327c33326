"""Hyper-parameter configuration for the PyTorch port of the RPN.

A copy of ``tpurpn/config.py`` (the JAX package's ``__init__`` imports jax, so
the port cannot import it). Mirrors the reference's
``utils/train_utils.get_hyper_params(backbone)`` plain dict (reference:
utils/train_utils.py, SURVEY.md §5 "Config/flag system") as a frozen, hashable
dataclass; ``compute_dtype`` / ``param_dtype`` name torch dtypes
(``getattr(torch, hp.compute_dtype)``).

Field names intentionally match the reference's hyper_params keys so users of
the reference find the same knobs here. Defaults follow SURVEY.md §5:
HIGH-confidence values come from BASELINE.json:5 (anchor scales/ratios, NMS
top-n values, 128/128 balanced sampling); MED-confidence thresholds use the
canonical Faster R-CNN (Ren et al. 2015) semantics: pos IoU > 0.7,
neg IoU < 0.3, ignore in between.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

VALID_BACKBONES = ("vgg16", "mobilenet_v2")


def _vgg16_feature_map_shape(img_size: int) -> int:
    """Spatial size of VGG16's block5_conv3 output (stride 16, VALID pools).

    VGG16 applies 4 max-pools (2x2, stride 2, VALID) before block5_conv3, each
    flooring: 500 -> 250 -> 125 -> 62 -> 31 (reference: models/rpn_vgg16.py taps
    block5_conv3; SURVEY.md §2 row 3).
    """
    size = img_size
    for _ in range(4):
        size = size // 2
    return size


def _mobilenet_v2_feature_map_shape(img_size: int) -> int:
    """Spatial size at block_13_expand_relu (stride 16, SAME convs, ceil).

    MobileNetV2 reaches stride 16 through 4 stride-2 SAME convolutions, each
    ceiling: 500 -> 250 -> 125 -> 63 -> 32 (reference: models/rpn_mobilenet_v2.py
    taps block_13_expand_relu; SURVEY.md §2 row 4).
    """
    size = img_size
    for _ in range(4):
        size = math.ceil(size / 2)
    return size


def feature_map_shape_for(backbone: str, img_size: int) -> int:
    if backbone == "vgg16":
        return _vgg16_feature_map_shape(img_size)
    if backbone == "mobilenet_v2":
        return _mobilenet_v2_feature_map_shape(img_size)
    raise ValueError(f"backbone must be one of {VALID_BACKBONES}, got {backbone!r}")


@dataclasses.dataclass(frozen=True)
class HyperParams:
    """Immutable hyper-parameter bundle; hashable -> usable as a jit static arg."""

    backbone: str = "vgg16"
    img_size: int = 500
    feature_map_shape: int = 31
    anchor_ratios: Tuple[float, ...] = (1.0, 2.0, 0.5)
    anchor_scales: Tuple[float, ...] = (128.0, 256.0, 512.0)
    pre_nms_topn: int = 6000
    train_nms_topn: int = 1500
    test_nms_topn: int = 300
    nms_iou_threshold: float = 0.7
    total_pos_bboxes: int = 128
    total_neg_bboxes: int = 128
    pos_threshold: float = 0.7
    neg_threshold: float = 0.3
    variances: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    # --- TPU-native additions (not in the reference) ---
    max_gt_boxes: int = 64  # static pad for variable-length GT (XLA static shapes)
    bn_momentum: float = 0.99  # running-stats momentum (Keras uses 0.999;
    # 0.99 adapts in hundreds of steps instead of tens of thousands)
    compute_dtype: str = "bfloat16"  # backbone/head compute dtype on the MXU
    param_dtype: str = "float32"

    @property
    def anchor_count(self) -> int:
        return len(self.anchor_ratios) * len(self.anchor_scales)

    @property
    def total_anchors(self) -> int:
        return self.feature_map_shape * self.feature_map_shape * self.anchor_count

    @property
    def stride(self) -> float:
        """Anchor grid stride in normalized coordinates (reference uses 1/fm)."""
        return 1.0 / self.feature_map_shape


def get_hyper_params(backbone: str = "vgg16", **kwargs) -> HyperParams:
    """Mirror of the reference's ``train_utils.get_hyper_params(backbone, **kwargs)``.

    Any field can be overridden by keyword; ``feature_map_shape`` is derived
    from the backbone + img_size unless explicitly given.
    """
    if backbone not in VALID_BACKBONES:
        raise ValueError(f"backbone must be one of {VALID_BACKBONES}, got {backbone!r}")
    img_size = int(kwargs.pop("img_size", 500))
    fm = kwargs.pop("feature_map_shape", None)
    if fm is None:
        fm = feature_map_shape_for(backbone, img_size)
    # normalize sequence kwargs to tuples so the dataclass stays hashable
    for key in ("anchor_ratios", "anchor_scales", "variances"):
        if key in kwargs:
            kwargs[key] = tuple(kwargs[key])
    return HyperParams(backbone=backbone, img_size=img_size, feature_map_shape=int(fm), **kwargs)
