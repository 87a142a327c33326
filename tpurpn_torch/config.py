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

``get_hyper_params("vitdet_b")`` is the RPN of ViTDet-B (Li et al. 2022,
arXiv:2203.16527; detectron2 ``projects/ViTDet/configs/COCO/
mask_rcnn_vitdet_b_100ep.py`` with the RPN of ``configs/common/models/
mask_rcnn_fpn.py``): a plain ViT-B/16 (``ViTConfig``) and a simple feature
pyramid P2-P6, one anchor size a level (``level_strides`` beside
``anchor_scales``), the top ``pre_nms_topn`` a level, NMS within a level, and
detectron2's box transform (``box_weights``, ``scale_clamp``, deltas in
(dx, dy, dw, dh) order). Inputs are resized so that the longest side is
``img_size``, normalised by ``pixel_mean`` / ``pixel_std`` and zero-padded to
the ``img_size`` square.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

VALID_BACKBONES = ("vgg16", "mobilenet_v2")
# backbones with a feature pyramid: anchors, NMS and the box transform by level
MULTI_LEVEL_BACKBONES = ("vitdet_b",)


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
class ViTConfig:
    """A plain ViT with window and global attention and decomposed relative
    positions, and the simple feature pyramid on its stride-16 map (ViTDet).
    Defaults: ViT-B/16 as ViTDet-B configures it."""

    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 16
    window_size: int = 14
    global_blocks: Tuple[int, ...] = (2, 5, 8, 11)  # the others attend in windows
    pretrain_img_size: int = 224  # the absolute positions' grid (with a cls token)
    ln_eps: float = 1e-6
    pyramid_channels: int = 256
    head_convs: int = 2  # 3x3 convs with ReLU before the 1x1 outputs


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
    # --- feature-pyramid configurations (multi_level), which decode by
    # box_weights and scale_clamp, not variances; unused otherwise ---
    level_strides: Tuple[int, ...] = ()  # anchor_scales[i] is level i's one size
    box_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)  # (dx, dy, dw, dh) divided by these
    scale_clamp: float = math.log(1000.0 / 16)  # dw and dh clamped above at this
    pixel_mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # RGB, 0-255 units
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    vit: ViTConfig | None = None

    @property
    def multi_level(self) -> bool:
        return bool(self.level_strides)

    @property
    def anchor_count(self) -> int:
        """Anchors a location (of a level, with a pyramid)."""
        if self.multi_level:
            return len(self.anchor_ratios)
        return len(self.anchor_ratios) * len(self.anchor_scales)

    @property
    def level_shapes(self) -> Tuple[int, ...]:
        """Each pyramid level's map size: P2-P5 at 4, 2, 1 and 1/2 times the
        ViT's stride-16 map (a 2x2 max-pool floors), P6 one in two of P5's."""
        fm = self.feature_map_shape
        p5 = fm // 2
        return (4 * fm, 2 * fm, fm, p5, (p5 + 1) // 2)

    @property
    def total_anchors(self) -> int:
        if self.multi_level:
            return sum(s * s for s in self.level_shapes) * self.anchor_count
        return self.feature_map_shape * self.feature_map_shape * self.anchor_count

    @property
    def stride(self) -> float:
        """Anchor grid stride in normalized coordinates (reference uses 1/fm)."""
        return 1.0 / self.feature_map_shape


def get_hyper_params(backbone: str = "vgg16", **kwargs) -> HyperParams:
    """Mirror of the reference's ``train_utils.get_hyper_params(backbone, **kwargs)``.

    Any field can be overridden by keyword; ``feature_map_shape`` is derived
    from the backbone + img_size unless explicitly given. For ``vitdet_b``,
    ``vit`` may be a ``ViTConfig`` or a dict of its fields to change.
    """
    if backbone in MULTI_LEVEL_BACKBONES:
        return _vitdet_hyper_params(backbone, **kwargs)
    if backbone not in VALID_BACKBONES:
        raise ValueError(f"backbone must be one of {VALID_BACKBONES + MULTI_LEVEL_BACKBONES}, "
                         f"got {backbone!r}")
    img_size = int(kwargs.pop("img_size", 500))
    fm = kwargs.pop("feature_map_shape", None)
    if fm is None:
        fm = feature_map_shape_for(backbone, img_size)
    # normalize sequence kwargs to tuples so the dataclass stays hashable
    for key in ("anchor_ratios", "anchor_scales", "variances"):
        if key in kwargs:
            kwargs[key] = tuple(kwargs[key])
    return HyperParams(backbone=backbone, img_size=img_size, feature_map_shape=int(fm), **kwargs)


def _vitdet_hyper_params(backbone: str, **kwargs) -> HyperParams:
    """ViTDet-B's RPN at 1024 px (detectron2's settings, see the module note)."""
    vit = kwargs.pop("vit", None)
    if isinstance(vit, dict):
        vit = ViTConfig(**vit)
    vit = vit or ViTConfig()
    if len(vit.global_blocks) and max(vit.global_blocks) >= vit.depth:
        raise ValueError(f"global_blocks {vit.global_blocks} outside depth {vit.depth}")
    img_size = int(kwargs.pop("img_size", 1024))
    if img_size % (4 * vit.patch_size):
        raise ValueError(f"img_size must be a multiple of {4 * vit.patch_size}, got {img_size}")
    for key in ("anchor_ratios", "anchor_scales", "variances", "level_strides", "box_weights",
                "pixel_mean", "pixel_std"):
        if key in kwargs:
            kwargs[key] = tuple(kwargs[key])
    fields = dict(
        anchor_ratios=(0.5, 1.0, 2.0),
        anchor_scales=(32.0, 64.0, 128.0, 256.0, 512.0),
        level_strides=(4, 8, 16, 32, 64),
        pre_nms_topn=1000,  # a level
        test_nms_topn=1000,
        nms_iou_threshold=0.7,
        pixel_mean=(123.675, 116.28, 103.53),
        pixel_std=(58.395, 57.12, 57.375),
    )
    fields.update(kwargs)
    fm = fields.pop("feature_map_shape", img_size // vit.patch_size)
    hp = HyperParams(backbone=backbone, img_size=img_size, feature_map_shape=int(fm), vit=vit,
                     **fields)
    if len(hp.anchor_scales) != len(hp.level_strides) or len(hp.level_strides) != 5:
        raise ValueError("vitdet_b has five levels (P2-P6), one anchor size each")
    return hp
