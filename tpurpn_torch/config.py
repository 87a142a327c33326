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

``get_hyper_params("mvitv2_b")`` is the RPN of MViTv2-B (Li et al. 2022,
arXiv:2112.01526; detectron2 ``projects/MViTv2/configs/
cascade_mask_rcnn_mvitv2_b_3x.py`` with the FPN and RPN of
``configs/common/models/mask_rcnn_fpn.py``): the multiscale ViT with pooling
attention (``MViTConfig``), a top-down FPN on its four stages, P6, and the
same anchors, box transform and level-wise selection as ViTDet. Its canvas
follows detectron2's test path, ``canvas_rule`` = (short side, longest
side, size divisor): the shortest side resized to 800 unless the longest
then passes 1333, the image zero-padded below and right to a multiple of
32 (``canvas_of``). A 480 x 640 frame becomes 800 x 1067 on an 800 x 1088
canvas. Without a rule the canvas is the ``img_size`` square (ViTDet's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

VALID_BACKBONES = ("vgg16", "mobilenet_v2")
# backbones with a feature pyramid: anchors, NMS and the box transform by level
MULTI_LEVEL_BACKBONES = ("vitdet_b", "mvitv2_b", "swin_b")


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


def resized_shape(h: int, w: int, size: int, max_size: int | None = None) -> Tuple[int, int]:
    """detectron2's ``ResizeShortestEdge(size, max_size)`` output shape (the
    default ``max_size`` is ``size``): the shortest side to ``size`` unless
    the longest then exceeds ``max_size``, which it then is; rounded half
    up."""
    max_size = size if max_size is None else max_size
    scale = size / min(h, w)
    nh, nw = (size, scale * w) if h < w else (scale * h, size)
    if max(nh, nw) > max_size:
        scale = max_size / max(nh, nw)
        nh, nw = nh * scale, nw * scale
    return int(nh + 0.5), int(nw + 0.5)


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
class MViTConfig:
    """The multiscale ViT v2 with pooling attention, hybrid window and global
    blocks and decomposed relative positions, and the top-down FPN on its
    four stage outputs (detectron2's ``MViT`` and ``FPN``). Defaults:
    MViTv2-B as detectron2's 3x COCO recipe configures it."""

    embed_dim: int = 96  # stage 2's width; each later stage doubles it
    depth: int = 24
    num_heads: int = 1  # stage 2's; each later stage doubles them
    last_block_indexes: Tuple[int, ...] = (1, 4, 20, 23)  # the stages' last blocks
    mlp_ratio: float = 4.0
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    pool_kernel: int = 3  # the q, k and v pooling convs' (and the skip max-pool's) side
    adaptive_kv_stride: int = 4  # stage 2's key stride; halved each stage, to 1
    adaptive_window_size: int = 56  # stage 2's query window; halved after each stage's first block
    residual_pooling: bool = True
    pretrain_img_size: int = 224  # the relative-position tables' grid
    ln_eps: float = 1e-6
    fpn_channels: int = 256
    head_convs: int = 1  # 3x3 convs with ReLU before the 1x1 outputs

    def blocks(self) -> Tuple[dict, ...]:
        """Each block's settings as detectron2's ``MViT.__init__`` derives
        them: ``dim`` in, ``dim_out``, ``heads``, ``stride_q``,
        ``stride_kv``, ``window`` (0: global) and ``table`` (the rows of
        its relative-position tables at the pre-training size)."""
        last = self.last_block_indexes
        dim = dim_out = self.embed_dim
        heads, stride_kv, window = self.num_heads, self.adaptive_kv_stride, self.adaptive_window_size
        size = self.pretrain_img_size // self.patch_stride
        out = []
        for i in range(self.depth):
            skv = stride_kv * 2 if i in (last[1], last[2]) else stride_kv
            sq = 2 if i - 1 in last else 1
            out.append(dict(dim=dim, dim_out=dim_out, heads=heads, stride_q=sq, stride_kv=skv,
                            window=0 if i in last[1:] else window,
                            table=2 * max(size // sq, size // skv) - 1))
            dim = dim_out
            if i in last:
                dim_out, heads, stride_kv = dim_out * 2, heads * 2, max(stride_kv // 2, 1)
            if i - 1 in last:
                window, size = window // 2, size // 2
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """The Swin Transformer: shifted-window attention with a learned
    relative-position bias, patch merging between its four stages, a
    LayerNorm on each stage's output, and the top-down FPN on them
    (``backbones.swin``). Defaults: Swin-B as mmdetection's Swin
    configuration of its authors sets it."""

    embed_dim: int = 128  # stage 1's width; each later stage doubles it
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 7  # the shift is window_size // 2, every second block of a stage
    mlp_ratio: float = 4.0
    patch_size: int = 4
    ln_eps: float = 1e-5
    fpn_channels: int = 256
    head_convs: int = 1  # 3x3 convs with ReLU before the 1x1 outputs


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
    mvit: MViTConfig | None = None
    swin: SwinConfig | None = None
    # (short side, longest side, size divisor) of a canvas that follows the
    # frames' shape (``canvas_of``); () for the img_size square
    canvas_rule: Tuple[int, ...] = ()

    @property
    def multi_level(self) -> bool:
        return bool(self.level_strides)

    def canvas_of(self, h: int, w: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """(the resized image's (h, w), the canvas (H, W)) of an h x w frame:
        detectron2's ``ResizeShortestEdge`` and, with ``canvas_rule``, the
        padding to the size divisor, else the ``img_size`` square."""
        if not self.canvas_rule:
            s = self.img_size
            return resized_shape(h, w, s), (s, s)
        short, longest, div = self.canvas_rule
        nh, nw = resized_shape(h, w, short, longest)
        return (nh, nw), (-(-nh // div) * div, -(-nw // div) * div)

    @property
    def canvas(self) -> Tuple[int, int] | None:
        """The canvas whatever the frames (the square), or None where it
        follows them (``canvas_rule``)."""
        return None if self.canvas_rule else (self.img_size, self.img_size)

    @property
    def anchor_count(self) -> int:
        """Anchors a location (of a level, with a pyramid)."""
        if self.multi_level:
            return len(self.anchor_ratios)
        return len(self.anchor_ratios) * len(self.anchor_scales)

    def level_shapes(self, canvas: Tuple[int, int] | None = None) -> Tuple[Tuple[int, int], ...]:
        """Each pyramid level's (h, w) on ``canvas`` (default: ``canvas``).
        ViTDet: P2-P5 at 4, 2, 1 and 1/2 times the ViT's stride-16 map (a
        2x2 max-pool floors); MViTv2: the patch embedding's stride-4 map,
        then each stage's stride-2 pooling (3x3, padding 1: it ceils);
        Swin: the canvas over the patch size (ceiled, as its patch
        embedding pads), then each patch merging's halving (it pads to
        even: it ceils); P6 one in two of P5's."""
        canvas = canvas or self.canvas
        if canvas is None:
            raise ValueError(f"{self.backbone}'s canvas follows the frames: pass the canvas "
                             "(canvas_of)")
        if self.vit is not None:
            gh, gw = canvas[0] // self.vit.patch_size, canvas[1] // self.vit.patch_size
            shapes = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), (gh // 2, gw // 2)]
        else:
            if self.swin is not None:
                shapes = [tuple(-(-s // self.swin.patch_size) for s in canvas)]
            else:
                m = self.mvit
                shapes = [tuple((s + 2 * m.patch_padding - m.patch_kernel) // m.patch_stride + 1
                                for s in canvas)]
            for _ in range(3):
                shapes.append(tuple(-(-s // 2) for s in shapes[-1]))
        return tuple(shapes) + (tuple(-(-s // 2) for s in shapes[-1]),)

    @property
    def total_anchors(self) -> int:
        if self.multi_level:
            return sum(h * w for h, w in self.level_shapes()) * self.anchor_count
        return self.feature_map_shape * self.feature_map_shape * self.anchor_count

    @property
    def stride(self) -> float:
        """Anchor grid stride in normalized coordinates (reference uses 1/fm)."""
        return 1.0 / self.feature_map_shape


def get_hyper_params(backbone: str = "vgg16", **kwargs) -> HyperParams:
    """Mirror of the reference's ``train_utils.get_hyper_params(backbone, **kwargs)``.

    Any field can be overridden by keyword; ``feature_map_shape`` is derived
    from the backbone + img_size unless explicitly given. For ``vitdet_b``,
    ``vit`` may be a ``ViTConfig`` or a dict of its fields to change; for
    ``mvitv2_b``, ``mvit`` an ``MViTConfig`` or such a dict; for ``swin_b``,
    ``swin`` a ``SwinConfig`` or such a dict.
    """
    if backbone in ("mvitv2_b", "swin_b"):
        return _canvas_hyper_params(backbone, **kwargs)
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


# detectron2's mask_rcnn_fpn.py RPN at test time, with ImageNet's RGB pixel
# statistics on the 0-255 scale: shared by both pyramid configurations
_PYRAMID_RPN = dict(
    anchor_ratios=(0.5, 1.0, 2.0),
    anchor_scales=(32.0, 64.0, 128.0, 256.0, 512.0),
    level_strides=(4, 8, 16, 32, 64),
    pre_nms_topn=1000,  # a level
    test_nms_topn=1000,
    nms_iou_threshold=0.7,
    pixel_mean=(123.675, 116.28, 103.53),
    pixel_std=(58.395, 57.12, 57.375),
)
_SEQUENCE_FIELDS = ("anchor_ratios", "anchor_scales", "variances", "level_strides", "box_weights",
                    "pixel_mean", "pixel_std", "canvas_rule")


def _net_config(backbone: str, net) -> MViTConfig | SwinConfig:
    """The backbone's configuration from ``None`` (the published one), a
    dict of fields to change or the dataclass, checked."""
    cls = MViTConfig if backbone == "mvitv2_b" else SwinConfig
    if isinstance(net, dict):
        net = cls(**net)
    net = net or cls()
    if cls is MViTConfig:
        last = net.last_block_indexes
        if len(last) != 4 or max(last) != net.depth - 1:
            raise ValueError(f"last_block_indexes {last}: four stages ending with block "
                             f"{net.depth - 1}")
    elif (len(net.depths) != 4 or len(net.num_heads) != 4
          or any((net.embed_dim << i) % h for i, h in enumerate(net.num_heads))):
        raise ValueError(f"depths {net.depths}, num_heads {net.num_heads}: four stages, each "
                         f"width (embed_dim {net.embed_dim}, doubled a stage) a multiple of "
                         "its heads")
    return net


def _canvas_hyper_params(backbone: str, **kwargs) -> HyperParams:
    """MViTv2-B's or Swin-B's RPN on detectron2's 800 / 1333 test canvas
    (see the module note)."""
    key = "mvit" if backbone == "mvitv2_b" else "swin"
    net = _net_config(backbone, kwargs.pop(key, None))
    for k in _SEQUENCE_FIELDS:
        if k in kwargs:
            kwargs[k] = tuple(kwargs[k])
    fields = dict(_PYRAMID_RPN, canvas_rule=(800, 1333, 32))
    fields.update(kwargs)
    rule = fields["canvas_rule"]
    if len(rule) != 3 or rule[2] % 32:
        raise ValueError(f"canvas_rule {rule}: (short side, longest side, a divisor that is a "
                         "multiple of 32, the top-down pyramid's stride)")
    img_size = int(fields.pop("img_size", rule[0]))
    fm = fields.pop("feature_map_shape", img_size // 16)
    hp = HyperParams(backbone=backbone, img_size=img_size, feature_map_shape=int(fm),
                     **{key: net}, **fields)
    if len(hp.anchor_scales) != len(hp.level_strides) or len(hp.level_strides) != 5:
        raise ValueError(f"{backbone} has five levels (P2-P6), one anchor size each")
    return hp


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
    for key in _SEQUENCE_FIELDS:
        if key in kwargs:
            kwargs[key] = tuple(kwargs[key])
    fields = dict(_PYRAMID_RPN)
    fields.update(kwargs)
    fm = fields.pop("feature_map_shape", img_size // vit.patch_size)
    hp = HyperParams(backbone=backbone, img_size=img_size, feature_map_shape=int(fm), vit=vit,
                     **fields)
    if len(hp.anchor_scales) != len(hp.level_strides) or len(hp.level_strides) != 5:
        raise ValueError("vitdet_b has five levels (P2-P6), one anchor size each")
    return hp
