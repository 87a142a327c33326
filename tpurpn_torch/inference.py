"""Fused serving forward for MobileNetV2 (port of ``tpurpn/inference.py``).

  Conv1 (the module's, or the s2d stem)
  -> kernels.prefix (expanded_conv .. block_6: 13 prefix_pointwise and 7
     prefix_depthwise launches, bias, ReLU6 and residual in their epilogues)
  -> kernels.ir_stage.fused_ir_stage (blocks 7-12 + block_13_expand)
  -> RPN head (3x3 conv + 1x1 cls/reg)

Equivalent to the folded model's plain forward at bf16 tolerance
(tests/test_torch_model.py).

Raw uint8 frames take the space-to-depth (s2d) stem in front of it
(``fast_uint8_forward``): the bilinear resize emits the 2x2 s2d layout
directly (``s2d_resize``) and the 3x3 stride-2 Conv1 runs as the equivalent
2x2 stride-1 conv over it (``fold_conv1_s2d``), in place of
``data.preprocess_batch`` followed by Conv1. The head alone is
``model.apply_rpn_head`` (``tpurpn``'s ``RPNHeadOnly`` has no counterpart:
one copy of the head's code is its purpose, and that function is it).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from .backbones.mobilenet_v2 import relu6
from .cache import derived
from .config import HyperParams
from .kernels.ir_stage import fused_ir_stage, stage_weights_cached
from .kernels.prefix import prefix_blocks, prefix_weights_cached
from .model import RPN, apply_rpn_head
from .profiling import span

_PREFIX_BLOCKS = ("expanded_conv", "block_1", "block_2", "block_3", "block_4", "block_5",
                  "block_6")
_FUSED_BLOCKS = ("block_7", "block_8", "block_9", "block_10", "block_11",
                 "block_12")


def _check_folded(model: RPN, what: str) -> None:
    if not (model.hp.backbone == "mobilenet_v2" and model.fold_bn):
        raise ValueError(f"{what} requires the folded-BN mobilenet_v2 model")


def _fused_stage_from(
    model: RPN, x: torch.Tensor, skip_stem: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Images | Conv1 activations with ``skip_stem``) -> logits through the
    prefix (to block_6), the fused stage and the head: the stage boundaries
    (Conv1 / expanded_conv, block_6/7, the block_13_expand tail) live here
    only. Without ``skip_stem`` Conv1 runs as the module runs it; the
    prefix's blocks run on the prefix kernels, one launch a conv, in bf16
    (the module's ``forward``, which training runs, is not used). The
    prefix's and the stage's weights are packed once and reused until a
    parameter changes (``prefix_weights_cached``, ``stage_weights_cached``)."""
    bb = model.backbone
    with span("rpn.prefix"):
        if not skip_stem:
            x = relu6(bb.Conv1(x.to(bb.dtype).permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        feat6 = prefix_blocks(x.to(torch.bfloat16).contiguous(),
                              prefix_weights_cached(bb, _PREFIX_BLOCKS))
    weights, blocks = stage_weights_cached(bb, _FUSED_BLOCKS, tail_expand="block_13_expand")
    feat = fused_ir_stage(feat6, weights, blocks)
    with span("rpn.head"):
        return apply_rpn_head(model, feat)


@torch.no_grad()
def fast_mobilenet_forward(
    model: RPN, images: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC images -> (rpn_reg, rpn_cls_logits) via the fused mid-stage kernel.

    ``model`` must be the folded-BN mobilenet_v2 RPN (``model.fold_batch_norm``).
    """
    _check_folded(model, "fast_mobilenet_forward")
    return _fused_stage_from(model, images)


def s2d_stem_supported(hp: HyperParams, raw_shape) -> bool:
    """True when the s2d stem can serve (B, H, W, 3) frames of ``raw_shape``:
    an even ``img_size`` and frames no larger than it (``s2d_resize``'s
    conditions). ``predict.make_predict_fn(fast=True, from_uint8=True)``
    routes by this alone."""
    return (hp.img_size % 2 == 0 and raw_shape[1] <= hp.img_size
            and raw_shape[2] <= hp.img_size)


@functools.lru_cache(maxsize=None)
def _subgrid_weights(n_in: int, out_size: int, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """(out_size, n_in) bilinear weights of the two sub-grids of one axis
    (rows p*out/2 + u of sub-grid p, output index 2u + p), as
    ``jax.image.scale_and_translate(method="linear", antialias=False)``
    builds them for scale out / (2 n_in) and translation (0.5 - p) / 2: the
    sample coordinates, the 2-tap triangle weights, their normalization and
    the edge mask in f32, then cast to ``dtype``. Cached: a host-to-device
    copy in every serving call would wait for the card. Never evicted, since
    a serving CUDA graph reads the tensor at each replay: at most
    ``out_size`` entries an (out_size, dtype, device), one a frame side."""
    inv_scale = 1.0 / torch.tensor(out_size / (2.0 * n_in), dtype=torch.float32)
    half = out_size // 2
    u = torch.arange(half, dtype=torch.float32)
    mats = []
    for p in (0, 1):
        translation = torch.tensor((0.5 - p) / 2.0, dtype=torch.float32)
        sample = (u + 0.5) * inv_scale - translation * inv_scale - 0.5
        x = torch.abs(sample[:, None] - torch.arange(n_in, dtype=torch.float32)[None, :])
        w = torch.clamp(1.0 - x, min=0.0)
        total = w.sum(dim=1, keepdim=True)
        w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                        w / torch.where(total != 0, total, 1.0), 0.0)
        inside = (sample >= -0.5) & (sample <= n_in - 0.5)
        mats.append(torch.where(inside[:, None], w, 0.0))
    return torch.cat(mats).to(device=device, dtype=dtype)


def s2d_resize(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Bilinear-resize NHWC ``x`` to (out_size, out_size) and emit it in the
    2x2 space-to-depth layout (B, out/2, out/2, 4C).

    Sub-grid (p, q), the output pixels (2u + p, 2v + q), is itself a linear
    resize (``_subgrid_weights``); channel blocks are ordered [p0q0, p0q1,
    p1q0, p1q1] x C, the order ``fold_conv1_s2d`` assumes. The weights are
    dense (out/2, in) matrices in ``x``'s dtype, applied as two matmuls
    (rows, then columns), as ``scale_and_translate`` contracts them; the
    sample coordinates stay f32 (bf16 ones drift by whole pixels).

    Valid for an upsampling full resize only (H, W <= out_size): the
    sub-grids then keep the plain 2-tap kernel the full resize uses, which a
    downsampling resize (antialiased) would not.
    """
    B, H, W, C = x.shape
    assert out_size % 2 == 0, (
        "s2d_resize requires an even out_size: the 2x2 factorization (and "
        "fold_conv1_s2d's ((0,1),(0,1)) pad reproducing SAME) holds at even sizes", out_size)
    assert H <= out_size and W <= out_size, (
        "s2d_resize requires an upsampling full resize", (H, W, out_size))
    half = out_size // 2
    wy = _subgrid_weights(H, out_size, x.dtype, x.device)  # (2*half, H)
    wx = _subgrid_weights(W, out_size, x.dtype, x.device)  # (2*half, W)
    y = torch.matmul(wy, x.permute(0, 3, 1, 2))  # (B, C, [p, u], W)
    y = torch.matmul(y, wx.t())  # (B, C, [p, u], [q, v])
    y = y.reshape(B, C, 2, half, 2, half).permute(0, 3, 5, 2, 4, 1)
    return y.reshape(B, half, half, 4 * C)


def fold_conv1_s2d(weight: torch.Tensor, bias: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the 3x3 stride-2 Conv1 into a 2x2 stride-1 conv over 2x2-s2d input.

    Exact: tap (ky, kx) of input pixel (2i+u, 2j+v) lives at s2d position
    (i+du, j+dv), channel block u*2+v, where (du, u) = divmod(ky, 2) and
    (dv, v) = divmod(kx, 2), matching ``s2d_resize``'s block order. The
    folded conv pads ((0, 1), (0, 1)), SAME's single trailing zero row and
    column at even input sizes.

    ``weight`` (Cout, Cin, 3, 3), ``bias`` (Cout,): the folded-BN Conv1.
    Returns (w4 (Cout, 4 Cin, 2, 2), bias), in the dtypes given.
    """
    cout, cin, kh, kw = weight.shape
    assert (kh, kw) == (3, 3), (kh, kw)
    # taps padded to 4x4 so tap (2*du+u, 2*dv+v) indexes cleanly; the taps 3
    # are the zero rows and columns
    wp = F.pad(weight, (0, 1, 0, 1))
    w4 = (wp.reshape(cout, cin, 2, 2, 2, 2)  # (cout, cin, du, u, dv, v)
          .permute(0, 3, 5, 1, 2, 4)  # (cout, u, v, cin, du, dv)
          .reshape(cout, 4 * cin, 2, 2))  # channel block u*2+v
    return w4, bias


def s2d_conv1(model: RPN) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded Conv1 (``fold_conv1_s2d``) in the compute dtype, its
    weight channels-last: once per version of Conv1's weight and bias
    (``cache.derived``)."""
    conv1, dtype = model.backbone.Conv1, model.dtype

    def make():
        w4, b1 = fold_conv1_s2d(conv1.weight, conv1.bias)
        return w4.to(dtype).contiguous(memory_format=torch.channels_last), b1.to(dtype)

    return derived((conv1.weight, conv1.bias), ("s2d_conv1", dtype), make)


def s2d_uint8_stem(model: RPN, raw: torch.Tensor) -> torch.Tensor:
    """Raw uint8 frames (B, H, W, 3) -> Conv1 activations
    (B, img/2, img/2, 32) NHWC: ``data.preprocess_batch`` (uint8 -> [0,1]
    in the compute dtype, bilinear resize to ``img_size``) followed by the
    folded Conv1 + ReLU6, with the resize emitting s2d (``s2d_resize``) and
    Conv1 as the folded 2x2 conv (``fold_conv1_s2d``). Needs raw H, W <=
    ``img_size``."""
    with span("rpn.stem"):
        dtype = model.dtype
        w4, b1 = s2d_conv1(model)
        x = raw.to(dtype) / torch.full((), 255.0, dtype=dtype, device=raw.device)
        x12 = s2d_resize(x, model.hp.img_size).permute(0, 3, 1, 2)  # channels-last NCHW
        x12 = F.pad(x12, (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)
        return relu6(F.conv2d(x12, w4, b1)).permute(0, 2, 3, 1)


@torch.no_grad()
def fast_uint8_forward(
    model: RPN, raw: torch.Tensor, fused_stage: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw uint8 frames -> (rpn_reg, rpn_cls_logits): the serving forward
    with the s2d stem (``s2d_uint8_stem``) in place of preprocess + Conv1.

    ``fused_stage=True`` also runs the backbone's mid-stage as the fused IR
    stage kernel (``fast_mobilenet_forward``'s path); False runs the rest of
    the backbone as cuDNN convs. ``model`` must be the folded-BN
    mobilenet_v2 RPN.
    """
    _check_folded(model, "fast_uint8_forward")
    feat1 = s2d_uint8_stem(model, raw)
    if fused_stage:
        return _fused_stage_from(model, feat1, skip_stem=True)
    return apply_rpn_head(model, model.backbone(feat1, skip_stem=True))
