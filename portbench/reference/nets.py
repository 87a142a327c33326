"""MobileNetV2 (alpha 1.0, Sandler et al. 2018) to block_13_expand_relu and
VGG16 (Simonyan and Zisserman 2014) to block5_conv3, each with the tf-rpn
RPN head (a 3x3 conv to 512 with ReLU, then 1x1 convs to 9 logits and 36
deltas), in plain float32 PyTorch, NCHW.

Weights are a dict of f32 tensors: MobileNetV2's under the Keras layer names
of the weight file (``Conv1/kernel`` HWIO, ``block_1_depthwise/
depthwise_kernel`` (3, 3, C, 1), BatchNorm ``gamma/beta/moving_mean/
moving_variance``, eps 1e-3, in inference mode); VGG16's as OIHW tensors
under ``backbone.block<b>_conv<j>.weight`` / ``.bias`` and the head's
under ``rpn_conv``, ``rpn_cls``, ``rpn_reg``. Stride-2 convolutions pad as
TF "SAME" does (the extra row and column after).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..counts import MOBILENET_V2_STAGES, VGG16_BLOCKS

Params = Dict[str, torch.Tensor]


def _round8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


class _Fp8Grad(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e4m3 backward."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round8(g)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    at 448), back in f32; the gradient passes straight through."""
    return t + (_round8(t.detach()) - t).detach()


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
         stride: int = 1, groups: int = 1, quant: Optional[str] = None) -> torch.Tensor:
    """SAME convolution of NCHW ``x`` with OIHW ``w``."""
    if quant == "fp8":
        # operands rounded forward; the gradient of the output rounded
        # backward, so both passes compute on fp8 values
        y = conv(fp8(x), fp8(w), b, stride, groups)
        return _Fp8Grad.apply(y) if y.requires_grad else y
    k = w.shape[-1]
    if stride == 1:
        return F.conv2d(x, w, b, 1, (k - 1) // 2, 1, groups)
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, b, stride, 0, 1, groups)


def head(p: Params, feat: torch.Tensor, names: Tuple[str, str, str], quant=None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NCHW features -> (deltas (B, N, 4), logits (B, N)), N ordered
    (y, x, anchor)."""
    (cw, cb), (lw, lb), (rw, rb) = (_wb(p, n) for n in names)
    h = torch.relu(conv(feat, cw, cb, quant=quant))
    cls = conv(h, lw, lb, quant=quant).permute(0, 2, 3, 1)
    reg = conv(h, rw, rb, quant=quant).permute(0, 2, 3, 1)
    return reg.reshape(reg.shape[0], -1, 4), cls.reshape(cls.shape[0], -1)


def _wb(p: Params, name: str):
    if f"{name}/kernel" in p:  # Keras layout
        return p[f"{name}/kernel"].permute(3, 2, 0, 1), p.get(f"{name}/bias")
    return p[f"{name}.weight"], p.get(f"{name}.bias")


def _bn(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, p[f"{name}/moving_mean"], p[f"{name}/moving_variance"],
                        p[f"{name}/gamma"], p[f"{name}/beta"], False, 0.0, 1e-3)


def _relu6(x):
    return x.clamp(0.0, 6.0)


def mobilenet_v2(p: Params, x: torch.Tensor, quant=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC f32 images -> (deltas, logits) through MobileNetV2 to
    block_13_expand_relu and the head."""
    x = x.permute(0, 3, 1, 2)
    x = _relu6(_bn(p, "bn_Conv1", conv(x, _wb(p, "Conv1")[0], stride=2, quant=quant)))
    c, bid = 32, 0
    for n, t, c_out, s in MOBILENET_V2_STAGES:
        for i in range(n):
            nm = "expanded_conv" if bid == 0 else f"block_{bid}"
            stride = s if i == 0 else 1
            h = x
            if t != 1:
                h = _relu6(_bn(p, f"{nm}_expand_BN",
                               conv(h, _wb(p, f"{nm}_expand")[0], quant=quant)))
            dw = p[f"{nm}_depthwise/depthwise_kernel"].permute(2, 3, 0, 1)
            h = _relu6(_bn(p, f"{nm}_depthwise_BN",
                           conv(h, dw, stride=stride, groups=dw.shape[0], quant=quant)))
            h = _bn(p, f"{nm}_project_BN", conv(h, _wb(p, f"{nm}_project")[0], quant=quant))
            x = h + x if stride == 1 and c == c_out else h
            c, bid = c_out, bid + 1
    x = _relu6(_bn(p, "block_13_expand_BN", conv(x, _wb(p, "block_13_expand")[0], quant=quant)))
    return head(p, x, ("rpn_conv", "rpn_cls", "rpn_reg"), quant)


def vgg16_names():
    """The VGG16 RPN's leaves in order, (name, OIHW shape) pairs."""
    out, c = [], 3
    for b, chans in enumerate(VGG16_BLOCKS, start=1):
        for j, c_out in enumerate(chans, start=1):
            out += [(f"backbone.block{b}_conv{j}.weight", (c_out, c, 3, 3)),
                    (f"backbone.block{b}_conv{j}.bias", (c_out,))]
            c = c_out
    return out + [("rpn_conv.weight", (512, 512, 3, 3)), ("rpn_conv.bias", (512,)),
                  ("rpn_cls.weight", (9, 512, 1, 1)), ("rpn_cls.bias", (9,)),
                  ("rpn_reg.weight", (36, 512, 1, 1)), ("rpn_reg.bias", (36,))]


def vgg16(p: Params, x: torch.Tensor, quant=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC f32 images -> (deltas, logits) through VGG16 to block5_conv3
    and the head."""
    x = x.permute(0, 3, 1, 2)
    for b, chans in enumerate(VGG16_BLOCKS, start=1):
        if b > 1:
            x = F.max_pool2d(x, 2, 2)
        for j in range(1, len(chans) + 1):
            w, bias = _wb(p, f"backbone.block{b}_conv{j}")
            x = torch.relu(conv(x, w, bias, quant=quant))
    return head(p, x, ("rpn_conv", "rpn_cls", "rpn_reg"), quant)

