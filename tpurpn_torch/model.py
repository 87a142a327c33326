"""RPN model: backbone + shared 3x3 conv head + 1x1 cls/reg branches
(port of ``tpurpn/model.py``).

Rebuild of the reference's ``models/rpn_mobilenet_v2.get_model`` (SURVEY.md
§3.3): a stride-16 backbone feature map, a shared ``Conv2D(512, 3, same,
relu)`` ("rpn_conv"), and two 1x1 branches — ``rpn_cls`` (anchor_count
objectness logits) and ``rpn_reg`` (4*anchor_count deltas). Output order
matches the reference: ``(rpn_reg, rpn_cls)``, NHWC, float32.

Compute is bf16 with f32 parameters; the head outputs are cast to f32. The
backbone is MobileNetV2 or VGG16, as ``hp.backbone`` says. ``model.train()``
is ``tpurpn``'s ``apply(..., train=True)``: it puts the BatchNorms in
batch-statistics mode (``backbones.mobilenet_v2.BatchNorm``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from .backbones import MobileNetV2Backbone, VGG16Backbone
from .backbones.mobilenet_v2 import BatchNorm, Conv
from .config import HyperParams


def default_device(device=None) -> torch.device:
    """The port runs on the card unless the caller names another device."""
    return torch.device("cuda" if device is None else device)


def apply_rpn_head(
    model: "RPN", feat: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RPN head on NHWC features, shared by ``RPN.forward`` and the fast
    serving path (``tpurpn_torch.inference``). Returns f32 (rpn_reg, rpn_cls)."""
    x = feat.to(model.dtype).permute(0, 3, 1, 2)
    x = torch.relu(model.rpn_conv(x))
    rpn_cls = model.rpn_cls(x).permute(0, 2, 3, 1)
    rpn_reg = model.rpn_reg(x).permute(0, 2, 3, 1)
    # head outputs in fp32: the decode math wants full precision
    return rpn_reg.float(), rpn_cls.float()


class RPN(nn.Module):
    """NHWC image batch -> (rpn_reg, rpn_cls_logits)."""

    def __init__(self, hp: HyperParams, fold_bn: bool = False):
        super().__init__()
        self.hp = hp
        self.dtype = getattr(torch, hp.compute_dtype)
        if hp.backbone == "vgg16":
            self.fold_bn = False  # no BatchNorm to fold
            self.backbone = VGG16Backbone(dtype=self.dtype)
            feat_ch = VGG16Backbone.out_channels
        elif hp.backbone == "mobilenet_v2":
            self.fold_bn = fold_bn
            self.backbone = MobileNetV2Backbone(
                dtype=self.dtype, fold_bn=fold_bn, bn_momentum=hp.bn_momentum
            )
            feat_ch = 576
        else:
            raise ValueError(f"unknown backbone {hp.backbone!r}")
        # rpn_conv (3x3, 512, relu) -> rpn_cls (1x1, A) / rpn_reg (1x1, 4A)
        self.rpn_conv = Conv(feat_ch, 512, 3, bias=True)
        self.rpn_cls = Conv(512, hp.anchor_count, 1, bias=True)
        self.rpn_reg = Conv(512, 4 * hp.anchor_count, 1, bias=True)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return apply_rpn_head(self, self.backbone(images))


def get_model(hp: HyperParams) -> RPN:
    """Mirror of the reference's ``get_model(hyper_params)``."""
    return RPN(hp)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator):
    """flax's default conv init: variance-scaling 1/fan_in, truncated normal
    at two standard deviations (fan_in = in_ch/groups * kh * kw)."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_model(model: RPN, generator: torch.Generator | None = None,
               device=None) -> RPN:
    """Mirror of the reference's ``init_model``: initialize ``model`` in place
    with flax's default initializers (lecun-normal conv kernels, zero biases,
    unit BN scale/variance, zero BN shift/mean) drawn from ``generator``, move
    it to ``device`` (default: cuda) and return it in eval mode.

    The numbers differ from ``tpurpn``'s for the same seed (jax.random and
    torch.Generator are different generators); parity tests convert the
    flax variables instead (``tpurpn_torch.convert``).
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, Conv):
            _lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    return to_device(model, device)


def to_device(model: nn.Module, device=None) -> nn.Module:
    """Move to ``device`` (default: cuda), channels-last conv weights, eval mode."""
    model = model.to(default_device(device), memory_format=torch.channels_last)
    return model.eval()


@torch.no_grad()
def fold_batch_norm(model: RPN) -> RPN:
    """Fold BatchNorms into conv weights/biases for inference.

    With frozen statistics BN(conv(x)) == conv'(x), where kernel' = kernel * g
    and bias' = beta - mean * g (+ conv_bias * g), g = gamma / sqrt(var + eps):
    the arithmetic of ``tpurpn.model.fold_batch_norm``, op for op. Returns a
    new ``RPN(fold_bn=True)`` on the same device; ``model`` is unchanged.
    VGG16 has no BatchNorm and is returned as it is.
    """
    hp = model.hp
    if hp.backbone != "mobilenet_v2":
        return model
    folded = RPN(hp, fold_bn=True)
    eps = 1e-3
    src = model.backbone
    dst = folded.backbone

    def fold_into(dst_conv, conv, bn):
        # sqrt in f64, rounded once to f32: the correctly rounded f32 sqrt
        # that XLA computes (torch's vectorized CPU f32 sqrt is off by 1 ulp
        # on some inputs)
        g = bn.weight / torch.sqrt((bn.running_var + eps).double()).float()
        dst_conv.weight.copy_(conv.weight * g[:, None, None, None])
        bias = bn.bias - bn.running_mean * g
        if conv.bias is not None:
            bias = bias + conv.bias * g
        dst_conv.bias.copy_(bias)

    fold_into(dst.Conv1, src.Conv1, src.bn_Conv1)
    fold_into(dst.block_13_expand, src.block_13_expand, src.block_13_expand_BN)
    for name in src.block_names():
        sblk, dblk = src.get_submodule(name), dst.get_submodule(name)
        for cname, conv in sblk.named_children():
            if isinstance(conv, Conv):
                fold_into(dblk.get_submodule(cname), conv,
                          sblk.get_submodule(f"{cname}_BN"))
    for head in ("rpn_conv", "rpn_cls", "rpn_reg"):
        folded.get_submodule(head).load_state_dict(
            model.get_submodule(head).state_dict()
        )
    device = next(model.parameters()).device
    return to_device(folded, device)
