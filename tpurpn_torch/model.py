"""RPN model: backbone + shared 3x3 conv head + 1x1 cls/reg branches
(port of ``tpurpn/model.py``).

Rebuild of the reference's ``models/rpn_mobilenet_v2.get_model`` (SURVEY.md
§3.3): a stride-16 backbone feature map, a shared ``Conv2D(512, 3, same,
relu)`` ("rpn_conv"), and two 1x1 branches — ``rpn_cls`` (anchor_count
objectness logits) and ``rpn_reg`` (4*anchor_count deltas). Output order
matches the reference: ``(rpn_reg, rpn_cls)``, NHWC, float32.

Compute is bf16 with f32 parameters, which every layer reads through their
compute copies (``cache.compute_copy``: a cast at each use while autograd
records, else one copy per parameter version, so that serving casts no
weight after its first call); the head outputs are cast to f32. The
backbone is MobileNetV2 or VGG16, as ``hp.backbone`` says. ``model.train()``
is ``tpurpn``'s ``apply(..., train=True)``: it puts the BatchNorms in
batch-statistics mode (``backbones.mobilenet_v2.BatchNorm``).

``hp.multi_level`` builds ``PyramidRPN`` instead: the backbone and neck that
``hp`` names (``vitdet_b``: the ViT and its simple feature pyramid,
``backbones.vit``; ``mvitv2_b``: the multiscale ViT and the top-down FPN,
``backbones.mvit``; ``swin_b``: the Swin Transformer, ``backbones.swin``,
and the same FPN), and detectron2's ``StandardRPNHead`` shared over the
five levels (``head_convs`` 3x3 convs with ReLU, then 1x1 convs to A
objectness logits and 4A deltas in (dx, dy, dw, dh) order).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .backbones import MobileNetV2Backbone, VGG16Backbone
from .backbones import mvit, swin, vit
from .backbones.mobilenet_v2 import BatchNorm, Conv
from .cache import compute_copy
from .config import HyperParams
from .profiling import span


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


class PyramidRPN(nn.Module):
    """NHWC image canvas (B, H, W, 3), normalised and padded -> every level's
    (deltas (B, N, 4) in (dx, dy, dw, dh) order, objectness logits (B, N)),
    f32, the levels concatenated P2 first, each row-major over (y, x,
    anchor)."""

    def __init__(self, hp: HyperParams):
        super().__init__()
        self.hp = hp
        self.fold_bn = False
        self.dtype = getattr(torch, hp.compute_dtype)
        if hp.mvit is not None or hp.swin is not None:
            cfg = hp.mvit or hp.swin
            c = cfg.fpn_channels
            self.backbone = (mvit.MViT(cfg, self.dtype) if hp.mvit is not None
                             else swin.SwinTransformer(cfg, self.dtype))
            self.pyramid = mvit.FPN(self.backbone.out_channels, c)
        else:
            cfg = hp.vit
            c = cfg.pyramid_channels
            self.backbone = vit.ViT(cfg, hp.img_size, self.dtype)
            self.pyramid = vit.SimpleFeaturePyramid(cfg.embed_dim, c, cfg.ln_eps)
        self.head_convs = nn.ModuleList(nn.Conv2d(c, c, 3, padding=1)
                                        for _ in range(cfg.head_convs))
        self.objectness = nn.Conv2d(c, hp.anchor_count, 1)
        self.deltas = nn.Conv2d(c, 4 * hp.anchor_count, 1)

    def _head(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        d = self.dtype
        for conv in self.head_convs:
            x = torch.relu(F.conv2d(x, compute_copy(conv.weight, d), compute_copy(conv.bias, d),
                                    padding=1))
        logits = F.conv2d(x, compute_copy(self.objectness.weight, d),
                          compute_copy(self.objectness.bias, d))
        deltas = F.conv2d(x, compute_copy(self.deltas.weight, d), compute_copy(self.deltas.bias, d))
        b = x.shape[0]
        return (deltas.permute(0, 2, 3, 1).reshape(b, -1, 4),
                logits.permute(0, 2, 3, 1).reshape(b, -1))

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with span("rpn.backbone"):
            x = self.backbone(images)
        with span("rpn.pyramid"):
            levels = self.pyramid(x)
        with span("rpn.head"):
            out = [self._head(f) for f in levels]
            return (torch.cat([o[0] for o in out], 1).float(),
                    torch.cat([o[1] for o in out], 1).float())


def get_model(hp: HyperParams) -> nn.Module:
    """Mirror of the reference's ``get_model(hyper_params)``."""
    if hp.multi_level:
        return PyramidRPN(hp)
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

    A ``PyramidRPN`` takes detectron2's initializers instead
    (``_init_pyramid_rpn``).
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if isinstance(model, PyramidRPN):
        _init_pyramid_rpn(model, generator)
        return to_device(model, device)
    for m in model.modules():
        if isinstance(m, Conv):
            _lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    return to_device(model, device)


def _init_pyramid_rpn(model: PyramidRPN, g: torch.Generator) -> None:
    """detectron2's initialization of a pyramid RPN: the backbone's linear
    layers (and the ViT's absolute positions) truncated normal at std 0.02,
    biases 0, LayerNorms 1 and 0, relative positions 0
    (``rel_pos_zero_init``), Swin's relative-position bias tables normal at
    std 0.02 (its ``trunc_normal_``, whose bounds of +-2 cut nothing), the
    patch embedding and MViT's pooling convs PyTorch's default (uniform over
    +-1/sqrt(fan_in); no bias on the pooling convs); ViTDet's simple
    pyramid's convs He-normal over fan-out (``c2_msra_fill``), the FPN's
    He-uniform with a = 1 over fan-in (``c2_xavier_fill``), biases 0; the
    RPN head normal at std 0.01, biases 0."""
    for name, m in model.named_modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, 0.0, 0.02, -0.04, 0.04, generator=g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (vit.Attention, mvit.PooledAttention)):
            nn.init.zeros_(m.rel_pos_h)
            nn.init.zeros_(m.rel_pos_w)
        elif isinstance(m, swin.WindowAttention):
            nn.init.trunc_normal_(m.relative_position_bias_table, 0.0, 0.02, -2.0, 2.0,
                                  generator=g)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            if name == "backbone.patch_embed" or ".pool_" in name:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.weight, -bound, bound, generator=g)
                if m.bias is not None:
                    nn.init.uniform_(m.bias, -bound, bound, generator=g)
                continue
            if name.startswith("pyramid.fpn_"):
                nn.init.kaiming_uniform_(m.weight, a=1, generator=g)
            elif name.startswith("pyramid."):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                        generator=g)
            else:
                nn.init.normal_(m.weight, 0.0, 0.01, generator=g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    if isinstance(model.backbone, vit.ViT):
        nn.init.trunc_normal_(model.backbone.pos_embed, 0.0, 0.02, -0.04, 0.04, generator=g)


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
