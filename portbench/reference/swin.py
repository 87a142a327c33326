"""Swin-B's RPN (Liu, Lin, Cao, Hu, Wei, Zhang, Lin, Guo 2021, "Swin
Transformer: Hierarchical Vision Transformer using Shifted Windows",
arXiv:2103.14030) in plain float32 PyTorch: the reference the port is held
to. It follows the authors' detection code, Swin-Transformer-Object-
Detection's ``configs/swin/cascade_mask_rcnn_swin_base_patch4_window7_
mstrain_480-800_giou_4conv1f_adamw_3x_coco.py`` (the backbone of ``mmdet/
models/backbones/swin_transformer.py``; the FPN and RPN of ``configs/
_base_/models/cascade_mask_rcnn_swin_fpn.py``), and its test path
equation by equation, on whole images, each attention in chunks of
windows. It imports only ``torch`` and the benchmark's ``reference.mvit``
and ``reference.vitdet`` helpers: nothing of the port, of ``tpurpn`` or
of JAX. No kernels, no cache; matmuls and convolutions in true f32
(``strict_f32``).

The network, as ``SwinTransformer``, ``BasicLayer``,
``SwinTransformerBlock``, ``WindowAttention`` and ``PatchMerging`` compute
it: a 4 x 4 patch embedding at stride 4 and its LayerNorm; four stages of
2, 2, 18, 2 blocks; a block's ``norm1``, zero padding below and right to
multiples of the window, the cyclic roll by -3 in every second block,
the window cut, attention with the relative-position bias gathered by
``relative_position_index`` and, after a roll, ``BasicLayer``'s
``attn_mask`` (-100 between the regions of the rolled grid), the merge
back, the roll back, the crop, the residual, then ``norm2`` and the MLP;
patch merging between stages; each stage's output through its own
LayerNorm; mmdetection's FPN (``reference.mvit.fpn``: lateral 1 x 1 and
output 3 x 3 convs with biases, nearest upsampling to the finer map, which
is exactly twice the coarser one on these canvases, P6 by a max-pool of
kernel 1 at stride 2) and the one-conv RPN head.

``cfg`` is a dict: ``embed_dim``, ``depths``, ``num_heads``,
``window_size``, ``mlp_ratio``, ``patch_size``, ``ln_eps``,
``fpn_channels``, ``head_convs``, ``min_size_test``, ``max_size_test``,
``size_divisibility``, ``anchor_sizes``, ``anchor_ratios``, ``strides``,
``pre_nms_topk`` (a level), ``post_nms_topk``, ``nms_thresh``,
``box_weights``, ``scale_clamp``, ``pixel_mean``, ``pixel_std``; ``init``
(the stds of ``draw_params``).

Departures from mmdetection, each deliberate: those of ``reference.mvit``
(boxes [y1, x1, y2, x2] over the canvas's height and width; stable sorts,
ties to the lower index; NMS within a level as one greedy walk over the
merged score order, ``batched_nms`` without its offsets; frames resized
bilinearly in f32 and not rounded back to uint8; ``roi_scores`` the kept
logits' sigmoids), and the box transform and the selection as detectron2
computes them, which mmdetection's RPN configuration matches (anchor
scale 8 at strides 4-64, ratios 0.5, 1, 2, centre offset 0; deltas of stds
1; the top 1,000 of a level, NMS 0.7 within a level, 1,000 kept, no
minimum size) but for one term: dw and dh are clamped above at
``scale_clamp`` = log(1000 / 16) and not also below at its negative
(``wh_ratio_clip``), a bound no drawn delta reaches. The canvas is a
multiple of the patch size, so the patch embedding pads nothing.

``quant="fp8"`` rounds both operands of every product (linear, conv,
attention) to float8 e4m3 with one scale a tensor: the control, a precision
below the bf16 that the configuration states.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import mvit
from .mvit import _conv, canvas, clip, fpn, preprocess  # noqa: F401  (the driver's)
from .vitdet import _q, apply_deltas, layer_norm, linear, rpn_head, strict_f32
from .vitdet import window_partition, window_unpartition

Params = Dict[str, torch.Tensor]
CHUNK_SCORES = 1 << 27  # scores of one attention chunk (512 MB in f32)


# ---------------------------------------------------------------------------
# the stages and their parameters
# ---------------------------------------------------------------------------


def stages(cfg: dict) -> List[dict]:
    """Each stage's ``dim``, ``depth`` and ``heads``: the width doubles and
    patch merging follows every stage but the last."""
    return [{"dim": cfg["embed_dim"] * 2 ** i, "depth": n, "heads": h}
            for i, (n, h) in enumerate(zip(cfg["depths"], cfg["num_heads"]))]


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the order ``draw_params`` draws them."""
    c0, p, m = cfg["embed_dim"], cfg["patch_size"], cfg["window_size"]
    out = {"backbone.patch_embed.weight": (c0, 3, p, p), "backbone.patch_embed.bias": (c0,),
           "backbone.patch_norm.weight": (c0,), "backbone.patch_norm.bias": (c0,)}
    st = stages(cfg)
    for i, s in enumerate(st):
        c, hidden = s["dim"], int(s["dim"] * cfg["mlp_ratio"])
        for j in range(s["depth"]):
            b = f"backbone.layers.{i}.blocks.{j}."
            out.update({b + "norm1.weight": (c,), b + "norm1.bias": (c,),
                        b + "attn.qkv.weight": (3 * c, c), b + "attn.qkv.bias": (3 * c,),
                        b + "attn.proj.weight": (c, c), b + "attn.proj.bias": (c,),
                        b + "attn.relative_position_bias_table": ((2 * m - 1) ** 2, s["heads"]),
                        b + "norm2.weight": (c,), b + "norm2.bias": (c,),
                        b + "mlp.fc1.weight": (hidden, c), b + "mlp.fc1.bias": (hidden,),
                        b + "mlp.fc2.weight": (c, hidden), b + "mlp.fc2.bias": (c,)})
        if i < len(st) - 1:
            d = f"backbone.layers.{i}.downsample."
            out.update({d + "norm.weight": (4 * c,), d + "norm.bias": (4 * c,),
                        d + "reduction.weight": (2 * c, 4 * c)})
    for i, s in enumerate(st):
        out.update({f"backbone.norm{i}.weight": (s["dim"],),
                    f"backbone.norm{i}.bias": (s["dim"],)})
    o = cfg["fpn_channels"]
    for stage, s in enumerate(st, 2):
        out.update({f"pyramid.fpn_lateral{stage}.weight": (o, s["dim"], 1, 1),
                    f"pyramid.fpn_lateral{stage}.bias": (o,),
                    f"pyramid.fpn_output{stage}.weight": (o, o, 3, 3),
                    f"pyramid.fpn_output{stage}.bias": (o,)})
    a = len(cfg["anchor_ratios"])
    for i in range(cfg["head_convs"]):
        out.update({f"head_convs.{i}.weight": (o, o, 3, 3), f"head_convs.{i}.bias": (o,)})
    out.update({"objectness.weight": (a, o, 1, 1), "objectness.bias": (a,),
                "deltas.weight": (4 * a, o, 1, 1), "deltas.bias": (4 * a,)})
    return out


def _init_group(name: str) -> str:
    """The ``init`` entry a parameter is drawn with."""
    if "norm" in name:
        return "norm_weight" if name.endswith("weight") else "norm_bias"
    if "relative_position_bias_table" in name:
        return "rel_pos_bias"
    if name.startswith("backbone.patch_embed."):
        return "patch_" + name.rsplit(".", 1)[1]
    if name.startswith("backbone."):
        return "linear_bias" if name.endswith("bias") else "linear_weight"
    if name.startswith("pyramid."):
        return "fpn_bias" if name.endswith("bias") else "fpn_weight"
    if name.startswith("head_convs."):
        return "head_conv_bias" if name.endswith("bias") else "head_conv_weight"
    return name.replace(".", "_")  # objectness_weight, deltas_bias, ...


def draw_params(cfg: dict, seed: int, device="cpu") -> Params:
    """Every parameter from normal draws of one generator seeded with
    ``seed``, in ``param_shapes``' order: LayerNorm weights about 1, all else
    about 0, each group at its std in ``cfg["init"]``; a ``*_weight`` std
    named ``"fan_in"`` is 1 / sqrt(fan_in) (inputs times the kernel's
    area)."""
    g = torch.Generator().manual_seed(int(seed))
    init, out = cfg["init"], {}
    for name, shape in param_shapes(cfg).items():
        group = _init_group(name)
        std = init[group]
        if std == "fan_in":
            std = 1.0 / math.sqrt(math.prod(shape[1:]))
        t = torch.randn(shape, generator=g) * float(std)
        out[name] = (t + 1.0 if group == "norm_weight" else t).to(device)
    return out


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def relative_position_bias(table: torch.Tensor, window: int) -> torch.Tensor:
    """(h, M^2, M^2): ``table`` gathered by ``WindowAttention``'s
    ``relative_position_index``."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    index = rel.sum(-1)
    t = window * window
    return table[index.view(-1).to(table.device)].view(t, t, -1).permute(2, 0, 1)


def shift_mask(hp: int, wp: int, window: int, shift: int) -> torch.Tensor:
    """(nW, M^2, M^2): ``BasicLayer``'s ``attn_mask`` on a padded (Hp, Wp)
    grid, the rolled grid's regions labelled, cut into windows, -100.0
    between two labels that differ."""
    img_mask = torch.zeros((1, hp, wp, 1))
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, window)[0].view(-1, window * window)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(attn_mask == 0, 0.0)


def window_attention(p: Params, pre: str, x: torch.Tensor, heads: int, window: int,
                     mask: Optional[torch.Tensor], quant=None) -> torch.Tensor:
    """``WindowAttention``: (B nW, M^2, C) windows -> (B nW, M^2, C), the
    mask (nW, M^2, M^2) added to window n as mask[n mod nW], in chunks of
    windows of at most ``CHUNK_SCORES`` scores."""
    n, t, c = x.shape
    d = c // heads
    qkv = linear(x, p[pre + "qkv.weight"], p[pre + "qkv.bias"], quant)
    q, k, v = qkv.reshape(n, t, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    bias = relative_position_bias(p[pre + "relative_position_bias_table"], window)
    out = torch.empty_like(q)
    step = max(1, CHUNK_SCORES // (heads * t * t))
    for a in range(0, n, step):
        attn = _q(q[a:a + step] * d ** -0.5, quant) @ _q(k[a:a + step], quant).transpose(-2, -1)
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            idx = torch.arange(a, a + attn.shape[0], device=attn.device) % mask.shape[0]
            attn = attn + mask[idx].unsqueeze(1)
        out[a:a + step] = _q(attn.softmax(dim=-1), quant) @ _q(v[a:a + step], quant)
    out = out.transpose(1, 2).reshape(n, t, c)
    return linear(out, p[pre + "proj.weight"], p[pre + "proj.bias"], quant)


def block(p: Params, pre: str, x: torch.Tensor, heads: int, window: int, shift: int,
          cfg: dict, quant=None) -> torch.Tensor:
    """``SwinTransformerBlock`` on (B, H, W, C) tokens."""
    B, H, W, C = x.shape
    eps = cfg["ln_eps"]
    shortcut = x
    x = layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"], eps)
    pad_r, pad_b = (window - W % window) % window, (window - H % window) % window
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    Hp, Wp = H + pad_b, W + pad_r
    mask = None
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        mask = shift_mask(Hp, Wp, window, shift).to(x.device)
    x_windows, _ = window_partition(x, window)
    attn = window_attention(p, pre + "attn.", x_windows.view(-1, window * window, C), heads,
                            window, mask, quant)
    x = window_unpartition(attn.view(-1, window, window, C), window, (Hp, Wp), (Hp, Wp))
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x[:, :H, :W, :]
    y = layer_norm(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"], eps)
    y = linear(F.gelu(linear(y, p[pre + "mlp.fc1.weight"], p[pre + "mlp.fc1.bias"], quant)),
               p[pre + "mlp.fc2.weight"], p[pre + "mlp.fc2.bias"], quant)
    return x + y


def patch_merging(p: Params, pre: str, x: torch.Tensor, eps: float, quant=None) -> torch.Tensor:
    """``PatchMerging``: (B, H, W, C) -> (B, ceil(H / 2), ceil(W / 2), 2C)."""
    _, H, W, _ = x.shape
    if H % 2 == 1 or W % 2 == 1:
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x = torch.cat([x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :], x[:, 0::2, 1::2, :],
                   x[:, 1::2, 1::2, :]], -1)
    x = layer_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"], eps)
    return linear(x, p[pre + "reduction.weight"], None, quant)


def swin(p: Params, x: torch.Tensor, cfg: dict, quant=None) -> List[torch.Tensor]:
    """NCHW canvas (B, 3, H, W) -> the stages' normalised maps, NCHW
    (``SwinTransformer.forward`` with ``out_indices`` (0, 1, 2, 3))."""
    eps, m = cfg["ln_eps"], cfg["window_size"]
    x = _conv(x, p["backbone.patch_embed.weight"], p["backbone.patch_embed.bias"], quant,
              stride=cfg["patch_size"]).permute(0, 2, 3, 1)
    x = layer_norm(x, p["backbone.patch_norm.weight"], p["backbone.patch_norm.bias"], eps)
    st, outs = stages(cfg), []
    for i, s in enumerate(st):
        for j in range(s["depth"]):
            x = block(p, f"backbone.layers.{i}.blocks.{j}.", x, s["heads"], m,
                      0 if j % 2 == 0 else m // 2, cfg, quant)
        n = f"backbone.norm{i}."
        outs.append(layer_norm(x, p[n + "weight"], p[n + "bias"], eps).permute(0, 3, 1, 2))
        if i < len(st) - 1:
            x = patch_merging(p, f"backbone.layers.{i}.downsample.", x, eps, quant)
    return outs


# ---------------------------------------------------------------------------
# levels, anchors, selection
# ---------------------------------------------------------------------------


def _grid_cfg(cfg: dict) -> dict:
    """``cfg`` with ``reference.mvit``'s patch-embedding keys for Swin's P x P
    conv at stride P, unpadded: its level rule then gives Swin's grids on a
    canvas that is a multiple of P (each patch merging ceils, as MViT's
    pools do)."""
    p = cfg["patch_size"]
    return dict(cfg, patch_kernel=p, patch_stride=p, patch_padding=0)


def level_shapes(cfg: dict, hw: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Each level's (h, w) on a canvas of ``hw``: the stages' grids, P6."""
    return mvit.level_shapes(_grid_cfg(cfg), hw)


def anchors(cfg: dict, hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``reference.mvit.anchors`` on Swin's levels."""
    return mvit.anchors(_grid_cfg(cfg), hw)


def select(boxes: torch.Tensor, logits: torch.Tensor, hw: Tuple[int, int],
           cv: Tuple[int, int], cfg: dict) -> Dict[str, object]:
    """``reference.mvit.select`` on Swin's levels."""
    return mvit.select(boxes, logits, hw, cv, _grid_cfg(cfg))


@torch.no_grad()
def candidates(p: Params, frames_u8: torch.Tensor, cfg: dict, quant=None):
    """Every anchor's decoded box (B, N, 4) and logit (B, N), unclipped, the
    resized image's (h, w) and the canvas's (H, W). Sets ``strict_f32``."""
    strict_f32()
    x, hw, cv = preprocess(frames_u8, cfg)
    deltas, logits = rpn_head(p, fpn(p, swin(p, x, cfg, quant), quant), cfg, quant)
    anc, _ = anchors(cfg, cv)
    return apply_deltas(deltas, anc.to(deltas.device)[None], cfg), logits, hw, cv
