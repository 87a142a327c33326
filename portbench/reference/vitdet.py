"""ViTDet-B's RPN (Li, Mao, Girshick, He 2022, "Exploring Plain Vision
Transformer Backbones for Object Detection", arXiv:2203.16527) in plain
float32 PyTorch: the reference the port is held to. It follows detectron2's
``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py`` (the ViT, the
simple feature pyramid, the RPN of ``configs/common/models/
mask_rcnn_fpn.py``) and its test path equation by equation, and imports
only ``torch`` and ``numpy``: nothing of the port, of ``tpurpn`` or of JAX.
No kernels, no cache, no batching tricks; matmuls and convolutions in true
f32 (``strict_f32``).

``cfg`` is a dict: ``img_size`` (the square canvas), ``embed_dim``,
``depth``, ``num_heads``, ``mlp_ratio``, ``patch_size``, ``window_size``,
``global_blocks``, ``pretrain_img_size``, ``pyramid_channels``,
``head_convs``, ``anchor_sizes``, ``anchor_ratios``, ``strides``,
``pre_nms_topk`` (a level), ``post_nms_topk``, ``nms_thresh``,
``box_weights``, ``scale_clamp``, ``pixel_mean``, ``pixel_std``; ``init``
(the stds of ``draw_params``).

Parameters are a dict of f32 tensors under the names ``param_shapes``
gives: Linear weights (out, in), conv weights (out, in, kh, kw), transposed
conv weights (in, out, kh, kw).

Departures from detectron2, each deliberate:

* boxes are [y1, x1, y2, x2] normalised by the canvas side (detectron2: x0,
  y0, x1, y1 in pixels). At a canvas of 1024 the division is by a power of
  two and exact, so every decoded box, clip and IoU is detectron2's scaled;
* every sort is stable, ties to the lower index: each level's top-k (a
  ``torch.topk`` with no tie order in detectron2) and the merged order of
  the candidates that NMS walks (``batched_nms``: by score, no tie order);
* NMS is the greedy walk over that merged order, a box suppressing only
  boxes of its own level (what ``batched_nms`` computes, without shifting
  each level's boxes apart by an offset, which would round them), with the
  IoU's denominator held at 1e-8 at least (only a pair of sub-pixel boxes
  could reach it);
* the frames are resized bilinearly with half-pixel centres in f32 and not
  rounded back to uint8 (detectron2 resizes a uint8 image with PIL);
* ``roi_scores`` are the kept logits' sigmoids (detectron2 keeps logits).

``quant="fp8"`` rounds both operands of every product (linear, conv,
attention) to float8 e4m3 with one scale a tensor: the control, a precision
below the bf16 that the configuration states.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def strict_f32() -> None:
    """Matmuls and convolutions in true f32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the order ``draw_params`` draws them."""
    c, p, hd = cfg["embed_dim"], cfg["patch_size"], cfg["embed_dim"] // cfg["num_heads"]
    grid = cfg["img_size"] // p
    hidden = int(c * cfg["mlp_ratio"])
    out = {"backbone.patch_embed.weight": (c, 3, p, p), "backbone.patch_embed.bias": (c,),
           "backbone.pos_embed": (1, 1 + (cfg["pretrain_img_size"] // p) ** 2, c)}
    for i in range(cfg["depth"]):
        side = grid if i in cfg["global_blocks"] else cfg["window_size"]
        b = f"backbone.blocks.{i}."
        out.update({b + "norm1.weight": (c,), b + "norm1.bias": (c,),
                    b + "attn.qkv.weight": (3 * c, c), b + "attn.qkv.bias": (3 * c,),
                    b + "attn.proj.weight": (c, c), b + "attn.proj.bias": (c,),
                    b + "attn.rel_pos_h": (2 * side - 1, hd),
                    b + "attn.rel_pos_w": (2 * side - 1, hd),
                    b + "norm2.weight": (c,), b + "norm2.bias": (c,),
                    b + "mlp.fc1.weight": (hidden, c), b + "mlp.fc1.bias": (hidden,),
                    b + "mlp.fc2.weight": (c, hidden), b + "mlp.fc2.bias": (c,)})
    o = cfg["pyramid_channels"]
    out.update({"pyramid.p2_up1.weight": (c, c // 2, 2, 2), "pyramid.p2_up1.bias": (c // 2,),
                "pyramid.p2_norm.weight": (c // 2,), "pyramid.p2_norm.bias": (c // 2,),
                "pyramid.p2_up2.weight": (c // 2, c // 4, 2, 2), "pyramid.p2_up2.bias": (c // 4,),
                "pyramid.p3_up1.weight": (c, c // 2, 2, 2), "pyramid.p3_up1.bias": (c // 2,)})
    for name, ci in (("p2", c // 4), ("p3", c // 2), ("p4", c), ("p5", c)):
        out.update({f"pyramid.{name}_lateral.conv.weight": (o, ci, 1, 1),
                    f"pyramid.{name}_lateral.norm.weight": (o,),
                    f"pyramid.{name}_lateral.norm.bias": (o,),
                    f"pyramid.{name}_output.conv.weight": (o, o, 3, 3),
                    f"pyramid.{name}_output.norm.weight": (o,),
                    f"pyramid.{name}_output.norm.bias": (o,)})
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
    if "rel_pos" in name:
        return "rel_pos"
    if name == "backbone.pos_embed":
        return "pos_embed"
    if name.startswith("backbone."):
        return "vit_bias" if name.endswith("bias") else "vit_weight"
    if name.startswith("pyramid."):
        return "pyramid_bias" if name.endswith("bias") else "pyramid_weight"
    if name.startswith("head_convs."):
        return "head_conv_bias" if name.endswith("bias") else "head_conv_weight"
    return name.replace(".", "_")  # objectness_weight, deltas_bias, ...


def draw_params(cfg: dict, seed: int, device="cpu") -> Params:
    """Every parameter from normal draws of one generator seeded with
    ``seed``, in ``param_shapes``' order: LayerNorm weights about 1, all else
    about 0, each group at its std in ``cfg["init"]``; a ``*_weight`` std
    named ``"fan_in"`` is 1 / sqrt(fan_in) (inputs times the kernel's area)."""
    g = torch.Generator().manual_seed(int(seed))
    init, out = cfg["init"], {}
    for name, shape in param_shapes(cfg).items():
        group = _init_group(name)
        std = init[group]
        if std == "fan_in":
            fan_in = shape[0] if "_up" in name else shape[1]  # transposed: (in, out, kh, kw)
            std = 1.0 / math.sqrt(fan_in * (math.prod(shape[2:]) if len(shape) > 2 else 1))
        t = torch.randn(shape, generator=g) * float(std)
        out[name] = (t + 1.0 if group == "norm_weight" else t).to(device)
    return out


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def _round8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


def _q(t: torch.Tensor, quant) -> torch.Tensor:
    return _round8(t) if quant == "fp8" else t


def linear(x, w, b, quant=None):
    return F.linear(_q(x, quant), _q(w, quant), b)


def layer_norm(x, w, b, eps):
    """LayerNorm over the last dim."""
    u = x.mean(-1, keepdim=True)
    s = ((x - u) ** 2).mean(-1, keepdim=True)
    return (x - u) / torch.sqrt(s + eps) * w + b


def channel_norm(x, w, b, eps):
    """detectron2's LayerNorm over the channels of an NCHW map."""
    u = x.mean(1, keepdim=True)
    s = ((x - u) ** 2).mean(1, keepdim=True)
    return (x - u) / torch.sqrt(s + eps) * w[:, None, None] + b[:, None, None]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """detectron2's ``get_rel_pos``: (q_size, k_size, d) rows of ``rel_pos``
    by relative coordinate (the table has 2 * max(q, k) - 1 rows here)."""
    assert rel_pos.shape[0] == 2 * max(q_size, k_size) - 1
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long().to(rel_pos.device)]


def attention(p: Params, pre: str, x: torch.Tensor, heads: int, quant=None) -> torch.Tensor:
    """detectron2's ``Attention`` with ``use_rel_pos``: x (B, H, W, C)."""
    B, H, W, C = x.shape
    d = C // heads
    qkv = linear(x, p[pre + "qkv.weight"], p[pre + "qkv.bias"], quant)
    qkv = qkv.reshape(B, H * W, 3, heads, d).permute(2, 0, 3, 1, 4).reshape(3, B * heads, H * W, d)
    q, k, v = qkv.unbind(0)
    attn = (_q(q * d ** -0.5, quant)) @ _q(k, quant).transpose(-2, -1)
    # add_decomposed_rel_pos, over the unscaled q
    Rh = get_rel_pos(H, H, p[pre + "rel_pos_h"])
    Rw = get_rel_pos(W, W, p[pre + "rel_pos_w"])
    r_q = q.reshape(B * heads, H, W, d)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B * heads, H, W, H, W) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(B * heads, H * W, H * W)
    attn = attn.softmax(dim=-1)
    out = (_q(attn, quant) @ _q(v, quant)).view(B, heads, H, W, d)
    out = out.permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
    return linear(out, p[pre + "proj.weight"], p[pre + "proj.bias"], quant)


def window_partition(x: torch.Tensor, ws: int):
    """detectron2's ``window_partition``: zero-pad to a multiple of ``ws``."""
    B, H, W, C = x.shape
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(windows, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.view(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    return x[:, :H, :W, :].contiguous()


def vit(p: Params, x: torch.Tensor, cfg: dict, quant=None) -> torch.Tensor:
    """NCHW canvas (B, 3, S, S) -> the ViT's (B, S/P, S/P, C) map."""
    P, eps = cfg["patch_size"], 1e-6
    x = F.conv2d(_q(x, quant), _q(p["backbone.patch_embed.weight"], quant),
                 p["backbone.patch_embed.bias"], stride=P).permute(0, 2, 3, 1)
    # get_abs_pos: drop the cls row, bicubic to the token grid
    pe = p["backbone.pos_embed"][:, 1:]
    n = int(math.sqrt(pe.shape[1]))
    pe = F.interpolate(pe.reshape(1, n, n, -1).permute(0, 3, 1, 2), size=x.shape[1:3],
                       mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
    x = x + pe
    for i in range(cfg["depth"]):
        b = f"backbone.blocks.{i}."
        shortcut = x
        x = layer_norm(x, p[b + "norm1.weight"], p[b + "norm1.bias"], eps)
        if i not in cfg["global_blocks"]:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, cfg["window_size"])
            x = attention(p, b + "attn.", x, cfg["num_heads"], quant)
            x = window_unpartition(x, cfg["window_size"], pad_hw, (H, W))
        else:
            x = attention(p, b + "attn.", x, cfg["num_heads"], quant)
        x = shortcut + x
        y = layer_norm(x, p[b + "norm2.weight"], p[b + "norm2.bias"], eps)
        y = linear(F.gelu(linear(y, p[b + "mlp.fc1.weight"], p[b + "mlp.fc1.bias"], quant)),
                   p[b + "mlp.fc2.weight"], p[b + "mlp.fc2.bias"], quant)
        x = x + y
    return x


def _conv(x, w, b=None, quant=None, **kw):
    return F.conv2d(_q(x, quant), _q(w, quant), b, **kw)


def _up(x, w, b, quant=None):
    return F.conv_transpose2d(_q(x, quant), _q(w, quant), b, stride=2)


def pyramid(p: Params, feat: torch.Tensor, quant=None) -> List[torch.Tensor]:
    """detectron2's ``SimpleFeaturePyramid`` (scales 4, 2, 1, 0.5, norm "LN")
    with ``LastLevelMaxPool``: [P2, P3, P4, P5, P6], NCHW."""
    eps, q = 1e-6, "pyramid."
    x = feat.permute(0, 3, 1, 2)
    p2 = _up(x, p[q + "p2_up1.weight"], p[q + "p2_up1.bias"], quant)
    p2 = F.gelu(channel_norm(p2, p[q + "p2_norm.weight"], p[q + "p2_norm.bias"], eps))
    maps = {"p2": _up(p2, p[q + "p2_up2.weight"], p[q + "p2_up2.bias"], quant),
            "p3": _up(x, p[q + "p3_up1.weight"], p[q + "p3_up1.bias"], quant),
            "p4": x, "p5": F.max_pool2d(x, kernel_size=2, stride=2)}
    out = []
    for name, m in maps.items():
        for part, pad in (("lateral", 0), ("output", 1)):
            pre = f"{q}{name}_{part}."
            m = channel_norm(_conv(m, p[pre + "conv.weight"], None, quant, padding=pad),
                             p[pre + "norm.weight"], p[pre + "norm.bias"], eps)
        out.append(m)
    return out + [F.max_pool2d(out[-1], kernel_size=1, stride=2, padding=0)]


def rpn_head(p: Params, levels: List[torch.Tensor], cfg: dict, quant=None):
    """``StandardRPNHead`` on every level: (deltas (B, N, 4) in (dx, dy, dw,
    dh), logits (B, N)), levels concatenated, each (y, x, anchor) row-major."""
    deltas, logits = [], []
    for x in levels:
        for i in range(cfg["head_convs"]):
            x = F.relu(_conv(x, p[f"head_convs.{i}.weight"], p[f"head_convs.{i}.bias"], quant,
                             padding=1))
        lg = _conv(x, p["objectness.weight"], p["objectness.bias"], quant)
        dl = _conv(x, p["deltas.weight"], p["deltas.bias"], quant)
        N, _, Hi, Wi = lg.shape
        logits.append(lg.permute(0, 2, 3, 1).flatten(1))
        deltas.append(dl.view(N, -1, 4, Hi, Wi).permute(0, 3, 4, 1, 2).flatten(1, -2))
    return torch.cat(deltas, 1), torch.cat(logits, 1)


# ---------------------------------------------------------------------------
# anchors, boxes, input
# ---------------------------------------------------------------------------


def level_shapes(cfg: dict) -> List[int]:
    g = cfg["img_size"] // cfg["patch_size"]
    p5 = g // 2
    return [4 * g, 2 * g, g, p5, math.ceil(p5 / 2)]


def anchors(cfg: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """``DefaultAnchorGenerator`` (offset 0): (N, 4) f32 [y1, x1, y2, x2] over
    the canvas, and each anchor's level (N,)."""
    out, lev = [], []
    for li, (size, stride, fm) in enumerate(zip(cfg["anchor_sizes"], cfg["strides"],
                                                level_shapes(cfg))):
        cell = []
        for ar in cfg["anchor_ratios"]:
            w = math.sqrt(size * size / ar)
            h = ar * w
            cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
        cell = torch.tensor(cell)
        sx = torch.arange(0, fm * stride, step=stride, dtype=torch.float32)
        sy = torch.arange(0, fm * stride, step=stride, dtype=torch.float32)
        shift_y, shift_x = torch.meshgrid(sy, sx, indexing="ij")
        shift_x, shift_y = shift_x.reshape(-1), shift_y.reshape(-1)
        shifts = torch.stack((shift_x, shift_y, shift_x, shift_y), dim=1)
        a = (shifts.view(-1, 1, 4) + cell.view(1, -1, 4)).reshape(-1, 4)
        out.append(a)
        lev.append(torch.full((a.shape[0],), li, dtype=torch.int64))
    a = torch.cat(out)
    return torch.stack([a[:, 1], a[:, 0], a[:, 3], a[:, 2]], 1) / cfg["img_size"], torch.cat(lev)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``Box2BoxTransform.apply_deltas`` on [y1, x1, y2, x2] boxes."""
    widths = boxes[..., 3] - boxes[..., 1]
    heights = boxes[..., 2] - boxes[..., 0]
    ctr_x = boxes[..., 1] + 0.5 * widths
    ctr_y = boxes[..., 0] + 0.5 * heights
    wx, wy, ww, wh = cfg["box_weights"]
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=cfg["scale_clamp"])
    dh = torch.clamp(deltas[..., 3] / wh, max=cfg["scale_clamp"])
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_y - 0.5 * pred_h, pred_ctr_x - 0.5 * pred_w,
                        pred_ctr_y + 0.5 * pred_h, pred_ctr_x + 0.5 * pred_w], -1)


def resized_shape(h: int, w: int, size: int) -> Tuple[int, int]:
    """``ResizeShortestEdge.get_output_shape(h, w, size, max_size=size)``."""
    scale = size * 1.0 / min(h, w)
    if h < w:
        newh, neww = size * 1.0, scale * w
    else:
        newh, neww = scale * h, size * 1.0
    if max(newh, neww) > size:
        scale = size * 1.0 / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    return int(newh + 0.5), int(neww + 0.5)


def preprocess(frames_u8: torch.Tensor, cfg: dict) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """uint8 NHWC RGB frames -> (the normalised canvas (B, 3, S, S), the
    resized image's (h, w)): resize, (x - mean) / std, zero pad."""
    B, H, W, _ = frames_u8.shape
    S = cfg["img_size"]
    nh, nw = resized_shape(H, W, S)
    x = F.interpolate(frames_u8.permute(0, 3, 1, 2).float(), size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=nh < H or nw < W)
    mean = torch.tensor(cfg["pixel_mean"], device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(cfg["pixel_std"], device=x.device).view(1, 3, 1, 1)
    x = (x - mean) / std
    return F.pad(x, (0, S - nw, 0, S - nh)), (nh, nw)


@torch.no_grad()
def candidates(p: Params, frames_u8: torch.Tensor, cfg: dict, quant=None):
    """Every anchor's decoded box (B, N, 4) and logit (B, N), unclipped, and
    the resized image's (h, w). Sets ``strict_f32``."""
    strict_f32()
    x, hw = preprocess(frames_u8, cfg)
    deltas, logits = rpn_head(p, pyramid(p, vit(p, x, cfg, quant), quant), cfg, quant)
    anc, _ = anchors(cfg)
    return apply_deltas(deltas, anc.to(deltas.device)[None], cfg), logits, hw


def clip(boxes: torch.Tensor, hw: Tuple[int, int], canvas: int) -> torch.Tensor:
    """``Boxes.clip`` to the resized image, in canvas-normalised units."""
    h, w = hw[0] / canvas, hw[1] / canvas
    return torch.stack([boxes[..., 0].clamp(min=0, max=h), boxes[..., 1].clamp(min=0, max=w),
                        boxes[..., 2].clamp(min=0, max=h), boxes[..., 3].clamp(min=0, max=w)], -1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, 4) x (m, 4) -> (n, m) IoU, f32, the operations in NMS's order."""
    ih = (torch.minimum(a[:, None, 2], b[None, :, 2]) - torch.maximum(a[:, None, 0], b[None, :, 0])
          ).clamp(min=0)
    iw = (torch.minimum(a[:, None, 3], b[None, :, 3]) - torch.maximum(a[:, None, 1], b[None, :, 1])
          ).clamp(min=0)
    inter = ih * iw

    def area(t):
        return (t[:, 2] - t[:, 0]).clamp(min=0) * (t[:, 3] - t[:, 1]).clamp(min=0)

    return inter / torch.clamp(area(a)[:, None] + area(b)[None, :] - inter, min=1e-8)


def select(boxes: torch.Tensor, logits: torch.Tensor, hw: Tuple[int, int], cfg: dict
           ) -> Dict[str, object]:
    """``find_top_rpn_proposals`` at test time, per image: each level's top
    ``pre_nms_topk`` logits, clip, drop the boxes without width or height
    (and any not finite), greedy NMS within a level over the merged score
    order, the first ``post_nms_topk`` kept. Returns roi_boxes (B, k, 4),
    roi_scores (B, k) (sigmoids), num_valid (B,), zero past num_valid, and
    per image the walk: ``keep`` flags and ``level`` ids over the merged
    order (NumPy)."""
    B = boxes.shape[0]
    k, thr = cfg["post_nms_topk"], torch.tensor(cfg["nms_thresh"], dtype=torch.float32)
    sizes = [s * s * len(cfg["anchor_ratios"]) for s in level_shapes(cfg)]
    out = {"roi_boxes": np.zeros((B, k, 4), np.float32), "roi_scores": np.zeros((B, k), np.float32),
           "num_valid": np.zeros((B,), np.int32), "keep": [], "level": []}
    for i in range(B):
        idx, lev, start = [], [], 0
        for li, n in enumerate(sizes):
            order = torch.sort(logits[i, start:start + n], descending=True, stable=True).indices
            top = order[:min(cfg["pre_nms_topk"], n)] + start
            idx.append(top)
            lev.append(torch.full((top.numel(),), li, dtype=torch.int64, device=top.device))
            start += n
        idx, lev = torch.cat(idx), torch.cat(lev)
        b = clip(boxes[i, idx], hw, cfg["img_size"])
        s = logits[i, idx]
        valid = (torch.isfinite(b).all(1) & torch.isfinite(s) & (b[:, 3] - b[:, 1] > 0)
                 & (b[:, 2] - b[:, 0] > 0))
        order = torch.sort(torch.where(valid, s, float("-inf")), descending=True,
                           stable=True).indices
        order = order[valid[order]]
        b, s, lev = b[order], s[order], lev[order]
        over = ((iou(b, b) > thr.to(b.device)) & (lev[:, None] == lev[None, :])).cpu().numpy()
        keep = np.zeros(len(order), bool)
        suppressed = np.zeros(len(order), bool)
        n_kept = 0
        for j in range(len(order)):
            if suppressed[j]:
                continue
            keep[j] = True
            n_kept += 1
            if n_kept == k:
                break
            suppressed |= over[j]
        kept = np.nonzero(keep)[0]
        out["roi_boxes"][i, :len(kept)] = b[kept].cpu().numpy()
        out["roi_scores"][i, :len(kept)] = torch.sigmoid(s[kept]).cpu().numpy()
        out["num_valid"][i] = len(kept)
        out["keep"].append(keep)
        out["level"].append(lev.cpu().numpy())
    return out
