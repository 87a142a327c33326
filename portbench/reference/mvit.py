"""MViTv2-B's RPN (Li, Wu, Fan, Mangalam, Xiong, Malik, Feichtenhofer 2022,
"MViTv2: Improved Multiscale Vision Transformers for Classification and
Detection", arXiv:2112.01526) in plain float32 PyTorch: the reference the
port is held to. It follows detectron2's ``projects/MViTv2/configs/
cascade_mask_rcnn_mvitv2_b_3x.py`` (the MViT backbone of ``modeling/
backbone/mvit.py``; the FPN and the RPN of ``configs/common/models/
mask_rcnn_fpn.py``) and its test path equation by equation, and imports
only ``torch``, ``numpy`` and the benchmark's ``reference.vitdet`` helpers:
nothing of the port, of ``tpurpn`` or of JAX. No kernels, no cache;
matmuls and convolutions in true f32 (``strict_f32``); each attention core
in chunks of images and heads, so that a global block at batch 8 fits.

``cfg`` is a dict: ``embed_dim``, ``depth``, ``num_heads``,
``last_block_indexes``, ``mlp_ratio``, ``patch_kernel``, ``patch_stride``,
``patch_padding``, ``pool_kernel``, ``adaptive_kv_stride``,
``adaptive_window_size``, ``residual_pooling``, ``pretrain_img_size``,
``ln_eps``, ``fpn_channels``, ``head_convs``, ``min_size_test``,
``max_size_test``, ``size_divisibility``, ``anchor_sizes``,
``anchor_ratios``, ``strides``, ``pre_nms_topk`` (a level),
``post_nms_topk``, ``nms_thresh``, ``box_weights``, ``scale_clamp``,
``pixel_mean``, ``pixel_std``; ``init`` (the stds of ``draw_params``).

Departures from detectron2, each deliberate, as in ``reference.vitdet``:

* boxes are [y1, x1, y2, x2], y divided by the canvas's height and x by its
  width (detectron2: x0, y0, x1, y1 in pixels). Decoding, clipping and IoU
  commute with a scale of each axis, so the boxes are detectron2's scaled,
  up to the rounding of the division;
* every sort is stable, ties to the lower index, and NMS is the greedy walk
  within a level over the merged score order (``batched_nms`` without its
  offsets), as in ``reference.vitdet``;
* the frames are resized bilinearly with half-pixel centres in f32 and not
  rounded back to uint8;
* ``roi_scores`` are the kept logits' sigmoids.

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

from .vitdet import _q, apply_deltas, iou, layer_norm, linear, rpn_head, strict_f32
from .vitdet import window_partition, window_unpartition

Params = Dict[str, torch.Tensor]
CHUNK_SCORES = 1 << 27  # scores of one attention chunk (512 MB in f32)


# ---------------------------------------------------------------------------
# the blocks and their parameters
# ---------------------------------------------------------------------------


def blocks(cfg: dict) -> List[dict]:
    """Each block's settings, by ``MViT.__init__``'s loop: ``dim``,
    ``dim_out``, ``heads``, ``stride_q``, ``stride_kv``, ``window`` (0:
    global) and ``rel_dim`` (its tables' rows)."""
    last = list(cfg["last_block_indexes"])
    embed = dim_out = cfg["embed_dim"]
    heads = cfg["num_heads"]
    stride_kv, window = cfg["adaptive_kv_stride"], cfg["adaptive_window_size"]
    size = cfg["pretrain_img_size"] // cfg["patch_stride"]
    out = []
    for i in range(cfg["depth"]):
        skv = stride_kv * 2 if i == last[1] or i == last[2] else stride_kv
        sq = 2 if i - 1 in last else 1
        out.append({"dim": embed, "dim_out": dim_out, "heads": heads, "stride_q": sq,
                    "stride_kv": skv, "window": 0 if i in last[1:] else window,
                    "rel_dim": 2 * max(size // sq, size // skv) - 1})
        embed = dim_out
        if i in last:
            dim_out *= 2
            heads *= 2
            stride_kv = max(stride_kv // 2, 1)
        if i - 1 in last:
            window //= 2
            size //= 2
    return out


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the order ``draw_params`` draws them."""
    c0, k = cfg["embed_dim"], cfg["pool_kernel"]
    out = {"backbone.patch_embed.weight": (c0, 3, cfg["patch_kernel"], cfg["patch_kernel"]),
           "backbone.patch_embed.bias": (c0,)}
    bl = blocks(cfg)
    for i, s in enumerate(bl):
        b, ci, co = f"backbone.blocks.{i}.", s["dim"], s["dim_out"]
        d = co // s["heads"]
        out.update({b + "norm1.weight": (ci,), b + "norm1.bias": (ci,),
                    b + "attn.qkv.weight": (3 * co, ci), b + "attn.qkv.bias": (3 * co,),
                    b + "attn.proj.weight": (co, co), b + "attn.proj.bias": (co,)})
        for n in ("q", "k", "v"):
            out.update({f"{b}attn.pool_{n}.weight": (d, 1, k, k),
                        f"{b}attn.norm_{n}.weight": (d,), f"{b}attn.norm_{n}.bias": (d,)})
        out.update({b + "attn.rel_pos_h": (s["rel_dim"], d), b + "attn.rel_pos_w": (s["rel_dim"], d),
                    b + "norm2.weight": (co,), b + "norm2.bias": (co,),
                    b + "mlp.fc1.weight": (int(co * cfg["mlp_ratio"]), co),
                    b + "mlp.fc1.bias": (int(co * cfg["mlp_ratio"]),),
                    b + "mlp.fc2.weight": (co, int(co * cfg["mlp_ratio"])),
                    b + "mlp.fc2.bias": (co,)})
        if ci != co:
            out.update({b + "proj.weight": (co, ci), b + "proj.bias": (co,)})
    for stage, i in enumerate(cfg["last_block_indexes"], 2):
        c = bl[i]["dim_out"]
        out.update({f"backbone.scale{stage}_norm.weight": (c,),
                    f"backbone.scale{stage}_norm.bias": (c,)})
    o = cfg["fpn_channels"]
    for stage, i in enumerate(cfg["last_block_indexes"], 2):
        c = bl[i]["dim_out"]
        out.update({f"pyramid.fpn_lateral{stage}.weight": (o, c, 1, 1),
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
    if "rel_pos" in name:
        return "rel_pos"
    if ".pool_" in name:
        return "pool_weight"
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
    named ``"fan_in"`` is 1 / sqrt(fan_in) (inputs a group times the
    kernel's area)."""
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


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """detectron2's ``get_rel_pos``: the table linearly interpolated to
    2 max(q, k) - 1 rows where it has others, then (q_size, k_size, d) rows
    by the relative coordinate scaled to the shorter side."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        resized = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                                size=max_rel_dist, mode="linear")
        resized = resized.reshape(-1, max_rel_dist).permute(1, 0)
    else:
        resized = rel_pos
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return resized[relative.long().to(resized.device)]


def _conv(x, w, b=None, quant=None, **kw):
    return F.conv2d(_q(x, quant), _q(w, quant), b, **kw)


def attention_pool(x: torch.Tensor, w: torch.Tensor, stride: int, nw, nb, eps: float,
                   quant=None) -> torch.Tensor:
    """(B nH, H, W, d) -> the depthwise conv at ``stride`` (padding k // 2,
    no bias), then the LayerNorm over d."""
    x = _conv(x.permute(0, 3, 1, 2), w, None, quant, stride=stride, padding=w.shape[-1] // 2,
              groups=w.shape[0])
    return layer_norm(x.permute(0, 2, 3, 1).contiguous(), nw, nb, eps)


def core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor,
         q_hw, kv_hw, quant=None) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d) + rel_h + rel_w) v`` (detectron2's
    ``add_decomposed_rel_pos``, over the unscaled q) of (N, Tq, d) q and
    (N, Tk, d) k and v, in chunks of N of at most ``CHUNK_SCORES`` scores."""
    n, tq, d = q.shape
    tk = k.shape[1]
    out = torch.empty_like(q)
    step = max(1, CHUNK_SCORES // (tq * tk))
    for a in range(0, n, step):
        qa, ka, va = q[a:a + step], k[a:a + step], v[a:a + step]
        m = qa.shape[0]
        attn = _q(qa * d ** -0.5, quant) @ _q(ka, quant).transpose(-2, -1)
        r_q = qa.reshape(m, q_hw[0], q_hw[1], d)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = (attn.view(m, q_hw[0], q_hw[1], kv_hw[0], kv_hw[1]) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(m, tq, tk)
        out[a:a + step] = _q(attn.softmax(dim=-1), quant) @ _q(va, quant)
    return out


def attention(p: Params, pre: str, x: torch.Tensor, s: dict, cfg: dict, quant=None,
              residual_pooling=None) -> torch.Tensor:
    """detectron2's ``MultiScaleAttention``: x (B, H, W, C_in) ->
    (B, H', W', C_out)."""
    B, H, W, _ = x.shape
    heads, eps = s["heads"], cfg["ln_eps"]
    if residual_pooling is None:
        residual_pooling = cfg["residual_pooling"]
    qkv = linear(x, p[pre + "qkv.weight"], p[pre + "qkv.bias"], quant)
    qkv = qkv.reshape(B, H, W, 3, heads, -1).permute(3, 0, 4, 1, 2, 5)
    q, k, v = qkv.reshape(3, B * heads, H, W, -1).unbind(0)
    q = attention_pool(q, p[pre + "pool_q.weight"], s["stride_q"], p[pre + "norm_q.weight"],
                       p[pre + "norm_q.bias"], eps, quant)
    k = attention_pool(k, p[pre + "pool_k.weight"], s["stride_kv"], p[pre + "norm_k.weight"],
                       p[pre + "norm_k.bias"], eps, quant)
    v = attention_pool(v, p[pre + "pool_v.weight"], s["stride_kv"], p[pre + "norm_v.weight"],
                       p[pre + "norm_v.bias"], eps, quant)
    ori_q = q
    if s["window"]:
        q_win, kv_win = s["window"] // s["stride_q"], s["window"] // s["stride_kv"]
        q, q_hw_pad = window_partition(q, q_win)
        k, _ = window_partition(k, kv_win)
        v, _ = window_partition(v, kv_win)
        q_hw, kv_hw = (q_win, q_win), (kv_win, kv_win)
    else:
        q_hw, kv_hw = tuple(q.shape[1:3]), tuple(k.shape[1:3])
    rh = get_rel_pos(q_hw[0], kv_hw[0], p[pre + "rel_pos_h"])
    rw = get_rel_pos(q_hw[1], kv_hw[1], p[pre + "rel_pos_w"])
    d = q.shape[-1]
    out = core(q.reshape(q.shape[0], -1, d), k.reshape(k.shape[0], -1, d),
               v.reshape(v.shape[0], -1, d), rh, rw, q_hw, kv_hw, quant)
    out = out.view(out.shape[0], q_hw[0], q_hw[1], d)
    if s["window"]:
        out = window_unpartition(out, q_hw[0], q_hw_pad, ori_q.shape[1:3])
    if residual_pooling:
        out = out + ori_q
    Hq, Wq = out.shape[1], out.shape[2]
    out = out.view(B, heads, Hq, Wq, d).permute(0, 2, 3, 1, 4).reshape(B, Hq, Wq, -1)
    return linear(out, p[pre + "proj.weight"], p[pre + "proj.bias"], quant)


def mvit(p: Params, x: torch.Tensor, cfg: dict, quant=None, residual_pooling=None
         ) -> List[torch.Tensor]:
    """NCHW canvas (B, 3, H, W) -> the stages' normalised maps [scale2 ...
    scale5], NCHW (``MViT.forward``)."""
    eps = cfg["ln_eps"]
    x = _conv(x, p["backbone.patch_embed.weight"], p["backbone.patch_embed.bias"], quant,
              stride=cfg["patch_stride"], padding=cfg["patch_padding"]).permute(0, 2, 3, 1)
    outs = []
    for i, s in enumerate(blocks(cfg)):
        b = f"backbone.blocks.{i}."
        x_norm = layer_norm(x, p[b + "norm1.weight"], p[b + "norm1.bias"], eps)
        x_block = attention(p, b + "attn.", x_norm, s, cfg, quant, residual_pooling)
        if s["dim"] != s["dim_out"]:
            x = linear(x_norm, p[b + "proj.weight"], p[b + "proj.bias"], quant)
        if s["stride_q"] > 1:
            k = s["stride_q"] + 1
            x = F.max_pool2d(x.permute(0, 3, 1, 2), k, s["stride_q"], k // 2).permute(0, 2, 3, 1)
        x = x + x_block
        y = layer_norm(x, p[b + "norm2.weight"], p[b + "norm2.bias"], eps)
        y = linear(F.gelu(linear(y, p[b + "mlp.fc1.weight"], p[b + "mlp.fc1.bias"], quant)),
                   p[b + "mlp.fc2.weight"], p[b + "mlp.fc2.bias"], quant)
        x = x + y
        if i in cfg["last_block_indexes"]:
            n = f"backbone.scale{len(outs) + 2}_norm."
            outs.append(layer_norm(x, p[n + "weight"], p[n + "bias"], eps).permute(0, 3, 1, 2))
    return outs


def fpn(p: Params, feats: List[torch.Tensor], quant=None) -> List[torch.Tensor]:
    """detectron2's ``FPN`` (no norm, sum) with ``LastLevelMaxPool``:
    [P2, P3, P4, P5, P6], NCHW."""
    stages = list(range(2, 2 + len(feats)))

    def conv(x, name, pad):
        return _conv(x, p[f"pyramid.{name}.weight"], p[f"pyramid.{name}.bias"], quant,
                     padding=pad)

    prev = conv(feats[-1], f"fpn_lateral{stages[-1]}", 0)
    results = [conv(prev, f"fpn_output{stages[-1]}", 1)]
    for stage, f in zip(stages[-2::-1], feats[-2::-1]):
        top_down = F.interpolate(prev, scale_factor=2.0, mode="nearest")
        prev = conv(f, f"fpn_lateral{stage}", 0) + top_down
        results.insert(0, conv(prev, f"fpn_output{stage}", 1))
    return results + [F.max_pool2d(results[-1], kernel_size=1, stride=2, padding=0)]


# ---------------------------------------------------------------------------
# input, anchors, selection
# ---------------------------------------------------------------------------


def canvas(h: int, w: int, cfg: dict) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(``ResizeShortestEdge(min_size_test, max_size_test)``'s output shape,
    the canvas ``ImageList.from_tensors`` pads it to: each side up to a
    multiple of ``size_divisibility``)."""
    size, max_size = cfg["min_size_test"] * 1.0, cfg["max_size_test"]
    scale = size / min(h, w)
    newh, neww = (size, scale * w) if h < w else (scale * h, size)
    if max(newh, neww) > max_size:
        scale = max_size * 1.0 / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    nh, nw = int(newh + 0.5), int(neww + 0.5)
    div = cfg["size_divisibility"]
    return (nh, nw), (int(math.ceil(nh / div) * div), int(math.ceil(nw / div) * div))


def level_shapes(cfg: dict, hw: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Each level's (h, w) on a canvas of ``hw``: the patch embedding's map,
    each stage's stride-2 pooling (3 x 3, padding 1), P6 at stride 2."""
    k, s, pad = cfg["patch_kernel"], cfg["patch_stride"], cfg["patch_padding"]
    out = [tuple((x + 2 * pad - k) // s + 1 for x in hw)]
    for _ in range(4):
        out.append(tuple((x - 1) // 2 + 1 for x in out[-1]))
    return out


def anchors(cfg: dict, hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``DefaultAnchorGenerator`` (offset 0) on a canvas of ``hw``: (N, 4)
    f32 [y1, x1, y2, x2], y over the canvas's height, x over its width, and
    each anchor's level (N,)."""
    out, lev = [], []
    for li, (size, stride, (fh, fw)) in enumerate(zip(cfg["anchor_sizes"], cfg["strides"],
                                                      level_shapes(cfg, hw))):
        cell = []
        for ar in cfg["anchor_ratios"]:
            w = math.sqrt(size * size / ar)
            h = ar * w
            cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
        cell = torch.tensor(cell)
        sx = torch.arange(0, fw * stride, step=stride, dtype=torch.float32)
        sy = torch.arange(0, fh * stride, step=stride, dtype=torch.float32)
        shift_y, shift_x = torch.meshgrid(sy, sx, indexing="ij")
        shift_x, shift_y = shift_x.reshape(-1), shift_y.reshape(-1)
        shifts = torch.stack((shift_x, shift_y, shift_x, shift_y), dim=1)
        a = (shifts.view(-1, 1, 4) + cell.view(1, -1, 4)).reshape(-1, 4)
        out.append(a)
        lev.append(torch.full((a.shape[0],), li, dtype=torch.int64))
    a = torch.cat(out)
    scale = torch.tensor([hw[0], hw[1], hw[0], hw[1]], dtype=torch.float32)
    return torch.stack([a[:, 1], a[:, 0], a[:, 3], a[:, 2]], 1) / scale, torch.cat(lev)


def preprocess(frames_u8: torch.Tensor, cfg: dict):
    """uint8 NHWC RGB frames -> (the normalised canvas (B, 3, H, W), the
    resized image's (h, w), the canvas's (H, W)): resize, (x - mean) / std,
    zero pad below and right."""
    B, H, W, _ = frames_u8.shape
    (nh, nw), (ch, cw) = canvas(H, W, cfg)
    x = F.interpolate(frames_u8.permute(0, 3, 1, 2).float(), size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=nh < H or nw < W)
    mean = torch.tensor(cfg["pixel_mean"], device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(cfg["pixel_std"], device=x.device).view(1, 3, 1, 1)
    x = (x - mean) / std
    return F.pad(x, (0, cw - nw, 0, ch - nh)), (nh, nw), (ch, cw)


@torch.no_grad()
def candidates(p: Params, frames_u8: torch.Tensor, cfg: dict, quant=None,
               residual_pooling=None):
    """Every anchor's decoded box (B, N, 4) and logit (B, N), unclipped, the
    resized image's (h, w) and the canvas's (H, W). Sets ``strict_f32``.
    ``residual_pooling`` False computes the model without it (a planted
    fault of the benchmark's readings)."""
    strict_f32()
    x, hw, cv = preprocess(frames_u8, cfg)
    feats = mvit(p, x, cfg, quant, residual_pooling)
    deltas, logits = rpn_head(p, fpn(p, feats, quant), cfg, quant)
    anc, _ = anchors(cfg, cv)
    return apply_deltas(deltas, anc.to(deltas.device)[None], cfg), logits, hw, cv


def clip(boxes: torch.Tensor, hw: Tuple[int, int], cv: Tuple[int, int]) -> torch.Tensor:
    """``Boxes.clip`` to the resized image, in canvas-normalised units."""
    h, w = hw[0] / cv[0], hw[1] / cv[1]
    return torch.stack([boxes[..., 0].clamp(min=0, max=h), boxes[..., 1].clamp(min=0, max=w),
                        boxes[..., 2].clamp(min=0, max=h), boxes[..., 3].clamp(min=0, max=w)], -1)


def select(boxes: torch.Tensor, logits: torch.Tensor, hw: Tuple[int, int],
           cv: Tuple[int, int], cfg: dict) -> Dict[str, object]:
    """``find_top_rpn_proposals`` at test time, per image, as
    ``reference.vitdet.select`` on the canvas ``cv``: each level's top
    ``pre_nms_topk`` logits, clip, drop boxes without width or height (and
    any not finite), greedy NMS within a level over the merged score order,
    the first ``post_nms_topk`` kept. Returns roi_boxes (B, k, 4),
    roi_scores (B, k) (sigmoids), num_valid (B,), zero past num_valid, and
    per image the walk: ``keep`` flags and ``level`` ids over the merged
    order (NumPy)."""
    B = boxes.shape[0]
    k, thr = cfg["post_nms_topk"], torch.tensor(cfg["nms_thresh"], dtype=torch.float32)
    sizes = [fh * fw * len(cfg["anchor_ratios"]) for fh, fw in level_shapes(cfg, cv)]
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
        b = clip(boxes[i, idx], hw, cv)
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
