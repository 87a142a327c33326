"""MViTv2's backbone: a multiscale ViT with pooling attention, hybrid window
and global blocks and decomposed relative positions, and the top-down
feature pyramid on its four stages (Li, Wu, Fan, Mangalam, Xiong, Malik,
Feichtenhofer 2022, arXiv:2112.01526; detectron2's ``modeling/backbone/
mvit.py`` and ``fpn.py``). No TPU counterpart: the JAX package serves
single-level CNNs only.

Equations (tokens NHWC on an H x W grid; a block maps C_in to C_out
channels in h heads of d = C_out / h; its settings are
``config.MViTConfig.blocks()``):

* patch embedding: a 7 x 7 conv at stride 4, padding 3, 3 -> 96 channels,
  with bias; no absolute positions;
* a block: ``xn = norm1(x)``; the skip is ``proj(xn)`` where C_in !=
  C_out, else ``x``, then a 3 x 3 max-pool at stride 2, padding 1 where
  the queries are pooled; ``x = skip + attn(xn)``, ``x = x + fc2(gelu(
  fc1(norm2(x))))``. LayerNorm eps 1e-6, exact GELU;
* pooling attention: ``qkv`` maps C_in to 3 C_out. Each of q, k and v of
  every head goes through a depthwise 3 x 3 conv (padding 1, no bias; one
  filter set of d, shared by the heads) at stride s_q (q) or s_kv (k, v),
  then a LayerNorm over d: the q conv runs at stride 1 too. A window block
  zero-pads the pooled q, k and v to its windows (w_q and w_kv a side,
  as many windows of either); pad keys take part unmasked (k = v = 0) and
  pad queries are cropped. Then ``softmax(q k^T / sqrt(d) + rel_h +
  rel_w) v`` over the windows or the whole grids, ``+ q`` (residual
  pooling: the pooled, normalised q), the heads concatenated, ``proj``;
* relative positions over query and key grids of other sizes: for a query
  side a and a key side b, ``rel_h[q, k] = q . R_h[idx(i, k)]`` over the
  unscaled q with ``idx(i, k) = i max(b/a, 1) - k max(a/b, 1) + (b - 1)
  max(a/b, 1)`` (computed in f32, truncated), the table linearly
  interpolated (half-pixel, detectron2's ``get_rel_pos``) where its rows
  differ from 2 max(a, b) - 1, each axis on its own;
* each stage's output through a LayerNorm of its own;
* the feature pyramid (detectron2's ``FPN``, no norm, biased convs, fused
  by sum): a 1 x 1 lateral conv to 256 channels on each stage, from the
  top down the coarser sum upsampled x2 (nearest) and added to the
  lateral, each sum through a 3 x 3 output conv; P6 =
  ``max_pool2d(P5, 1, 2)``.

Layout and compute follow ``vit.py``: NHWC tokens, NCHW views with
channels-last strides for the convs, bf16 compute from f32 parameters read
through their compute copies. The pooling of q, k and v (convs and norms)
is ``kernels.mvit_pool``: on the card one hand-written kernel a block that
reads q, k and v in place from the qkv product; on the CPU one depthwise
conv of C_out channels a tensor on the product's strided slice, its d
filters repeated h times, then the LayerNorm.

The attention core is :func:`pooled_attention_core`: on the CPU the
equations in f32; on the card the bf16 bias ``rel_h[..., :, None] +
rel_w[..., None, :]`` (rows padded to a multiple of 16 keys) handed to
``F.scaled_dot_product_attention`` as its ``attn_mask``. The interpolated
and gathered tables are derived weights, made once per weight version and
grid pair. ``kernels.relpos_attention`` takes one square grid shared by
queries and keys with d <= 64 and does not compute these cores.

Spans: ``rpn.attn.pool`` around each block's pooling of q, k and v (one
``mvit_pool`` launch on the card); ``rpn.attn.window`` and
``rpn.attn.global`` around each core (tables, bias, softmax and products;
the window partition outside).
``pooled_attention_core.calls`` counts the cores by kind: 21 window and 3
global a forward of MViTv2-B.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..cache import compute_copy, derived
from ..kernels.mvit_pool import mvit_pool
from ..profiling import span
from .vit import LayerNorm, Linear, Mlp


def rel_pos_table(rel_pos: torch.Tensor, q_size: int, k_size: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """(q_size, k_size, d) rows of ``rel_pos`` by scaled relative coordinate
    (detectron2's ``get_rel_pos``): interpolated in f32 where its rows are
    not 2 max(q_size, k_size) - 1, gathered, rounded to ``dtype``; once per
    weight version and sizes (``cache.derived``)."""

    def make():
        rows = 2 * max(q_size, k_size) - 1
        table = rel_pos.float()
        if table.shape[0] != rows:
            table = F.interpolate(table.t()[None], size=rows, mode="linear")[0].t()
        q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
        k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
        idx = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
        return table[idx.long().to(table.device)].to(dtype)

    return derived((rel_pos,), ("rel_pos_table", q_size, k_size, dtype), make)


def _rel_terms(q, rh, rw, q_hw):
    """(rel_h (..., qh, qw, kh), rel_w (..., qh, qw, kw)): q . R over the
    unscaled (N, h, Tq, d) q and the gathered (q, k, d) tables."""
    r_q = q.unflatten(2, q_hw)
    return (torch.einsum("nhyxc,ykc->nhyxk", r_q, rh),
            torch.einsum("nhyxc,xkc->nhyxk", r_q, rw))


def _plain_core(q, k, v, rh, rw, q_hw, kv_hw) -> torch.Tensor:
    """The core's equations in f32, through the images in chunks of at most
    2^26 scores; the result in q's dtype, (N, h, Tq, d)."""
    n, h, tq, d = q.shape
    tk = k.shape[2]
    out = torch.empty((n, tq, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    step = max(1, (1 << 26) // (h * tq * tk))
    rh, rw = rh.float(), rw.float()
    for a in range(0, n, step):
        qf, kf, vf = (x[a:a + step].float() for x in (q, k, v))
        rel_h, rel_w = _rel_terms(qf, rh, rw, q_hw)
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(qf.shape[0], h, tq, tk)
        scores = qf @ kf.transpose(-2, -1) / math.sqrt(d) + bias
        out[a:a + step] = (scores.softmax(-1) @ vf).to(q.dtype)
    return out


def _bias(q, rh, rw, q_hw, kv_hw) -> torch.Tensor:
    """(N, h, Tq, Tk) bias in q's dtype, its rows padded to a multiple of 16
    keys in memory (the attention kernels' alignment), the pad not in the
    view."""
    n, h, tq, _ = q.shape
    kh, kw = kv_hw
    rel_h, rel_w = _rel_terms(q, rh, rw, q_hw)
    tk = kh * kw
    bias = torch.empty((n, h, tq, -(-tk // 16) * 16), dtype=q.dtype, device=q.device)[..., :tk]
    torch.add(rel_h[..., :, None], rel_w[..., None, :], out=bias.view(n, h, *q_hw, kh, kw))
    return bias


def pooled_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                          q_hw: Tuple[int, int], kv_hw: Tuple[int, int], kind: str
                          ) -> torch.Tensor:
    """Attention of (N, h, Tq, d) q over a q_hw grid against (N, h, Tk, d)
    k and v over a kv_hw grid, with decomposed relative positions from the
    tables ``rel_pos_h`` and ``rel_pos_w`` at their pre-training lengths;
    returns (N, h, Tq, d). The CPU runs the equations in f32; the card
    builds the bias and calls SDPA."""
    _CORE_CALLS[kind] += 1
    with span(f"rpn.attn.{kind}"):
        rh = rel_pos_table(rel_pos_h, q_hw[0], kv_hw[0], q.dtype)
        rw = rel_pos_table(rel_pos_w, q_hw[1], kv_hw[1], q.dtype)
        if q.device.type == "cpu":
            return _plain_core(q, k, v, rh, rw, q_hw, kv_hw)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=_bias(q, rh, rw, q_hw, kv_hw))


_CORE_CALLS = {"window": 0, "global": 0}
pooled_attention_core.calls = _CORE_CALLS


def _windows(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, h, d) -> (B * nH * nW, h, w * w, d), a view of (N, w * w,
    h, d): zero-padded below and right to multiples of ``w``, then cut into
    w x w windows."""
    b, hh, ww, h, d = x.shape
    x = F.pad(x, (0, 0, 0, 0, 0, -ww % w, 0, -hh % w))
    nh, nw = x.shape[1] // w, x.shape[2] // w
    x = x.reshape(b, nh, w, nw, w, h, d).permute(0, 1, 3, 2, 4, 5, 6)
    return x.reshape(b * nh * nw, w * w, h, d).transpose(1, 2)


def _unwindows(x: torch.Tensor, w: int, b: int, hw) -> torch.Tensor:
    """``_windows``' inverse on (N, h, w * w, d), cropped to (B, H, W, h, d)."""
    _, h, _, d = x.shape
    nh, nw = -(-hw[0] // w), -(-hw[1] // w)
    x = x.transpose(1, 2).reshape(b, nh, nw, w, w, h, d).permute(0, 1, 3, 2, 4, 5, 6)
    return x.reshape(b, nh * w, nw * w, h, d)[:, :hw[0], :hw[1]]


class PooledAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, stride_q: int, stride_kv: int,
                 window: int, table: int, kernel: int, residual_pooling: bool, eps: float):
        super().__init__()
        self.heads, self.stride_q, self.stride_kv = heads, stride_q, stride_kv
        self.window, self.residual_pooling = window, residual_pooling
        d = dim_out // heads
        self.q_window, self.kv_window = window // stride_q, window // stride_kv
        self.qkv = Linear(dim, 3 * dim_out)
        self.proj = Linear(dim_out, dim_out)
        for name in ("q", "k", "v"):
            setattr(self, f"pool_{name}",
                    nn.Conv2d(d, d, kernel, padding=kernel // 2, groups=d, bias=False))
            setattr(self, f"norm_{name}", LayerNorm(d, eps=eps))
        self.rel_pos_h = nn.Parameter(torch.zeros(table, d))
        self.rel_pos_w = nn.Parameter(torch.zeros(table, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, _ = x.shape
        qkv = self.qkv(x)
        with span("rpn.attn.pool"):
            q, k, v = mvit_pool(qkv, self.heads, self.stride_q, self.stride_kv,
                                [self.pool_q.weight, self.pool_k.weight, self.pool_v.weight],
                                [(n.weight, n.bias) for n in (self.norm_q, self.norm_k,
                                                              self.norm_v)],
                                self.norm_q.eps)
        q_hw, kv_hw = q.shape[1:3], k.shape[1:3]
        if self.window:
            qw, kw = self.q_window, self.kv_window
            out = pooled_attention_core(_windows(q, qw), _windows(k, kw), _windows(v, kw),
                                        self.rel_pos_h, self.rel_pos_w, (qw, qw), (kw, kw),
                                        "window")
            out = _unwindows(out, qw, b, q_hw)
        else:
            flat = [t.flatten(1, 2).transpose(1, 2) for t in (q, k, v)]  # (B, h, T, d) views
            out = pooled_attention_core(*flat, self.rel_pos_h, self.rel_pos_w, tuple(q_hw),
                                        tuple(kv_hw), "global")
            out = out.transpose(1, 2).unflatten(1, q_hw)
        if self.residual_pooling:
            out = out + q
        return self.proj(out.reshape(b, *q_hw, -1))


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, stride_q: int, stride_kv: int,
                 window: int, table: int, cfg):
        super().__init__()
        eps = cfg.ln_eps
        self.stride_q = stride_q
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = PooledAttention(dim, dim_out, heads, stride_q, stride_kv, window, table,
                                    cfg.pool_kernel, cfg.residual_pooling, eps)
        self.norm2 = LayerNorm(dim_out, eps=eps)
        self.mlp = Mlp(dim_out, int(dim_out * cfg.mlp_ratio))
        self.proj = Linear(dim, dim_out) if dim != dim_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = self.norm1(x)
        y = self.attn(xn)
        if self.proj is not None:
            x = self.proj(xn)
        if self.stride_q > 1:
            k = self.stride_q + 1
            x = F.max_pool2d(x.permute(0, 3, 1, 2), k, self.stride_q, k // 2).permute(0, 2, 3, 1)
        x = x + y
        return x + self.mlp(self.norm2(x))


class MViT(nn.Module):
    """NHWC image canvas (B, H, W, 3) -> the four stages' normalised maps
    [scale2 ... scale5], NCHW views with channels-last strides at strides
    4-32."""

    def __init__(self, cfg, dtype=torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.patch_embed = nn.Conv2d(3, cfg.embed_dim, cfg.patch_kernel, stride=cfg.patch_stride,
                                     padding=cfg.patch_padding)
        settings = cfg.blocks()
        self.blocks = nn.ModuleList(
            MultiScaleBlock(s["dim"], s["dim_out"], s["heads"], s["stride_q"], s["stride_kv"],
                            s["window"], s["table"], cfg) for s in settings)
        self.out_channels = [settings[i]["dim_out"] for i in cfg.last_block_indexes]
        for stage, c in enumerate(self.out_channels, 2):
            setattr(self, f"scale{stage}_norm", LayerNorm(c, eps=cfg.ln_eps))

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        pe = self.patch_embed
        x = F.conv2d(images.to(self.dtype).permute(0, 3, 1, 2),
                     compute_copy(pe.weight, self.dtype), compute_copy(pe.bias, self.dtype),
                     pe.stride, pe.padding).permute(0, 2, 3, 1)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.cfg.last_block_indexes:
                norm = getattr(self, f"scale{len(outs) + 2}_norm")
                outs.append(norm(x).permute(0, 3, 1, 2))
        return outs


class FPN(nn.Module):
    """detectron2's top-down ``FPN`` (no norm, biased convs, sum) with
    ``LastLevelMaxPool``: the stages' maps -> [P2, P3, P4, P5, P6], NCHW
    views with channels-last strides of ``out`` channels."""

    def __init__(self, in_channels: List[int], out: int):
        super().__init__()
        self.levels = list(range(2, 2 + len(in_channels)))
        for lv, c in zip(self.levels, in_channels):
            setattr(self, f"fpn_lateral{lv}", nn.Conv2d(c, out, 1))
            setattr(self, f"fpn_output{lv}", nn.Conv2d(out, out, 3, padding=1))

    def _conv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        conv = getattr(self, name)
        return F.conv2d(x, compute_copy(conv.weight, x.dtype), compute_copy(conv.bias, x.dtype),
                        1, conv.padding)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        top = self.levels[-1]
        prev = self._conv(feats[-1], f"fpn_lateral{top}")
        results = [self._conv(prev, f"fpn_output{top}")]
        for lv, f in zip(self.levels[-2::-1], feats[-2::-1]):
            prev = self._conv(f, f"fpn_lateral{lv}") + F.interpolate(prev, scale_factor=2.0,
                                                                     mode="nearest")
            results.insert(0, self._conv(prev, f"fpn_output{lv}"))
        return results + [F.max_pool2d(results[-1], 1, 2)]

