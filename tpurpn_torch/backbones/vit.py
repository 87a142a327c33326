"""ViTDet's backbone: a plain ViT with window and global attention and
decomposed relative positions, and the simple feature pyramid on its
stride-16 map (Li, Mao, Girshick, He 2022, arXiv:2203.16527; detectron2's
``modeling/backbone/vit.py`` and ``utils.py``). No TPU counterpart: the JAX
package serves single-level CNNs only.

Equations (C channels, h heads of d = C / h, tokens on an H x W grid):

* patch embedding: a P x P convolution at stride P (here the same product
  as one matmul over the flattened patches), plus the absolute positions:
  the pre-training grid's table (a cls row first, dropped) interpolated
  bicubically (``align_corners=False``) to H x W, held in the compute dtype
  once per weight version (``cache.derived``);
* a block: ``x + attn(norm1(x))`` then ``x + fc2(gelu(fc1(norm2(x))))``,
  LayerNorm eps 1e-6, exact GELU. A window block zero-pads ``norm1(x)`` to a
  multiple of the window ``w`` and attends within each w x w window; its pad
  tokens take part as keys and values, unmasked (their k and v are the qkv
  bias), and are cropped after ``proj``. A global block attends over all
  H x W tokens;
* attention: ``softmax(q k^T / sqrt(d) + rel_h + rel_w) v`` where, for query
  (i, j) and key (k, l), ``rel_h = q . R_h[i - k + s - 1]`` and ``rel_w =
  q . R_w[j - l + s - 1]`` over the unscaled q (s: the side the block
  attends over, 2s - 1 rows a table);
* the pyramid (``norm="LN"``: a LayerNorm over channels, eps 1e-6, after
  every conv, which then has no bias): P2 = two stride-2 transposed 2x2
  convs (C -> C/2, LayerNorm, GELU, -> C/4); P3 one (C -> C/2); P4 the map;
  P5 a 2x2 max-pool; each then a 1x1 and a 3x3 conv to 256 channels; P6 =
  ``max_pool2d(P5, kernel_size=1, stride=2)``.

Layout: tokens are NHWC (B, H, W, C), as in detectron2; the pyramid's convs
run on NCHW views with channels-last strides. Compute is in the model's
dtype (bf16) with f32 parameters, read through their compute copies
(``cache.compute_copy``: a cast at each use while autograd records, else one
copy per parameter version). The attention core is
``kernels.relpos_attention``: on the card one launch a core of a
hand-written flash-attention kernel that computes q . R_h and q . R_w itself
and adds the two terms to each tile of scores on the SM (f32 scores, bias
and softmax), reading q, k and v in place from the qkv product's (B, T, 3,
h, d) output and writing (B, T, h, d), so that ``proj``'s reshape is a view;
on the CPU its plain version, the same equations in f32. No (B, h, T, T)
bias exists.

Spans: ``rpn.attn.window`` and ``rpn.attn.global`` around each attention
core (q, k, v to the per-head output, relative positions included; the
window partition, qkv and proj stay outside); ``attention_core.calls``
counts the cores by kind.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ..cache import compute_copy, derived
from ..kernels.relpos_attention import relpos_attention
from ..profiling import span


class Linear(nn.Linear):
    """``nn.Linear`` (with a bias) with f32 parameters read in the input's
    dtype (``cache.compute_copy``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, compute_copy(self.weight, x.dtype), compute_copy(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim, affine parameters in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, compute_copy(self.weight, x.dtype),
                            compute_copy(self.bias, x.dtype), self.eps)


def rel_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size, d) table R[i, k] = rel_pos[i - k + size - 1] (query and key
    grids of one size, as in every ViTDet block). With :func:`expansion`, the
    materialised form of the bias that ``relpos_attention`` computes in
    place: the tests hold the core against it, and portbench's readings
    build a core with the window's pad keys masked from it."""
    if rel_pos.shape[0] != 2 * size - 1:
        raise ValueError(f"a relative-position table of {rel_pos.shape[0]} rows for side {size}")
    idx = torch.arange(size, device=rel_pos.device)
    return rel_pos[idx[:, None] - idx[None, :] + size - 1]


_EXPANSIONS: Dict[tuple, torch.Tensor] = {}


def expansion(side: int, device, dtype) -> torch.Tensor:
    """(2 side, T') 0/1 matrix whose column k * side + l has its ones in rows k
    and side + l: [rel_h | rel_w] times it is rel_h[k] + rel_w[l] for every
    key (k, l), one rounding. T' is side^2 rounded up to 16 (zero columns),
    so that the bias's rows are aligned for the attention kernels. Made once
    a (side, device, dtype)."""
    key = (side, torch.device(device), dtype)
    e = _EXPANSIONS.get(key)
    if e is None:
        t = side * side
        e = torch.zeros((2 * side, -(-t // 16) * 16), dtype=dtype)
        cols = torch.arange(t)
        e[cols // side, cols] = 1
        e[side + cols % side, cols] = 1
        e = _EXPANSIONS[key] = e.to(device)
    return e


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_pos_h: torch.Tensor,
                   rel_pos_w: torch.Tensor, side: int, kind: str) -> torch.Tensor:
    """Attention of (N, h, side*side, d) q, k, v (any strides: the qkv
    product's views) over a side x side grid with decomposed relative
    positions; returns the per-head output (N, h, T, d), on the card a view
    of (N, T, h, d). One ``relpos_attention`` launch on the card."""
    _CORE_CALLS[kind] += 1
    with span(f"rpn.attn.{kind}"):
        return relpos_attention(q, k, v, rel_pos_h, rel_pos_w, side)


_CORE_CALLS = {"window": 0, "global": 0}
attention_core.calls = _CORE_CALLS


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, side: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim, bias=True)
        self.proj = Linear(dim, dim, bias=True)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * side - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * side - 1, dim // heads))

    def forward(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        n, s, _, c = x.shape  # (N, side, side, C)
        qkv = self.qkv(x).reshape(n, s * s, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        out = attention_core(qkv[0], qkv[1], qkv[2], self.rel_pos_h, self.rel_pos_w, s, kind)
        return self.proj(out.permute(0, 2, 1, 3).reshape(n, s, s, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_hidden: int, eps: float, window: int,
                 grid: int):
        super().__init__()
        self.window = window  # 0: global
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads, window or grid)
        self.norm2 = LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, mlp_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        if self.window:
            b, hh, ww, c = y.shape
            w = self.window
            ph, pw = -hh % w, -ww % w
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
            nh, nw = (hh + ph) // w, (ww + pw) // w
            y = y.reshape(b, nh, w, nw, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, c)
            y = self.attn(y, "window")
            y = y.reshape(b, nh, nw, w, w, c).permute(0, 1, 3, 2, 4, 5)
            y = y.reshape(b, nh * w, nw * w, c)[:, :hh, :ww]
        else:
            y = self.attn(y, "global")
        x = x + y
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """NHWC image canvas (B, S, S, 3) -> the stride-P token map (B, S/P, S/P, C)."""

    def __init__(self, cfg, img_size: int, dtype=torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        c, p = cfg.embed_dim, cfg.patch_size
        self.grid = img_size // p
        self.patch_embed = nn.Conv2d(3, c, p, stride=p)
        n_pre = (cfg.pretrain_img_size // p) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + n_pre, c))
        self.blocks = nn.ModuleList(
            Block(c, cfg.num_heads, int(c * cfg.mlp_ratio), cfg.ln_eps,
                  0 if i in cfg.global_blocks else cfg.window_size, self.grid)
            for i in range(cfg.depth))

    def abs_pos(self) -> torch.Tensor:
        """(1, G, G, C) absolute positions in the compute dtype: the table
        without its cls row, bicubically interpolated to the token grid in
        f32, then rounded; once per weight version (``cache.derived``)."""
        pe, g = self.pos_embed, self.grid

        def make():
            n = int(round((pe.shape[1] - 1) ** 0.5))
            t = pe[:, 1:].float().reshape(1, n, n, -1).permute(0, 3, 1, 2)
            t = F.interpolate(t, size=(g, g), mode="bicubic", align_corners=False)
            return t.permute(0, 2, 3, 1).contiguous().to(self.dtype)

        return derived((pe,), ("abs_pos", g, self.dtype), make)

    def patch_matrix(self) -> torch.Tensor:
        """The patch embedding's (C, 3 P P) weight matrix in the compute
        dtype, once per weight version (``cache.derived``)."""
        w = self.patch_embed.weight
        return derived((w,), ("patch_matrix", self.dtype),
                       lambda: w.reshape(w.shape[0], -1).to(self.dtype))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, s, _, _ = images.shape
        p, g = self.cfg.patch_size, self.grid
        x = images.to(self.dtype)
        # the stride-P conv as one product over flattened (channel, row, col) patches
        x = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4).reshape(b, g, g, 3 * p * p)
        x = F.linear(x, self.patch_matrix(), compute_copy(self.patch_embed.bias, self.dtype))
        x = x + self.abs_pos()
        for blk in self.blocks:
            x = blk(x)
        return x


class ChannelNorm(LayerNorm):
    """LayerNorm over the channels of an NCHW view with channels-last strides."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNorm(nn.Module):
    """A bias-free conv followed by the channel LayerNorm (detectron2's
    ``Conv2d(..., bias=False, norm=LayerNorm)``)."""

    def __init__(self, c_in: int, c_out: int, k: int, eps: float):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, padding=k // 2, bias=False)
        self.norm = ChannelNorm(c_out, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(F.conv2d(x, compute_copy(self.conv.weight, x.dtype), None, 1,
                                  self.conv.padding))


class Up(nn.ConvTranspose2d):
    """A 2x2 transposed conv at stride 2, weights read in the input's dtype."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(c_in, c_out, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, compute_copy(self.weight, x.dtype),
                                  compute_copy(self.bias, x.dtype), stride=2)


class SimpleFeaturePyramid(nn.Module):
    """The ViT's (B, G, G, C) map -> [P2, P3, P4, P5, P6], each an NCHW view
    (channels-last strides) of ``out`` channels at strides 4-64."""

    def __init__(self, dim: int, out: int, eps: float):
        super().__init__()
        self.p2_up1 = Up(dim, dim // 2)
        self.p2_norm = ChannelNorm(dim // 2, eps=eps)
        self.p2_up2 = Up(dim // 2, dim // 4)
        self.p3_up1 = Up(dim, dim // 2)
        ins = {"p2": dim // 4, "p3": dim // 2, "p4": dim, "p5": dim}
        for name, c in ins.items():
            setattr(self, f"{name}_lateral", ConvNorm(c, out, 1, eps))
            setattr(self, f"{name}_output", ConvNorm(out, out, 3, eps))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        maps: Dict[str, torch.Tensor] = {
            "p2": self.p2_up2(F.gelu(self.p2_norm(self.p2_up1(x)))),
            "p3": self.p3_up1(x),
            "p4": x,
            "p5": F.max_pool2d(x, 2, 2),
        }
        levels = [getattr(self, f"{n}_output")(getattr(self, f"{n}_lateral")(m))
                  for n, m in maps.items()]
        return levels + [F.max_pool2d(levels[-1], 1, 2)]
