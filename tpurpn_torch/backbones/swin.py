"""Swin's backbone: shifted-window attention with a learned relative-position
bias and patch merging between four stages (Liu, Lin, Cao, Hu, Wei, Zhang,
Lin, Guo 2021, arXiv:2103.14030; ``mmdet/models/backbones/
swin_transformer.py`` of Swin-Transformer-Object-Detection, of which
detectron2's ``modeling/backbone/swin.py`` is a port). The top-down FPN on
its four stages is ``mvit.FPN``. No TPU counterpart: the JAX package serves
single-level CNNs only.

Equations (tokens NHWC on an H x W grid; stage i = 0..3 has C = C_0 2^i
channels in h heads of d = C / h; window M, shift s = M // 2; LayerNorm
eps 1e-5; exact GELU; ``config.SwinConfig``):

* patch embedding: a P x P conv at stride P, 3 -> C_0 channels, with bias
  (the canvas is a multiple of P: no padding), then a LayerNorm over C_0;
  no absolute positions;
* stage i: ``depths[i]`` blocks, block j with shift 0 where j is even,
  else s; after every stage but the last a patch merging;
* a block: ``xn = norm1(x)`` zero-padded below and right to (Hp, Wp), the
  multiples of M (after the norm: pad tokens are exactly 0, and take part
  as keys, unmasked); where s > 0 rolled by (-s, -s) over (H, W)
  (``rolled[y, x] = xn[(y + s) % Hp, (x + s) % Wp]``); cut into M x M
  windows; ``qkv`` (C -> 3C, with bias); per head ``softmax(q d^-0.5 k^T
  + B[h] + mask) v``; ``proj`` (C -> C, with bias); the windows merged
  back, rolled by (+s, +s) and cropped to (H, W); ``x = x + that``, then
  ``x = x + fc2(gelu(fc1(norm2(x))))`` with fc1 C -> 4C;
* the bias: ``B[h][a, b] = table[index[a, b], h]``, ``table`` ((2M - 1)^2,
  h), ``index[a, b] = (ya - yb + M - 1)(2M - 1) + (xa - xb + M - 1)`` for
  window positions a and b in row-major order;
* the mask, where s > 0 only: the rolled (Hp, Wp) grid labelled by the
  products of the row slices [0, Hp - M), [Hp - M, Hp - s), [Hp - s, Hp)
  and the same of columns (Swin's ``img_mask``: the labels belong to the
  rolled grid; no roll is applied to them), cut into windows as the
  tokens are; -100.0 between two positions whose labels differ, else 0.
  So two tokens attend to each other where ``(y - s) // M`` and ``(x - s)
  // M`` of their unrolled coordinates agree: the windows of the grid
  displaced by s, the wrapped-around rows and columns apart;
* patch merging: H and W zero-padded to even; ``x[0::2, 0::2]``,
  ``x[1::2, 0::2]``, ``x[0::2, 1::2]``, ``x[1::2, 1::2]`` concatenated, in
  that order, to 4C; LayerNorm(4C); a bias-free 4C -> 2C linear;
* outputs: each stage's map before its merging through a LayerNorm of its
  own (``norm0``-``norm3``): strides P to 8P, C_0 to 8 C_0 channels.

Layout and compute follow ``vit.py`` and ``mvit.py``: NHWC tokens, bf16
compute from f32 parameters read through their compute copies. Pad, roll
and window cut are one pad and one gather of ``norm1``'s output in window
order (``window_order``: the rolled partition's source of each window
token, made once a grid and shift); the merge back, roll and crop are one
gather of ``proj``'s output (``grid_order``). The attention core is
:func:`window_attention_core`: on the CPU the equations in f32, in chunks
of windows; on the card ``F.scaled_dot_product_attention`` with the bias
as its ``attn_mask`` (bf16, rows padded to 16 keys in memory), broadcast
over images and windows in an unshifted block; in a shifted block the
bias plus the mask, (nW, h, M^2, M^2), a derived weight of the table and
the grid, expanded over the batch's images, since SDPA's mask broadcasts
over whole dimensions only. The gathered bias and the shifted blocks'
bias plus mask are derived weights, made once per weight version (and
grid: ``cache.derived``). ``kernels.relpos_attention`` takes neither a
table bias nor a mask.

Spans: ``rpn.attn.window`` around each unshifted core and
``rpn.attn.shifted`` around each shifted one (bias, mask, softmax and
products); ``rpn.attn.layout`` around each block's pad, roll and window
cut, and around its merge back, roll back and crop.
``window_attention_core.calls`` counts the cores by kind: 12 window and
12 shifted a forward of Swin-B.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..cache import compute_copy, derived
from ..profiling import span
from .vit import LayerNorm, Linear, Mlp

MASKED = -100.0  # Swin's additive mask between the shifted windows' regions


def relative_index(window: int) -> torch.Tensor:
    """(M^2, M^2) int64: each pair of window positions' row of the table."""
    y, x = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    y, x = y.reshape(-1), x.reshape(-1)
    return ((y[:, None] - y[None, :] + window - 1) * (2 * window - 1)
            + x[:, None] - x[None, :] + window - 1)


def relative_bias(table: torch.Tensor, window: int, dtype: torch.dtype) -> torch.Tensor:
    """(h, M^2, M^2) ``B[h][a, b] = table[index[a, b], h]`` in ``dtype``,
    once per weight version (``cache.derived``)."""
    def make():
        t = window * window
        return table[relative_index(window).to(table.device).reshape(-1)].reshape(
            t, t, -1).permute(2, 0, 1).to(dtype)

    return derived((table,), ("swin_bias", window, dtype), make)


def _no_grad_tensor(make):
    """``make()`` outside inference mode and autograd, so that a tensor made
    once a grid can serve later calls whatever their mode."""
    with torch.inference_mode(False), torch.no_grad():
        return make()


@functools.lru_cache(maxsize=64)
def shift_mask(hp: int, wp: int, window: int, shift: int, device: torch.device) -> torch.Tensor:
    """(nW, M^2, M^2) f32: ``MASKED`` between the positions of a window whose
    region labels differ, 0 elsewhere, on the rolled (Hp, Wp) grid; made
    once a grid and device."""
    def make():
        edges = lambda n: torch.bucketize(torch.arange(n), torch.tensor(  # noqa: E731
            [n - window, n - shift]), right=True)
        label = edges(hp)[:, None] * 3 + edges(wp)[None, :]
        nh, nw = hp // window, wp // window
        w = label.reshape(nh, window, nw, window).permute(0, 2, 1, 3).reshape(nh * nw, -1)
        mask = torch.zeros(w.shape[0], w.shape[1], w.shape[1])
        return mask.masked_fill_(w[:, :, None] != w[:, None, :], MASKED).to(device)

    return _no_grad_tensor(make)


@functools.lru_cache(maxsize=64)
def window_order(h: int, w: int, window: int, shift: int, device: torch.device) -> torch.Tensor:
    """(nW M^2,) int64: for each token of the rolled grid's windows, in
    window order (windows row-major, then positions row-major), its position
    in the zero-padded (Hp, Wp) grid, flattened; made once a grid."""
    def make():
        hp, wp = -(-h // window) * window, -(-w // window) * window
        ys = (torch.arange(hp) + shift) % hp
        xs = (torch.arange(wp) + shift) % wp
        src = ys[:, None] * wp + xs[None, :]  # the rolled grid's sources
        nh, nw = hp // window, wp // window
        return src.reshape(nh, window, nw, window).permute(0, 2, 1, 3).reshape(-1).to(device)

    return _no_grad_tensor(make)


@functools.lru_cache(maxsize=64)
def grid_order(h: int, w: int, window: int, shift: int, device: torch.device) -> torch.Tensor:
    """(H W,) int64: for each token of the (H, W) grid, row-major, its
    position among the window-ordered tokens (``window_order``'s inverse,
    cropped); made once a grid."""
    def make():
        hp, wp = -(-h // window) * window, -(-w // window) * window
        inv = torch.empty(hp * wp, dtype=torch.int64)
        inv[window_order(h, w, window, shift, torch.device("cpu"))] = torch.arange(hp * wp)
        return inv.reshape(hp, wp)[:h, :w].reshape(-1).to(device)

    return _no_grad_tensor(make)


def _padded_rows(x: torch.Tensor, lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """``x`` (..., T, T) copied, broadcast over the leading dims ``lead``,
    into rows padded to a multiple of 16 keys in memory (the attention
    kernels' alignment), the pad not in the view."""
    t = x.shape[-1]
    out = torch.empty((*lead, *x.shape[:-1], -(-t // 16) * 16), dtype=x.dtype,
                      device=x.device)[..., :t]
    out.copy_(x)
    return out


def _attn_bias(table: torch.Tensor, window: int, grid: Optional[Tuple[int, int]],
               dtype: torch.dtype) -> torch.Tensor:
    """The card's mask for SDPA, once per weight version (and grid): (1, h,
    T, T) the bias, or with the shifted block's padded ``grid`` (nW, h, T,
    T) the bias plus the mask, rounded once to ``dtype``."""
    if grid is None:
        return derived((table,), ("swin_sdpa_bias", window, dtype),
                       lambda: _padded_rows(relative_bias(table, window, dtype)[None]))

    def make():
        mask = shift_mask(*grid, window, window // 2, table.device)
        return _padded_rows((relative_bias(table, window, torch.float32)[None]
                             + mask[:, None]).to(dtype))

    return derived((table,), ("swin_sdpa_bias", window, grid, dtype), make)


def _plain_core(q, k, v, bias, mask) -> torch.Tensor:
    """The core's equations in f32 over (N, h, T, d) q, k, v, the (h, T, T)
    bias and the (nW, T, T) mask (window n has mask n mod nW) or None, in
    chunks of at most 2^26 scores; the result in q's dtype, (N, h, T, d)."""
    n, h, t, d = q.shape
    out = torch.empty((n, t, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    step = max(1, (1 << 26) // (h * t * t))
    bias = bias.float()
    for a in range(0, n, step):
        qf, kf, vf = (x[a:a + step].float() for x in (q, k, v))
        scores = (qf * d ** -0.5) @ kf.transpose(-2, -1) + bias
        if mask is not None:
            scores = scores + mask[torch.arange(a, a + qf.shape[0]) % mask.shape[0]][:, None]
        out[a:a + step] = (scores.softmax(-1) @ vf).to(q.dtype)
    return out


def window_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          table: torch.Tensor, window: int,
                          grid: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Attention of (N, h, M^2, d) q, k, v (any strides: the qkv product's
    views), N = images x windows, within each window with the table's
    bias, and with the shift mask of the padded ``grid`` (Hp, Wp) where it
    is given (a shifted block); returns (N, h, M^2, d). The CPU runs the
    equations in f32; the card calls SDPA."""
    kind = "window" if grid is None else "shifted"
    _CORE_CALLS[kind] += 1
    with span(f"rpn.attn.{kind}"):
        if q.device.type == "cpu":
            mask = None if grid is None else shift_mask(*grid, window, window // 2, q.device)
            return _plain_core(q, k, v, relative_bias(table, window, torch.float32), mask)
        bias = _attn_bias(table, window, grid, q.dtype)
        if grid is not None:  # (nW, h, T, T) repeated over the images
            bias = _padded_rows(bias, (q.shape[0] // bias.shape[0],)).flatten(0, 1)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


_CORE_CALLS = {"window": 0, "shifted": 0}
window_attention_core.calls = _CORE_CALLS


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2,
                                                                     heads))

    def forward(self, x: torch.Tensor, grid: Optional[Tuple[int, int]]) -> torch.Tensor:
        """(N, M^2, C) window tokens -> (N, M^2, C); ``grid``: the padded grid
        of a shifted block, whose mask applies, or None."""
        n, t, c = x.shape
        qkv = self.qkv(x).reshape(n, t, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        out = window_attention_core(qkv[0], qkv[1], qkv[2], self.relative_position_bias_table,
                                    self.window, grid)
        return self.proj(out.transpose(1, 2).reshape(n, t, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float,
                 eps: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        m, s = self.window, self.shift
        hp, wp = -(-hh // m) * m, -(-ww // m) * m
        xn = self.norm1(x)
        with span("rpn.attn.layout"):
            xn = F.pad(xn, (0, 0, 0, wp - ww, 0, hp - hh)).reshape(b, hp * wp, c)
            win = xn.index_select(1, window_order(hh, ww, m, s, x.device))
        y = self.attn(win.reshape(-1, m * m, c), (hp, wp) if s else None)
        with span("rpn.attn.layout"):
            y = y.reshape(b, -1, c).index_select(1, grid_order(hh, ww, m, s, x.device))
        x = x + y.reshape(b, hh, ww, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, hh, ww, _ = x.shape
        x = F.pad(x, (0, 0, 0, ww % 2, 0, hh % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return F.linear(self.norm(x), compute_copy(self.reduction.weight, x.dtype))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, cfg, merge: bool):
        super().__init__()
        m = cfg.window_size
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, m, 0 if j % 2 == 0 else m // 2, cfg.mlp_ratio, cfg.ln_eps)
            for j in range(depth))
        self.downsample = PatchMerging(dim, cfg.ln_eps) if merge else None


class SwinTransformer(nn.Module):
    """NHWC image canvas (B, H, W, 3), H and W multiples of the patch size ->
    the four stages' normalised maps, NCHW views with channels-last strides
    at strides P to 8P."""

    def __init__(self, cfg, dtype=torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        c, p = cfg.embed_dim, cfg.patch_size
        self.patch_embed = nn.Conv2d(3, c, p, stride=p)
        self.patch_norm = LayerNorm(c, eps=cfg.ln_eps)
        self.out_channels = [c << i for i in range(len(cfg.depths))]
        self.layers = nn.ModuleList(
            SwinStage(dim, depth, heads, cfg, i < len(cfg.depths) - 1)
            for i, (dim, depth, heads) in enumerate(zip(self.out_channels, cfg.depths,
                                                        cfg.num_heads)))
        for i, dim in enumerate(self.out_channels):
            setattr(self, f"norm{i}", LayerNorm(dim, eps=cfg.ln_eps))

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        pe = self.patch_embed
        x = F.conv2d(images.to(self.dtype).permute(0, 3, 1, 2),
                     compute_copy(pe.weight, self.dtype), compute_copy(pe.bias, self.dtype),
                     pe.stride).permute(0, 2, 3, 1)
        x = self.patch_norm(x)
        outs = []
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x)
            outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs
