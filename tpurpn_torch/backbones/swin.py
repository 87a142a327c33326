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
compute from f32 parameters read through their compute copies. A block
runs ``qkv`` on ``norm1``'s (B, H, W) grid tokens, then the attention core
:func:`window_attention_core` on that product, then ``proj`` on the grid:
the pad (a pad token's k and v are the bias of ``qkv``, what the Linear
gives a zero token), the roll, the window cut, their inverse and the crop
are the core's indexing. The core is ``kernels.swin_attention``: on the
card one ``swin_attention_kernel`` launch a block that reads the product
in grid order and makes the table bias and the mask on the SM; on the CPU
its plain version (one pad and one gather into window order,
``window_order``, the equations in f32, one gather back, ``grid_order``).
The index maps, the bias and the mask live there; they are imported here.

Spans: ``rpn.attn.window`` around each unshifted core and
``rpn.attn.shifted`` around each shifted one (on the card the kernel
whole; on the CPU the plain version, whose pad and gathers open
``rpn.attn.layout`` inside it). ``window_attention_core.calls`` counts
the cores by kind: 12 window and 12 shifted a forward of Swin-B. The
block's shift lives on its attention (``SwinBlock.shift`` reads and sets
``WindowAttention.shift``); the mask applies where the block passes its
padded grid to the attention, the roll wherever the shift is not 0.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..cache import compute_copy
from ..kernels.swin_attention import (  # noqa: F401  (the index maps, bias and mask)
    _plain_core, grid_order, padded, relative_bias, relative_index, shift_mask, swin_attention,
    window_order)
from ..profiling import span
from .vit import LayerNorm, Linear, Mlp


def window_attention_core(qkv: torch.Tensor, qkv_bias: torch.Tensor, table: torch.Tensor,
                          heads: int, window: int, shift: int, masked: bool) -> torch.Tensor:
    """Swin's attention core on a block's (B, H, W, 3 C) qkv product over
    its grid (``qkv_bias``: the Linear's bias, the pad tokens' q, k and v),
    with the table's bias, rolled by ``shift`` and, where ``masked``, with
    the shift mask; returns (B, H, W, C) in grid order
    (``kernels.swin_attention``)."""
    kind = "shifted" if shift else "window"
    _CORE_CALLS[kind] += 1
    with span(f"rpn.attn.{kind}"):
        return swin_attention(qkv, qkv_bias, table, heads, window, shift, masked)


_CORE_CALLS = {"window": 0, "shifted": 0}
window_attention_core.calls = _CORE_CALLS


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2,
                                                                     heads))

    def forward(self, x: torch.Tensor, grid: Optional[Tuple[int, int]]) -> torch.Tensor:
        """(B, H, W, C) grid tokens -> (B, H, W, C); ``grid``: the padded grid
        of a shifted block, whose mask applies, or None (no mask; the roll
        follows ``shift`` either way)."""
        qkv = self.qkv(x)
        out = window_attention_core(qkv, compute_copy(self.qkv.bias, qkv.dtype),
                                    self.relative_position_bias_table, self.heads, self.window,
                                    self.shift, grid is not None)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float,
                 eps: float):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = WindowAttention(dim, heads, window, shift)
        self.norm2 = LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    @property
    def shift(self) -> int:
        return self.attn.shift

    @shift.setter
    def shift(self, value: int) -> None:
        self.attn.shift = value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, hh, ww, _ = x.shape
        m = self.window
        grid = (padded(hh, m), padded(ww, m)) if self.shift else None
        x = x + self.attn(self.norm1(x), grid)
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
