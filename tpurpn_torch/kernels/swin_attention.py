"""Swin's shifted-window attention core as one hand-written kernel that
reads the qkv product in grid order.

``swin_attention(qkv, qkv_bias, table, heads, window, shift, masked)``
takes a block's qkv product over the unpadded (B, H, W) token grid, (B, H,
W, 3 C) (q in channels [0, C), k in [C, 2 C), v in [2 C, 3 C), each of
``heads`` heads of d = C / heads), the bias of that Linear (3 C) and the
relative-position table ((2 M - 1)^2, heads), and returns the attention
output (B, H, W, C) in grid order. Its equations are Swin's (``backbones/
swin.py`` states them): the grid zero-padded below and right to the
multiples (Hp, Wp) of the window M, where ``shift`` s > 0 rolled by (-s,
-s), cut into M x M windows; a pad token's k and v are the Linear's bias
(the product of a zero token), keys like any other; per head
``softmax(q d^-0.5 k^T + B[h] + mask) v`` with ``B[h][a, b] =
table[index[a, b], h]`` and, where ``masked``, ``shift_mask``'s -100
between positions of differing regions; each window token's output back at
its unrolled grid position, the pad tokens' dropped.

On CUDA tensors it launches ``swin_attention_kernel`` of
``csrc/swin_attention.cu`` once (counted in ``launches``; its source note
says what bounds it and how it is laid out): each window token's source
((y + s) mod Hp, (x + s) mod Wp) is an address in the kernel, a source off
the grid reads the bias, and the bias and the mask are made on the SM, so
no padded, rolled or window-ordered copy, no bias and no mask reaches
device memory. CPU tensors run :func:`swin_attention_plain`: the pad with
the bias's rows, one gather into window order (``window_order``), the
equations in f32 (``_plain_core``) and one gather back (``grid_order``),
its two layout passes in ``rpn.attn.layout`` spans. There is no fallback: a
CUDA call the kernel does not take raises ValueError: d other than 32, a
window other than 7 (the values of every published Swin detection
backbone), more than 32 heads, a dtype other than bf16, a layout that is
not whole 16-byte vectors, and a call that autograd would differentiate
(serving runs without; training refuses a pyramid model).

Numerics on the card: bf16 q, k, v; f32 scores, bias (from the f32
table), mask and softmax; P rounded to bf16 for the product with V; f32
sums; one rounding of the output to bf16.

Replaces no TPU kernel (the JAX package has no Swin); it replaces each
block's pad and gather into window order, the bias (and in a shifted
block the bias plus the mask) expanded over the images in device memory,
cuDNN's SDPA and the gather back to the grid.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from ..cache import derived
from ..profiling import span

D = 32  # the kernel's head width
WINDOW = 7  # the kernel's window
MAX_HEADS = 32
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


def padded(n: int, window: int) -> int:
    return -(-n // window) * window


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
        hp, wp = padded(h, window), padded(w, window)
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
        hp, wp = padded(h, window), padded(w, window)
        inv = torch.empty(hp * wp, dtype=torch.int64)
        inv[window_order(h, w, window, shift, torch.device("cpu"))] = torch.arange(hp * wp)
        return inv.reshape(hp, wp)[:h, :w].reshape(-1).to(device)

    return _no_grad_tensor(make)


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


def swin_attention_plain(qkv: torch.Tensor, qkv_bias: torch.Tensor, table: torch.Tensor,
                         heads: int, window: int, shift: int, masked: bool) -> torch.Tensor:
    """The core in plain PyTorch: the product padded to (Hp, Wp) with the
    bias's rows (in qkv's dtype, as the Linear gives a zero token) and
    gathered into window order, the equations in f32, the result gathered
    back to the grid in qkv's dtype."""
    b, hh, ww, c3 = qkv.shape
    c, m = c3 // 3, window
    hp, wp = padded(hh, m), padded(ww, m)
    with span("rpn.attn.layout"):
        full = qkv_bias.to(qkv.dtype).expand(b, hp, wp, c3).clone()
        full[:, :hh, :ww] = qkv
        win = full.reshape(b, hp * wp, c3).index_select(1, window_order(hh, ww, m, shift,
                                                                         qkv.device))
    q, k, v = win.reshape(-1, m * m, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    mask = shift_mask(hp, wp, m, shift, qkv.device) if masked else None
    out = _plain_core(q, k, v, relative_bias(table, m, torch.float32), mask)
    with span("rpn.attn.layout"):
        out = out.transpose(1, 2).reshape(b, hp * wp, c).index_select(
            1, grid_order(hh, ww, m, shift, qkv.device))
    return out.reshape(b, hh, ww, c)


def _check(qkv, qkv_bias, table, heads, window, shift) -> None:
    if qkv.dim() != 4 or heads <= 0 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"swin_attention takes a (B, H, W, 3 C) product of {heads} heads, got "
                         f"{tuple(qkv.shape)}")
    if qkv_bias.shape != qkv.shape[-1:]:
        raise ValueError(f"swin_attention: a qkv bias of {qkv.shape[-1]}, got "
                         f"{tuple(qkv_bias.shape)}")
    if table.shape != ((2 * window - 1) ** 2, heads):
        raise ValueError(f"swin_attention: a table {((2 * window - 1) ** 2, heads)}, got "
                         f"{tuple(table.shape)}")
    if not 0 <= shift < window:
        raise ValueError(f"swin_attention: shift {shift} for a window of {window}")
    if len({t.device for t in (qkv, qkv_bias, table)}) != 1:
        raise ValueError("swin_attention's operands must be on one device")


def swin_attention(qkv: torch.Tensor, qkv_bias: torch.Tensor, table: torch.Tensor, heads: int,
                   window: int, shift: int, masked: bool) -> torch.Tensor:
    """(B, H, W, 3 C) qkv product -> (B, H, W, C) in qkv's dtype. A CUDA
    tensor launches ``swin_attention_kernel`` once (``launches``); a CPU
    tensor runs :func:`swin_attention_plain`. ValueError on shapes either
    path refuses, and on CUDA on what the kernel does not take (the
    module's docstring)."""
    _check(qkv, qkv_bias, table, heads, window, shift)
    if qkv.device.type == "cpu":
        return swin_attention_plain(qkv, qkv_bias, table, heads, window, shift, masked)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qkv, qkv_bias, table)):
        raise ValueError("swin_attention has no backward on the card: call it under "
                         "torch.no_grad() (serving)")
    b, hh, ww, c3 = qkv.shape
    d = c3 // (3 * heads)
    if qkv.dtype != torch.bfloat16 or d != D or window != WINDOW or heads > MAX_HEADS:
        raise ValueError(f"swin_attention's kernel takes bf16 heads of {D}, a window of {WINDOW} "
                         f"and at most {MAX_HEADS} heads, got {qkv.dtype} d={d} "
                         f"window={window} heads={heads}")
    sb, sh, sw, sc = qkv.stride()
    if sc != 1 or any(s % 8 for s in (sb, sh, sw)) or qkv.data_ptr() % 16:
        raise ValueError(f"swin_attention's kernel reads whole 16-byte vectors: channels at "
                         f"unit stride, other strides multiples of 8 elements, a 16-byte-aligned "
                         f"start; got strides {qkv.stride()}")
    if max(sb, sh, sw) >= 2 ** 31:
        raise ValueError(f"swin_attention's kernel takes strides below 2^31, got {qkv.stride()}")
    bias = qkv_bias.detach().to(torch.bfloat16).contiguous()
    tab = table.detach().float().contiguous()
    out = torch.empty((b, hh, ww, c3 // 3), dtype=torch.bfloat16, device=qkv.device)
    lib = _build.load("swin_attention")
    code = lib.swin_attention(
        qkv.data_ptr(), bias.data_ptr(), tab.data_ptr(), out.data_ptr(), b, hh, ww, sb, sh, sw,
        heads, shift, int(bool(masked)), D ** -0.5,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(lib, "swin_attention", code)
    swin_attention.launches += 1
    return out


swin_attention.launches = 0
