"""MViTv2's pooling of q, k and v as one hand-written kernel.

``mvit_pool(qkv, heads, stride_q, stride_kv, convs, norms, eps)`` takes a
block's qkv product (B, H, W, 3 C), q in channels [0, C), k in [C, 2 C), v
in [2 C, 3 C), each of ``heads`` heads of d = C / heads, and returns the
pooled (q, k, v), each (B, H', W', heads, d) contiguous: every head of q
through a depthwise k x k conv (padding k // 2, no bias; the filter
``convs[0]``, (d, 1, k, k), shared by the heads) at ``stride_q``, then a
LayerNorm over d (``norms[0]``: weight, bias; ``eps``); the same for k and
v at ``stride_kv``. H' = ceil(H / stride).

On CUDA tensors it launches ``mvit_pool_kernel`` of ``csrc/mvit_pool.cu``
once for all three (counted in ``launches``; its source note says what
bounds it and how it is laid out). It reads q, k and v in place from the
qkv product by its strides, so no split of the product is copied, and the
conv's f32 sums are normalised in registers, never written to device
memory. The filters and affines are read as their bf16 compute copies
(``cache.compute_copy``), packed once per weight version as f32 for the
kernel. CPU tensors run :func:`mvit_pool_plain`: the depthwise conv over
every head at once (the filter repeated per head) and the LayerNorm, fed the
strided slices of the product. There is no fallback: a CUDA call the kernel
does not take raises ValueError: d other than 64, 72 or 96 (the head widths
of the published MViTv2 models: -H's, -L's, and -T's, -S's and -B's), a
filter other than 3 x 3, a stride other than 1, 2 or 4, a dtype other than
bf16, a layout that is not whole 16-byte vectors, and a call that autograd
would differentiate (serving runs without; training refuses a pyramid
model).

Numerics on the card: bf16 inputs and taps, f32 products and sums in tap
order (ky, kx), the norm's mean and variance in f32 over the unrounded
sums, the affine in f32, one rounding to bf16. The plain version rounds the
conv's output to its dtype before the norm, as PyTorch's conv does.

Replaces no TPU kernel (the JAX package has no MViT); it replaces the copy
that split q, k and v from the product, cuDNN's depthwise convs and
PyTorch's LayerNorm over rows of d.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ..cache import compute_copy, derived

WIDTHS = (64, 72, 96)  # the kernel's head widths
STRIDES = (1, 2, 4)  # the kernel's strides

Pair = Tuple[torch.Tensor, torch.Tensor]


def _per_head(w: torch.Tensor, heads: int, dtype: torch.dtype) -> torch.Tensor:
    """The (d, 1, k, k) filter repeated for every head, in ``dtype``."""
    return derived((w,), ("per_head", heads, dtype), lambda: w.to(dtype).repeat(heads, 1, 1, 1))


def mvit_pool_plain(qkv: torch.Tensor, heads: int, stride_q: int, stride_kv: int,
                    convs: Sequence[torch.Tensor], norms: Sequence[Pair], eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pooling in plain PyTorch, in qkv's dtype: for each of q, k and v
    the depthwise conv over all heads as one conv of C channels on the
    product's strided slice, then the LayerNorm over each head."""
    c = qkv.shape[-1] // 3
    out = []
    for i, (s, w, (g, b)) in enumerate(zip((stride_q, stride_kv, stride_kv), convs, norms)):
        x = qkv[..., i * c:(i + 1) * c]
        y = F.conv2d(x.permute(0, 3, 1, 2), _per_head(w, heads, x.dtype), None, s,
                     w.shape[-1] // 2, 1, c).permute(0, 2, 3, 1)
        y = y.reshape(*y.shape[:3], heads, -1)
        out.append(F.layer_norm(y, y.shape[-1:], compute_copy(g, x.dtype),
                                compute_copy(b, x.dtype), eps))
    return tuple(out)


def _check(qkv, heads, stride_q, stride_kv, convs, norms) -> list:
    """Raise ValueError on shapes neither path takes; returns the operands."""
    if qkv.dim() != 4 or heads <= 0 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"mvit_pool takes a (B, H, W, 3 C) product of {heads} heads, got "
                         f"{tuple(qkv.shape)}")
    d = qkv.shape[-1] // (3 * heads)
    if len(convs) != 3 or len(norms) != 3:
        raise ValueError("mvit_pool takes three filters and three norms: q's, k's, v's")
    for w, (g, b) in zip(convs, norms):
        if w.dim() != 4 or w.shape[:2] != (d, 1) or w.shape[2] != w.shape[3] or not w.shape[2] % 2:
            raise ValueError(f"mvit_pool: a depthwise filter of {d} channels, odd and square, "
                             f"got {tuple(w.shape)}")
        if g.shape != (d,) or b.shape != (d,):
            raise ValueError(f"mvit_pool: norm parameters of {d}, got {tuple(g.shape)} "
                             f"{tuple(b.shape)}")
    if min(stride_q, stride_kv) < 1:
        raise ValueError(f"mvit_pool: strides {stride_q}, {stride_kv}")
    tensors = [qkv, *convs, *(t for pair in norms for t in pair)]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("mvit_pool's operands must be on one device")
    return tensors


def _pack(convs: Sequence[torch.Tensor], norms: Sequence[Pair]) -> torch.Tensor:
    """(3, 11, d) f32 as the kernel reads it: for q, k and v the taps
    (ky * 3 + kx, channel), the norm's weight, its bias; each the bf16
    compute copy's values. Once per version of the nine sources."""
    def make():
        rows = []
        for w, (g, b) in zip(convs, norms):
            rows += [compute_copy(w, torch.bfloat16).float().reshape(-1, 9).t(),
                     compute_copy(g, torch.bfloat16).float()[None],
                     compute_copy(b, torch.bfloat16).float()[None]]
        return torch.cat(rows).reshape(3, 11, -1).contiguous()

    return derived((*convs, *(t for pair in norms for t in pair)), "mvit_pool", make)


def mvit_pool(qkv: torch.Tensor, heads: int, stride_q: int, stride_kv: int,
              convs: Sequence[torch.Tensor], norms: Sequence[Pair], eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W, 3 C) qkv product -> pooled (q, k, v), each (B, H', W',
    heads, d) in qkv's dtype. A CUDA tensor launches ``mvit_pool_kernel``
    once (``launches``); a CPU tensor runs :func:`mvit_pool_plain`.
    ValueError on shapes either path refuses, and on CUDA on what the kernel
    does not take (the module's docstring)."""
    tensors = _check(qkv, heads, stride_q, stride_kv, convs, norms)
    if qkv.device.type == "cpu":
        return mvit_pool_plain(qkv, heads, stride_q, stride_kv, convs, norms, eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("mvit_pool has no backward on the card: call it under "
                         "torch.no_grad() (serving)")
    b, hh, ww, c3 = qkv.shape
    d = c3 // (3 * heads)
    if (qkv.dtype != torch.bfloat16 or d not in WIDTHS or any(w.shape[-1] != 3 for w in convs)
            or stride_q not in STRIDES or stride_kv not in STRIDES):
        raise ValueError(f"mvit_pool's kernel takes bf16 heads of {WIDTHS}, 3 x 3 filters and "
                         f"strides {STRIDES}, got {qkv.dtype} d={d} filters "
                         f"{[tuple(w.shape[-2:]) for w in convs]} strides {stride_q}, {stride_kv}")
    sb, sh, sw, sc = qkv.stride()
    if sc != 1 or any(s % 8 for s in (sb, sh, sw)) or qkv.data_ptr() % 16:
        raise ValueError(f"mvit_pool's kernel reads whole 16-byte vectors: channels at unit "
                         f"stride, other strides multiples of 8 elements, a 16-byte-aligned "
                         f"start; got strides {qkv.stride()}")
    if max(sb, sh, sw) >= 2 ** 31:
        raise ValueError(f"mvit_pool's kernel takes strides below 2^31, got {qkv.stride()}")
    out = []
    for s in (stride_q, stride_kv, stride_kv):
        out.append(torch.empty((b, -(-hh // s), -(-ww // s), heads, d), dtype=torch.bfloat16,
                               device=qkv.device))
    params = _pack(convs, norms)
    lib = _build.load("mvit_pool")
    code = lib.mvit_pool(
        qkv.data_ptr(), b, hh, ww, sb, sh, sw, heads, d, stride_q, stride_kv, params.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), eps,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(lib, "mvit_pool", code)
    mvit_pool.launches += 1
    return tuple(out)


mvit_pool.launches = 0
