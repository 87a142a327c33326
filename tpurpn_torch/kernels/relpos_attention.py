"""ViTDet's attention core with decomposed relative positions as one
hand-written kernel.

``relpos_attention(q, k, v, rel_pos_h, rel_pos_w, side)`` computes, for q,
k, v of shape (N, h, T = side^2, d) over a side x side token grid,

    softmax(q k^T / sqrt(d) + rel_h[q, k_row] + rel_w[q, k_col]) v,
    rel_h[q, k] = q . R_h[i - k + side - 1],  rel_w[q, l] = q . R_w[j - l + side - 1]

(query (i, j), key (k, l); the unscaled q; R = ``rel_pos_*`` in q's dtype)
and returns (N, h, T, d). On CUDA tensors it launches
``relpos_attention_kernel`` of ``csrc/relpos_attention.cu`` once (counted
in ``launches``; its source note says what bounds it and how it is laid
out): the bias is made and added inside the kernel and never reaches device
memory. q, k and v are read in place by their strides, so the views of one
qkv product's (N, T, 3, h, d) output cost no copy, and the result is a view
of an (N, T, h, d) tensor, so that ``.permute(0, 2, 1, 3).reshape(N, T,
h * d)`` is a view too. CPU tensors run :func:`relpos_attention_plain`, the
same function in plain PyTorch in f32. There is no fallback: a CUDA call
the kernel does not take raises, and so does one that autograd would need
a gradient of (serving runs without; training refuses a pyramid model).

The kernel takes bf16 q, k, v with d = 64 (ViTDet-B's heads); a narrower
head is zero-padded to 64 (a copy), which changes no score and no output
column. Sides 1-64 (64: the global blocks at 1024 px; 14: the windows).
Numerics: f32 scores, bias, softmax and sums, the tables rounded
to bf16 as q's dtype rounds them here, P rounded to bf16 for the product
with V, bf16 output.

Replaces no TPU kernel (the JAX package has no ViT); it replaces the bias
written to device memory by one product with a 0/1 expansion matrix
(``backbones.vit.expansion``) and cuDNN's SDPA reading it back.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build
from ..cache import compute_copy

D = 64  # the kernel's head width
_LOG2E = 1.4426950408889634


def _rel_index(side: int, device) -> "tuple[torch.Tensor, torch.Tensor]":
    """((T, side) table rows of rel_h, the same of rel_w): for query q =
    (i, j) and key row / column k, i - k + side - 1 and j - k + side - 1."""
    t = torch.arange(side * side, device=device)
    k = torch.arange(side, device=device)
    return ((t // side)[:, None] - k + side - 1, (t % side)[:, None] - k + side - 1)


def relpos_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                           side: int) -> torch.Tensor:
    """The core in plain PyTorch, in f32 from q, k, v and the tables in q's
    dtype: E = q R^T, the bias E_h[q, i - k_row + s - 1] + E_w[q, j - k_col +
    s - 1], scores q k^T / sqrt(d) + bias, softmax, times v; the result in
    q's dtype. Works through the images in chunks of at most 2^26 scores."""
    n, h, t, d = q.shape
    rh = compute_copy(rel_pos_h, q.dtype).float()
    rw = compute_copy(rel_pos_w, q.dtype).float()
    ih, iw = _rel_index(side, q.device)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    step = max(1, (1 << 26) // (h * t * t))
    for a in range(0, n, step):
        qf, kf, vf = (x[a:a + step].float() for x in (q, k, v))
        b = qf.shape[0]
        rel_h = torch.gather(qf @ rh.t(), 3, ih.expand(b, h, t, side))  # (b, h, t, side)
        rel_w = torch.gather(qf @ rw.t(), 3, iw.expand(b, h, t, side))
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(b, h, t, t)
        scores = qf @ kf.transpose(-2, -1) / math.sqrt(d) + bias
        out[a:a + step] = (scores.softmax(-1) @ vf).to(q.dtype)
    return out


def _check(q, k, v, rel_pos_h, rel_pos_w, side) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"relpos_attention takes q, k, v of one (N, h, T, d) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    n, h, t, d = q.shape
    if side <= 0 or t != side * side:
        raise ValueError(f"relpos_attention: T = {t} tokens is not a {side} x {side} grid")
    for name, r in (("rel_pos_h", rel_pos_h), ("rel_pos_w", rel_pos_w)):
        if r.shape != (2 * side - 1, d):
            raise ValueError(f"relpos_attention: {name} {tuple(r.shape)}, expected "
                             f"{(2 * side - 1, d)}")
    if len({x.device for x in (q, k, v, rel_pos_h, rel_pos_w)}) != 1:
        raise ValueError("relpos_attention's operands must be on one device")
    if len({x.dtype for x in (q, k, v)}) != 1:
        raise ValueError("relpos_attention takes q, k and v of one dtype")


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """x (N, h, T, 64) bf16 as the kernel reads it: unit stride along d,
    16-byte-aligned start and strides (a copy only where it is not)."""
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        x = x.contiguous()
    return x


def relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                     side: int) -> torch.Tensor:
    """(N, h, side^2, d) q, k, v and (2 side - 1, d) tables -> (N, h,
    side^2, d) in q's dtype. A CUDA tensor launches
    ``relpos_attention_kernel`` once (``launches``); a CPU tensor runs
    :func:`relpos_attention_plain`. ValueError on shapes either path
    refuses; on CUDA also on a dtype other than bf16, d > 64, a side over
    64, and a call that autograd would differentiate."""
    _check(q, k, v, rel_pos_h, rel_pos_w, side)
    if q.device.type == "cpu":
        return relpos_attention_plain(q, k, v, rel_pos_h, rel_pos_w, side)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v, rel_pos_h, rel_pos_w)):
        raise ValueError("relpos_attention has no backward on the card: call it under "
                         "torch.no_grad() (serving)")
    n, h, t, d = q.shape
    if q.dtype != torch.bfloat16 or d > D or side > 64:
        raise ValueError(f"relpos_attention's kernel takes bf16 heads of at most {D} on a side "
                         f"of at most 64, got {q.dtype} d={d} side={side}")
    tables = [r.detach().float().contiguous() for r in (rel_pos_h, rel_pos_w)]
    if d < D:  # zero columns change no product
        q, k, v = (F.pad(x, (0, D - d)) for x in (q, k, v))
        tables = [F.pad(r, (0, D - d)) for r in tables]
    q, k, v = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    if not (q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    st, sh, sn = q.stride(2), q.stride(1), q.stride(0)
    if max(st, sh, sn) >= 2 ** 31:
        raise ValueError(f"relpos_attention's kernel takes strides below 2^31, got {q.stride()}")
    out = torch.empty((n, t, h, D), dtype=torch.bfloat16, device=q.device)
    lib = _build.load("relpos_attention")
    code = lib.relpos_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), tables[0].data_ptr(),
        tables[1].data_ptr(), n, h, side, st, sh, sn, _LOG2E / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "relpos_attention", code)
    relpos_attention.launches += 1
    return out[..., :d].permute(0, 2, 1, 3)


relpos_attention.launches = 0
