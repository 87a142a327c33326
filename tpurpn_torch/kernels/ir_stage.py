"""Fused inverted-residual stage: MobileNetV2 blocks 7-12 + block_13_expand
(port of ``tpurpn/kernels/ir_stage_pallas.py``).

``fused_ir_stage`` on a CUDA tensor launches the hand-written kernel in
``csrc/ir_stage.cu`` (its source note says what bounds it and how it is
laid out); on a CPU tensor it runs ``fused_ir_stage_plain``, the same
function in plain PyTorch. There is no fallback: a CUDA tensor the kernel
does not take raises.

The kernel copies its weights chunk by chunk as images of its shared
memory (``kernel_pack``: K-major bf16, 64-byte swizzle), made once per set
of weight tensors (``kernel_pack_cached``); ``stage_weights_cached`` keeps
``pack_stage_weights``' output until a conv's weight or bias changes.

Numerics, as ``tpurpn``'s kernel: bf16 1x1-conv operands with f32
accumulation, bias and ReLU6 in f32, the depthwise in f32 over the f32
expanded activation, bf16 rounding after the depthwise ReLU6 and after the
project bias, a bf16 residual add. Agreement with the folded flax forward is
at bf16 tolerance (tests/test_torch_kernels.py).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

# Static description of one fused block:
#   (c_in, c_exp, c_out, residual)  — a full inverted residual, or
#   (c_in, c_exp, None, False)      — expand-only tail (block_13_expand).
BlockSpec = Tuple[int, int, "int | None", bool]


def pack_stage_weights(
    bb, block_names: Sequence[str], tail_expand: str | None = None
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[BlockSpec, ...]]:
    """Flatten a folded-BN backbone's blocks (+ optional expand-only tail)
    into the kernel's operands: per block we (c_in, c_exp) bf16, be (c_exp,)
    f32, kdw (9, c_exp) f32 with tap ky*3+kx, bdw f32, wp (c_exp, c_out)
    bf16, bp f32 — the layout of ``tpurpn``'s ``pack_stage_weights``.

    ``bb`` is the backbone module after ``model.fold_batch_norm``.
    """
    weights: List[torch.Tensor] = []
    blocks: List[BlockSpec] = []

    def as2d(conv):  # (Cout, Cin, 1, 1) -> (Cin, Cout)
        w = conv.weight
        return w.reshape(w.shape[0], w.shape[1]).t().contiguous()

    def f32(t):
        return t.detach().float().contiguous()

    with torch.no_grad():
        for name in block_names:
            blk = bb.get_submodule(name)
            ex = blk.get_submodule(f"{name}_expand")
            dw = blk.get_submodule(f"{name}_depthwise")
            pj = blk.get_submodule(f"{name}_project")
            we, wp = as2d(ex), as2d(pj)
            c_exp = dw.weight.shape[0]
            kdw = dw.weight.reshape(c_exp, 9).t()
            weights += [
                we.to(torch.bfloat16), f32(ex.bias), f32(kdw), f32(dw.bias),
                wp.to(torch.bfloat16), f32(pj.bias),
            ]
            blocks.append((we.shape[0], c_exp, wp.shape[1], we.shape[0] == wp.shape[1]))
        if tail_expand is not None:
            te = bb.get_submodule(tail_expand)
            we = as2d(te)
            weights += [we.to(torch.bfloat16), f32(te.bias)]
            blocks.append((we.shape[0], we.shape[1], None, False))
    return tuple(weights), tuple(blocks)


def _relu6(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, 0.0, 6.0)


def fused_ir_stage_plain(
    x: torch.Tensor, weights: Tuple[torch.Tensor, ...], blocks: Tuple[BlockSpec, ...]
) -> torch.Tensor:
    """The stage in plain PyTorch: (B, S, S, c_in) bf16 -> (B, S, S, c_last) bf16.

    The 1x1 convs are f32 products of the bf16 operands (exact in f32) with
    f32 sums; the depthwise sums its 9 taps in the TPU kernel's order.
    """
    B, S, _, _ = x.shape
    wi = 0
    for c_in, c_exp, c_out, residual in blocks:
        we, be = weights[wi], weights[wi + 1]
        wi += 2
        h = _relu6(x.float() @ we.float() + be)
        if c_out is None:  # expand-only tail
            x = h.to(torch.bfloat16)
            continue
        kdw, bdw, wp, bp = weights[wi : wi + 4]
        wi += 4
        hp = F.pad(h, (0, 0, 1, 1, 1, 1))  # SAME zero padding of H and W
        acc = torch.zeros_like(h)
        for dy in range(3):
            for dx in range(3):
                acc = acc + hp[:, dy : dy + S, dx : dx + S, :] * kdw[dy * 3 + dx]
        h2 = _relu6(acc + bdw).to(torch.bfloat16)
        y = (h2.float() @ wp.float() + bp).to(torch.bfloat16)
        x = (x + y) if residual else y
    return x


# Chunk widths of csrc/ir_stage.cu: expand channels a chunk of a full block,
# output channels a chunk of the expand-only tail. The kernel's entries take
# the width and the pack's size and refuse a pack made for other constants.
CH = 64
TAIL_NC = 64


@functools.lru_cache(maxsize=None)
def _sw64_index(rows: int, k: int) -> torch.Tensor:
    """Destination (in bf16 elements) of each (row, k) of a K-major (rows, k)
    bf16 matrix in the kernel's layout: k/32 planes of (rows, 32), the 16-byte
    piece q of row r at q ^ ((r >> 1) & 3) (the wgmma 64-byte swizzle)."""
    if rows % 8 or k % 32:
        raise ValueError(f"swizzled operand needs rows % 8 == 0 and k % 32 == 0: {rows=} {k=}")
    r = torch.arange(rows)[:, None]
    c = torch.arange(k)[None, :]
    return ((c // 32) * rows * 32 + r * 32 + (((c % 32) // 8) ^ ((r >> 1) & 3)) * 8
            + c % 8).reshape(-1)


def _swizzle(m: torch.Tensor) -> torch.Tensor:
    """(n, rows, k) -> (n, rows * k): each matrix in the layout of ``_sw64_index``."""
    n, rows, k = m.shape
    out = torch.empty((n, rows * k), dtype=m.dtype, device=m.device)
    out[:, _sw64_index(rows, k).to(m.device)] = m.reshape(n, -1)
    return out


def _chunk_width(c_exp: int, c_out) -> int:
    width = TAIL_NC if c_out is None else CH
    if c_exp % width:
        raise ValueError(f"c_exp {c_exp} is not a multiple of the chunk width {width}")
    return width


def kernel_pack(
    weights: Tuple[torch.Tensor, ...], blocks: Tuple[BlockSpec, ...]
) -> Tuple[torch.Tensor, ...]:
    """``pack_stage_weights``' output -> one flat bf16 tensor a block, in the
    order and layout the kernel copies into shared memory: for each chunk of
    w expanded channels, the expand weights (w, c_in) and, for a full block,
    the project weights (c_out, w), both K-major and swizzled
    (``_sw64_index``). Each chunk is one contiguous bulk copy."""
    packs = []
    wi = 0
    for c_in, c_exp, c_out, _ in blocks:
        w = _chunk_width(c_exp, c_out)
        n = c_exp // w
        parts = [_swizzle(weights[wi].t().reshape(n, w, c_in))]
        if c_out is not None:
            parts.append(_swizzle(weights[wi + 4].reshape(n, w, c_out).transpose(1, 2)))
        wi += 2 if c_out is None else 6
        packs.append(torch.cat(parts, 1).reshape(-1))
    return tuple(packs)


class _VersionCache:
    """Results keyed on the identity, ``_version`` and storage address of
    their source tensors: an in-place update of a source (``copy_``, an
    optimizer step) bumps its version, and a new storage (``p.data = t``)
    moves its address, so neither serves a stale result. A write into a
    source's ``.data`` in place (``p.data.copy_(t)``) bumps neither and is
    not seen. Inference tensors keep no version, so results of them are
    computed afresh on every call; results of other tensors are computed
    outside inference mode, so that they can key this cache in turn. Holds
    the sources, so an id is never reused while its entry lives; keeps the
    newest SIZE."""

    SIZE = 4

    def __init__(self):
        self.entries: list = []  # (sources, key, value), newest last

    def get(self, sources: Sequence[torch.Tensor], make):
        if any(t.is_inference() for t in sources):
            return make()
        key = tuple((t._version, t.data_ptr()) for t in sources)
        for i, (src, k, value) in enumerate(self.entries):
            if k == key and len(src) == len(sources) and all(
                    a is b for a, b in zip(src, sources)):
                self.entries.append(self.entries.pop(i))
                return value
        with torch.inference_mode(False):
            value = make()
        self.entries = (self.entries + [(tuple(sources), key, value)])[-self.SIZE:]
        return value


_packs = _VersionCache()


def kernel_pack_cached(weights, blocks) -> Tuple[torch.Tensor, ...]:
    """:func:`kernel_pack`, computed once per set of weight tensors and
    their versions (see ``_VersionCache`` for what it sees)."""
    return _packs.get(weights, lambda: kernel_pack(weights, blocks))


_stages = _VersionCache()


def stage_weights_cached(
    bb, block_names: Sequence[str], tail_expand: str | None = None
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[BlockSpec, ...]]:
    """:func:`pack_stage_weights`, recomputed only when one of the convs'
    weights or biases is replaced or updated in place (identity, ``_version``,
    storage; see ``_VersionCache`` for what it does not see)."""
    names = [f"{n}.{n}_{part}" for n in block_names
             for part in ("expand", "depthwise", "project")]
    names += [tail_expand] if tail_expand is not None else []
    sources = [t for n in names for t in (bb.get_submodule(n).weight, bb.get_submodule(n).bias)]
    return _stages.get(sources, lambda: pack_stage_weights(bb, block_names, tail_expand))


def _launch(x: torch.Tensor, weights, blocks) -> torch.Tensor:
    if (x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[1] != x.shape[2]
            or x.shape[3] != blocks[0][0]):
        raise ValueError(f"fused_ir_stage takes (B, S, S, {blocks[0][0]}) bf16, "
                         f"got {x.dtype} {tuple(x.shape)}")
    B, S, _, _ = x.shape
    if S > 32:
        raise ValueError(f"fused_ir_stage takes S <= 32, got {S}")
    for w in weights:
        if w.device != x.device or not w.is_contiguous():
            raise ValueError("fused_ir_stage weights must be contiguous, on x's device")
    lib = _build.load("ir_stage")
    packs = kernel_pack_cached(weights, blocks)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    x = x.contiguous()
    wi = 0
    for (c_in, c_exp, c_out, residual), pack in zip(blocks, packs):
        be = weights[wi + 1]
        if c_out is None:
            wi += 2
            out = torch.empty((B, S, S, c_exp), dtype=torch.bfloat16, device=x.device)
            code = lib.ir_expand(x.data_ptr(), out.data_ptr(), pack.data_ptr(), pack.numel(),
                                 TAIL_NC, be.data_ptr(), B, S, c_in, c_exp, stream)
        else:
            kdw, bdw, bp = weights[wi + 2], weights[wi + 3], weights[wi + 5]
            wi += 6
            out = torch.empty((B, S, S, c_out), dtype=torch.bfloat16, device=x.device)
            code = lib.ir_block(x.data_ptr(), out.data_ptr(), pack.data_ptr(), pack.numel(),
                                CH, be.data_ptr(), kdw.data_ptr(), bdw.data_ptr(),
                                bp.data_ptr(), B, S, c_in, c_out, int(residual), stream)
        _build.check(lib, "ir_stage", code)
        fused_ir_stage.launches += 1
        x = out
    return x


def fused_ir_stage(
    x: torch.Tensor, weights: Tuple[torch.Tensor, ...], blocks: Tuple[BlockSpec, ...]
) -> torch.Tensor:
    """Run ``blocks`` fused over ``x`` (B, S, S, c_in0) bf16.

    A CUDA tensor goes to the kernel: one ``ir_block`` launch per block plus
    one ``ir_expand`` for the tail, each counted in ``launches`` (7 for the
    MobileNetV2 stage). A CPU tensor goes to :func:`fused_ir_stage_plain`.
    """
    if x.device.type == "cpu":
        return fused_ir_stage_plain(x, weights, blocks)
    return _launch(x, weights, blocks)


fused_ir_stage.launches = 0
