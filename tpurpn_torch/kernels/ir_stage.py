"""Fused inverted-residual stage: stride-1 MobileNetV2 blocks plus an
optional expand-only tail (port of ``tpurpn/kernels/ir_stage_pallas.py``).

``fused_ir_stage`` on a CUDA tensor launches the hand-written kernel in
``csrc/ir_stage.cu`` (its source note says what bounds it and how it is
laid out); on a CPU tensor it runs ``fused_ir_stage_plain``, the same
function in plain PyTorch. There is no fallback: a CUDA tensor the kernel
does not take raises.

Domain, on both devices: any S >= 1, and the stride-1 block specs that
``pack_stage_weights`` builds from the backbone up to the RPN tap
(``BLOCK_SPECS``: block_2, blocks 4-5, 7-9, 10, 11-12) with expand-only
tails at each of their input widths (``TAIL_SPECS``: 24, 32, 64, 96, as
block_13_expand or a block's expand conv); serving runs blocks 7-12 +
block_13_expand (S = 32 at 500 px, 40 at 640). Blocks 14-16 lie past the
tap and are never built. ``dw_input_bf16`` and ``c_exp_split`` are
``tpurpn``'s options (``fused_ir_stage``). ``c_exp_split`` only bounds the
TPU's VMEM: the plain version sums its f32 group partials as ``tpurpn``
does, and the kernel takes any split ``tpurpn`` takes and computes it in
one f32 accumulation (another f32 summation order, far below bf16).

A full block's kernel tiles the image as :func:`ir_block_plan` says, the
one place that decides it from S alone: one strip of S columns at S <= 32
(the 500 px serving stage), flat runs of consecutive pixels at the S > 32
where they take fewer thread blocks an image than column strips (S = 40,
47 and 63 of the 640, 750 and 1000 px serving taps), and column strips
beyond (block_2 at S = 125 and 160). A pixel's result does not depend on
the tiling, bit for bit.

The kernel copies its weights chunk by chunk as images of its shared
memory (``kernel_pack``: K-major bf16, 64-byte swizzle, zero-padded to the
kernel's widths), made once per set of weight tensors
(``kernel_pack_cached``); ``stage_weights_cached`` keeps
``pack_stage_weights``' output until a conv's weight or bias changes.

Numerics, as ``tpurpn``'s kernel: bf16 1x1-conv operands with f32
accumulation, bias and ReLU6 in f32, the depthwise in f32 over the f32
expanded activation (or, with ``dw_input_bf16``, bf16 products of the
bf16-rounded activation and taps summed in f32), bf16 rounding after the
depthwise ReLU6 and after the project bias, a bf16 residual add. Agreement
with the folded flax forward and with ``tpurpn``'s kernel is at bf16
tolerance (tests/test_torch_kernels.py).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ..boxes import _round_up

# Static description of one fused block:
#   (c_in, c_exp, c_out, residual)  — a full inverted residual, or
#   (c_in, c_exp, None, False)      — expand-only tail (block_13_expand).
BlockSpec = Tuple[int, int, "int | None", bool]


def _tail_conv(bb, name: str) -> torch.nn.Conv2d:
    """The expand-only tail ``name``: a conv (block_13_expand), or a block
    whose expand conv then serves as the tail (block_2 -> block_2_expand)."""
    m = bb.get_submodule(name)
    return m if isinstance(m, torch.nn.Conv2d) else m.get_submodule(f"{name}_expand")


def pack_stage_weights(
    bb, block_names: Sequence[str], tail_expand: str | None = None
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[BlockSpec, ...]]:
    """Flatten a folded-BN backbone's blocks (+ optional expand-only tail)
    into the kernel's operands: per block we (c_in, c_exp) bf16, be (c_exp,)
    f32, kdw (9, c_exp) f32 with tap ky*3+kx, bdw f32, wp (c_exp, c_out)
    bf16, bp f32 — the layout of ``tpurpn``'s ``pack_stage_weights``.

    ``bb`` is the backbone module after ``model.fold_batch_norm``.
    ``tail_expand`` names block_13_expand, as in ``tpurpn``, or a block whose
    expand conv is then the tail (the tails at c_in 24, 32 and 64).
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
            te = _tail_conv(bb, tail_expand)
            we = as2d(te)
            weights += [we.to(torch.bfloat16), f32(te.bias)]
            blocks.append((we.shape[0], we.shape[1], None, False))
    return tuple(weights), tuple(blocks)


# The blocks the stage takes: the stride-1 inverted residuals (c_in, c_exp,
# c_out, residual) of MobileNetV2 up to the RPN tap, and expand-only tails
# (c_in, c_exp, None, False) at their input widths.
BLOCK_SPECS = ((24, 144, 24, True), (32, 192, 32, True), (64, 384, 64, True),
               (64, 384, 96, False), (96, 576, 96, True))
TAIL_SPECS = tuple((c, 6 * c, None, False) for c in (24, 32, 64, 96))


def check_stage(blocks: Tuple[BlockSpec, ...], c_exp_split: int = 1) -> None:
    """Raise ValueError unless ``blocks`` and ``c_exp_split`` are in the
    stage's domain: every block in BLOCK_SPECS or TAIL_SPECS, each taking
    the channels the one before gives; ``c_exp_split`` dividing every full
    block's c_exp, those blocks of one (c_exp, c_out) when it is above 1
    (``tpurpn``'s asserts)."""
    if not blocks:
        raise ValueError("fused_ir_stage needs at least one block")
    c = blocks[0][0]
    for spec in blocks:
        if tuple(spec) not in BLOCK_SPECS + TAIL_SPECS:
            raise ValueError(f"fused_ir_stage takes the blocks {BLOCK_SPECS} and the "
                             f"expand-only tails {TAIL_SPECS}, got {tuple(spec)}")
        if spec[0] != c:
            raise ValueError(f"block {tuple(spec)} takes {spec[0]} channels, "
                             f"the block before gives {c}")
        c = spec[1] if spec[2] is None else spec[2]
    if not isinstance(c_exp_split, int) or c_exp_split < 1:
        raise ValueError(f"c_exp_split must be a positive int, got {c_exp_split!r}")
    full = {(c_exp, c_out) for _, c_exp, c_out, _ in blocks if c_out is not None}
    for c_exp, _ in full:
        if c_exp % c_exp_split:
            raise ValueError(f"c_exp_split {c_exp_split} does not divide c_exp {c_exp}")
    if c_exp_split > 1 and len(full) != 1:
        raise ValueError("c_exp_split > 1 needs one (c_exp, c_out) over the full "
                         f"blocks, got {sorted(full)}")


def _relu6(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, 0.0, 6.0)


def _bf16(v: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to bf16, kept in f32."""
    return v.to(torch.bfloat16).float()


def fused_ir_stage_plain(
    x: torch.Tensor, weights: Tuple[torch.Tensor, ...], blocks: Tuple[BlockSpec, ...],
    dw_input_bf16: bool = False, c_exp_split: int = 1,
) -> torch.Tensor:
    """The stage in plain PyTorch: (B, S, S, c_in) bf16 -> (B, S, S, c_last) bf16.

    The 1x1 convs are f32 products of the bf16 operands (exact in f32) with
    f32 sums; the depthwise sums its 9 taps in the TPU kernel's order. A full
    block runs expand -> depthwise -> partial projection for each of
    ``c_exp_split`` groups of expanded channels and sums the f32 partials,
    as ``tpurpn``'s kernel does. ``dw_input_bf16`` rounds the expanded
    activation and the taps to bf16 and each tap product to bf16 before the
    f32 sum.
    """
    B, S, _, _ = x.shape
    wi = 0
    for c_in, c_exp, c_out, residual in blocks:
        we, be = weights[wi], weights[wi + 1]
        wi += 2
        if c_out is None:  # expand-only tail
            x = _relu6(x.float() @ we.float() + be).to(torch.bfloat16)
            continue
        kdw, bdw, wp, bp = weights[wi : wi + 4]
        wi += 4
        cw = c_exp // c_exp_split
        y = torch.zeros((B, S, S, c_out), dtype=torch.float32, device=x.device)
        for g in range(c_exp_split):
            sl = slice(g * cw, (g + 1) * cw)
            h = _relu6(x.float() @ we[:, sl].float() + be[sl])
            taps = kdw[:, sl]
            if dw_input_bf16:
                h, taps = _bf16(h), _bf16(taps)
            hp = F.pad(h, (0, 0, 1, 1, 1, 1))  # SAME zero padding of H and W
            acc = torch.zeros_like(h)
            for dy in range(3):
                for dx in range(3):
                    term = hp[:, dy : dy + S, dx : dx + S, :] * taps[dy * 3 + dx]
                    acc = acc + (_bf16(term) if dw_input_bf16 else term)
            h2 = _relu6(acc + bdw[sl]).to(torch.bfloat16)
            y = y + h2.float() @ wp[sl].float()
        y = (y + bp).to(torch.bfloat16)
        x = (x + y) if residual else y
    return x


# Chunk widths of csrc/ir_stage.cu: expand channels a chunk of a full block,
# output channels a chunk of the expand-only tail. The kernel's entries take
# the width and the pack's size and refuse a pack made for other constants.
CH = 64
TAIL_NC = 64

# The full-block kernel's tile: R output rows of 32 pixel slots (strips of at
# most 30 outputs beside their halo columns at S > 32), or TILE halo'd
# pixels in a flat run whose outputs are at most UNITS units of 8 columns of
# one image row; ir_block refuses a tiling that does not fit them.
R, KCOLS, KSTRIP, TILE, UNITS = 8, 32, 30, 320, 32


class BlockPlan(NamedTuple):
    """How the full-block kernel tiles an S x S image (:func:`ir_block_plan`).

    ``tiling`` is ``"strips"`` (``strips`` column strips of ``width`` output
    columns and R rows a thread block; one strip of S columns at S <= 32) or
    ``"flat"`` (``width`` consecutive pixels a thread block in row-major
    order, staged with one image row and one pixel on each side; ``strips``
    is 0). ``blocks`` is the thread blocks an image."""

    tiling: str
    blocks: int
    strips: int
    width: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def strip_plan(S: int) -> BlockPlan:
    """Column strips of an S x S image: one strip of S columns up to KCOLS,
    else the fewest strips of at most KSTRIP columns, balanced (S = 40: two
    of 20), R rows a thread block."""
    if S < 1:
        raise ValueError(f"the IR stage takes S >= 1, got {S}")
    strips = 1 if S <= KCOLS else _cdiv(S, KSTRIP)
    width = _cdiv(S, strips)
    strips = _cdiv(S, width)
    return BlockPlan("strips", _cdiv(S, R) * strips, strips, width)


def flat_units(S: int, n: int, f0: int) -> Tuple[int, int]:
    """(image rows, units) of the flat run of n pixels from f0 in an S x S
    image: the units (8 columns of one image row) of its first row from its
    first column, of each whole row, and of its last row up to its last
    column. The kernel takes runs over 3 rows or more, of at most UNITS
    units."""
    last = min(f0 + n, S * S) - 1
    rows = last // S - f0 // S + 1
    return rows, _cdiv(S - f0 % S, 8) + (rows - 2) * _cdiv(S, 8) + _cdiv(last % S + 1, 8)


def flat_plan(S: int) -> "BlockPlan | None":
    """Flat runs over an S x S image at S > KCOLS: the fewest thread blocks
    whose runs of n = ceil(S^2 / blocks) pixels, with one image row and one
    pixel on each side, fit the TILE (n + 2 (S + 1) <= TILE) and each span 3
    image rows or more in at most UNITS units (S = 40: 7 runs of 229); None
    where no run fits or S <= KCOLS."""
    n_max = TILE - 2 * (S + 1)
    if S <= KCOLS or n_max < 1:
        return None
    for blocks in range(_cdiv(S * S, n_max), S * S + 1):
        n = _cdiv(S * S, blocks)
        shape = [flat_units(S, n, f0) for f0 in range(0, S * S, n)]
        if all(rows >= 3 and units <= UNITS for rows, units in shape):
            return BlockPlan("flat", blocks, 0, n)
        if n <= 2 * S:  # the first run, from column 0, spans 2 rows or fewer
            return None
    return None


def ir_block_plan(S: int) -> BlockPlan:
    """The full-block kernel's tiling of an S x S image, the one place it is
    decided: the tiling of fewer thread blocks an image, strips on a tie. So
    one strip at S <= 32 (the 500 px serving instance), flat runs at S =
    33-52 and 61-68 (the 640, 750 and 1000 px serving taps, S = 40, 47, 63,
    among them), strips elsewhere (S = 80 and up, block_2 at 125 and
    160)."""
    strips, flat = strip_plan(S), flat_plan(S)
    return flat if flat is not None and flat.blocks < strips.blocks else strips


def kernel_widths(spec: BlockSpec) -> Tuple[int, int]:
    """(input channels, expanded channels) of ``spec`` as the kernel holds
    them: c_in up to whole 32-channel planes (24 -> 32), c_exp up to whole
    chunks (144 -> 192). The pack's padding is zero, which is exact: a zero
    channel adds nothing to a 1x1 sum, and a zero expanded channel (zero
    weights, bias and taps) stays 0 through ReLU6 and the depthwise."""
    c_in, c_exp, c_out, _ = spec
    return _round_up(c_in, 32), _round_up(c_exp, TAIL_NC if c_out is None else CH)


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


def kernel_pack(
    weights: Tuple[torch.Tensor, ...], blocks: Tuple[BlockSpec, ...]
) -> Tuple[torch.Tensor, ...]:
    """``pack_stage_weights``' output -> one flat bf16 tensor a block, in the
    order and layout the kernel copies into shared memory: for each chunk of
    w expanded channels, the expand weights (w, c_in) and, for a full block,
    the project weights (c_out, w), both K-major and swizzled
    (``_sw64_index``), zero-padded to ``kernel_widths``. Each chunk is one
    contiguous bulk copy."""
    packs = []
    wi = 0
    for spec in blocks:
        c_in, c_exp, c_out, _ = spec
        k_in, n_exp = kernel_widths(spec)
        w = TAIL_NC if c_out is None else CH
        n = n_exp // w
        we = F.pad(weights[wi].t(), (0, k_in - c_in, 0, n_exp - c_exp))  # (n_exp, k_in)
        parts = [_swizzle(we.reshape(n, w, k_in))]
        if c_out is not None:
            wp = F.pad(weights[wi + 4], (0, 0, 0, n_exp - c_exp))  # (n_exp, c_out)
            parts.append(_swizzle(wp.reshape(n, w, c_out).transpose(1, 2)))
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
    convs = [bb.get_submodule(n) for n in names]
    convs += [_tail_conv(bb, tail_expand)] if tail_expand is not None else []
    sources = [t for m in convs for t in (m.weight, m.bias)]
    return _stages.get(sources, lambda: pack_stage_weights(bb, block_names, tail_expand))


def _launch(x: torch.Tensor, weights, blocks, dw_input_bf16: bool) -> torch.Tensor:
    if (x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[1] != x.shape[2]
            or x.shape[3] != blocks[0][0] or x.shape[0] < 1 or x.shape[1] < 1):
        raise ValueError(f"fused_ir_stage takes (B, S, S, {blocks[0][0]}) bf16, "
                         f"got {x.dtype} {tuple(x.shape)}")
    B, S, _, _ = x.shape
    for w in weights:
        if w.device != x.device or not w.is_contiguous():
            raise ValueError("fused_ir_stage weights must be contiguous, on x's device")
    lib = _build.load("ir_stage")
    packs = kernel_pack_cached(weights, blocks)
    plan = ir_block_plan(S)
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
                                bp.data_ptr(), B, S, plan.strips, plan.width, c_in, c_exp,
                                c_out, int(residual), int(dw_input_bf16), stream)
        _build.check(lib, "ir_stage", code)
        fused_ir_stage.launches += 1
        x = out
    return x


def fused_ir_stage(
    x: torch.Tensor, weights: Tuple[torch.Tensor, ...], blocks: Tuple[BlockSpec, ...],
    dw_input_bf16: bool = False, c_exp_split: int = 1,
) -> torch.Tensor:
    """Run ``blocks`` fused over ``x`` (B, S, S, c_in0) bf16, any S >= 1.

    ``tpurpn``'s arguments but ``interpret`` and ``vmem_limit_mb``, which
    steer the TPU's compiler and mean nothing on the card. ``blocks`` and
    ``c_exp_split`` must pass :func:`check_stage` (ValueError otherwise, on
    either device). A CUDA tensor goes to the kernel: one ``ir_block``
    launch per block plus one ``ir_expand`` for the tail, each counted in
    ``launches`` (7 for the MobileNetV2 serving stage); the kernel sums the
    whole projection in one f32 accumulation, whatever ``c_exp_split``. The
    full blocks take the tiling of :func:`ir_block_plan` (S alone decides
    it: one strip at S <= 32, flat runs at S = 40, 47 and 63, column strips
    at S = 80 and up; a pixel's result is the same bits under any tiling).
    A CPU tensor goes to :func:`fused_ir_stage_plain`.
    """
    check_stage(blocks, c_exp_split)
    if x.device.type == "cpu":
        return fused_ir_stage_plain(x, weights, blocks, dw_input_bf16, c_exp_split)
    return _launch(x, weights, blocks, dw_input_bf16)


fused_ir_stage.launches = 0
