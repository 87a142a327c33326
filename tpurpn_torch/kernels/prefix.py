"""The serving prefix's convolutions (expanded_conv and blocks 1-6 of
MobileNetV2, after the Conv1 activations) as two hand-written kernels with
their epilogues fused.

``prefix_pointwise`` (a 1x1 convolution: f32 accumulation, then f32 bias,
optional ReLU6, one bf16 rounding, and for a residual block's project a bf16
add of the block input) and ``prefix_depthwise`` (a 3x3 depthwise
convolution with TF SAME padding at stride 1 or 2: f32 sums in ``tpurpn``'s
tap order, f32 bias, ReLU6, one bf16 rounding) launch the kernels of
``csrc/prefix.cu`` on CUDA tensors (its source note says what bounds them
and how they are laid out) and run ``prefix_pointwise_plain`` /
``prefix_depthwise_plain``, the same functions in plain PyTorch, on CPU
tensors. There is no fallback: a CUDA tensor the kernels do not take
raises. They replace no TPU kernel (``tpurpn`` left these convolutions to
XLA); they stand in for cuDNN plus the bias, clamp, residual, pad and cast
operations around each convolution on the serving path
(``inference._fused_stage_from``). The module's ``forward``, which training
and the unfolded model run, is untouched.

Weights are packed once a parameter version (``prefix_weights_cached``,
by ``tpurpn_torch.cache``'s rule): each 1x1 conv as bf16
(c_in, c_out) with its f32 bias and the kernel's shared-memory image of it
(``pointwise_pack``: K-major bf16 in 64-byte-swizzled planes of 32 input
channels, zero-padded to whole planes), each depthwise conv as its bf16
taps held as f32 (9, c), tap ky * 3 + kx, with its f32 bias.

Numerics: the depthwise kernel matches its plain version bit for bit (each
product of two bf16 values is exact in f32, and both sum the taps in the
same order); the pointwise kernel sums its K channels in the tensor cores'
order, so it matches its plain version to f32 summation order before the
one bf16 rounding. Against the module's forward (cuDNN rounds each
convolution to bf16 before a bf16 bias add) the prefix agrees at bf16
tolerance.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ..boxes import _round_up
from ..cache import cached
from .ir_stage import swizzle64

# (c_in, c_out, relu6, residual) of the prefix's 1x1 convs: expanded_conv's
# project, then each block's expand and project
POINTWISE_SPECS = ((32, 16, False, False), (16, 96, True, False), (96, 24, False, False),
                   (24, 144, True, False), (144, 24, False, True), (144, 32, False, False),
                   (32, 192, True, False), (192, 32, False, True), (192, 64, False, False))
# (channels, stride) of its 3x3 depthwise convs
DEPTHWISE_SPECS = ((32, 1), (96, 2), (144, 1), (144, 2), (192, 1), (192, 2))


class Pointwise(NamedTuple):
    """A 1x1 conv of the prefix, packed: ``w`` (c_in, c_out) bf16, ``b``
    (c_out,) f32, ``pack`` the kernel's image of ``w``."""

    w: torch.Tensor
    b: torch.Tensor
    pack: torch.Tensor
    relu6: bool
    residual: bool

    @property
    def spec(self) -> Tuple[int, int, bool, bool]:
        return (self.w.shape[0], self.w.shape[1], self.relu6, self.residual)


class Depthwise(NamedTuple):
    """A 3x3 depthwise conv of the prefix: ``taps`` (9, c) f32 holding bf16
    values, tap ky * 3 + kx; ``b`` (c,) f32."""

    taps: torch.Tensor
    b: torch.Tensor
    stride: int

    @property
    def spec(self) -> Tuple[int, int]:
        return (self.taps.shape[1], self.stride)


def pointwise_pack(w: torch.Tensor) -> torch.Tensor:
    """(c_in, c_out) bf16 -> the kernel's shared-memory image, flat:
    round_up(c_in, 32) / 32 planes of (c_out, 32) K-major bf16, 64-byte
    swizzled (``ir_stage.swizzle64``), the pad input channels zero."""
    c_in, c_out = w.shape
    m = F.pad(w.t(), (0, _round_up(c_in, 32) - c_in))  # (c_out, k_in)
    return swizzle64(m[None])[0]


def pack_pointwise(conv, relu6: bool, residual: bool) -> Pointwise:
    """A folded 1x1 ``Conv`` (weight (c_out, c_in, 1, 1), bias) packed."""
    with torch.no_grad():
        w = conv.weight.reshape(conv.weight.shape[0], -1).t().to(torch.bfloat16).contiguous()
        return Pointwise(w, conv.bias.detach().float().contiguous(), pointwise_pack(w),
                         relu6, residual)


def pack_depthwise(conv) -> Depthwise:
    """A folded 3x3 depthwise ``Conv`` (weight (c, 1, 3, 3), bias) packed."""
    with torch.no_grad():
        c = conv.weight.shape[0]
        taps = conv.weight.reshape(c, 9).t().to(torch.bfloat16).float().contiguous()
        return Depthwise(taps, conv.bias.detach().float().contiguous(), conv.stride[0])


# one block of the prefix: (expand or None, depthwise, project)
PrefixBlock = Tuple["Pointwise | None", Depthwise, Pointwise]


def pack_prefix(bb, block_names: Sequence[str]) -> Tuple[PrefixBlock, ...]:
    """The folded backbone's blocks ``block_names`` packed for the kernels."""
    blocks = []
    for name in block_names:
        blk = bb.get_submodule(name)
        ex = (pack_pointwise(blk.get_submodule(f"{name}_expand"), True, False)
              if blk.expansion != 1 else None)
        blocks.append((ex, pack_depthwise(blk.get_submodule(f"{name}_depthwise")),
                       pack_pointwise(blk.get_submodule(f"{name}_project"), False,
                                      blk.residual)))
    return tuple(blocks)


def prefix_weights_cached(bb, block_names: Sequence[str]) -> Tuple[PrefixBlock, ...]:
    """:func:`pack_prefix`, recomputed only when one of the convs' weights
    or biases is replaced or updated (``cache.cached``)."""
    convs = [m for n in block_names for m in bb.get_submodule(n).children()]
    sources = [t for m in convs for t in (m.weight, m.bias)]
    return cached(sources, ("prefix", tuple(block_names)), lambda: pack_prefix(bb, block_names))


def _bf16_nhwc(x: torch.Tensor, c: int, what: str) -> None:
    if (x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[3] != c or x.numel() == 0
            or not x.is_contiguous()):
        raise ValueError(f"{what} takes contiguous (B, H, W, {c}) bf16, got {x.dtype} "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")


def _check_pointwise(x, pw: Pointwise, residual) -> None:
    if pw.spec not in POINTWISE_SPECS:
        raise ValueError(f"prefix_pointwise takes the specs {POINTWISE_SPECS}, got {pw.spec}")
    c_in, c_out = pw.w.shape
    _bf16_nhwc(x, c_in, "prefix_pointwise")
    if pw.w.dtype != torch.bfloat16 or pw.b.dtype != torch.float32 or pw.b.shape != (c_out,):
        raise ValueError("prefix_pointwise takes bf16 weights and an f32 bias")
    if (residual is not None) != pw.residual:
        raise ValueError(f"this 1x1 conv {'needs' if pw.residual else 'takes no'} residual")
    if residual is not None:
        _bf16_nhwc(residual, c_out, "prefix_pointwise's residual")
        if residual.shape[:3] != x.shape[:3]:
            raise ValueError(f"residual {tuple(residual.shape)} is not x's pixels "
                             f"{tuple(x.shape[:3])}")


def prefix_pointwise_plain(x: torch.Tensor, pw: Pointwise,
                           residual: "torch.Tensor | None" = None) -> torch.Tensor:
    """The 1x1 conv in plain PyTorch: f32 products of the bf16 operands
    (exact) summed in f32, + bias, ReLU6 if ``pw.relu6``, bf16; then
    bf16(that + residual)."""
    y = x.float() @ pw.w.float() + pw.b
    if pw.relu6:
        y = torch.clamp(y, 0.0, 6.0)
    y = y.to(torch.bfloat16)
    return y + residual if residual is not None else y


def prefix_pointwise(x: torch.Tensor, pw: Pointwise,
                     residual: "torch.Tensor | None" = None) -> torch.Tensor:
    """(B, H, W, c_in) bf16 -> (B, H, W, c_out) bf16 through the 1x1 conv
    ``pw`` (+ ``residual``, (B, H, W, c_out) bf16, exactly when
    ``pw.residual``). Specs: ``POINTWISE_SPECS``; ValueError otherwise, on
    either device. A CUDA tensor launches ``prefix_pointwise_kernel`` once
    (counted in ``launches``); a CPU tensor runs
    :func:`prefix_pointwise_plain`."""
    _check_pointwise(x, pw, residual)
    if x.device.type == "cpu":
        return prefix_pointwise_plain(x, pw, residual)
    for t in (pw.b, pw.pack) + ((residual,) if residual is not None else ()):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("prefix_pointwise's operands must be contiguous, on x's device")
    B, H, W, c_in = x.shape
    c_out = pw.w.shape[1]
    lib = _build.load("prefix")
    out = torch.empty((B, H, W, c_out), dtype=torch.bfloat16, device=x.device)
    code = lib.prefix_pointwise(
        x.data_ptr(), residual.data_ptr() if residual is not None else None, out.data_ptr(),
        pw.pack.data_ptr(), pw.pack.numel(), pw.b.data_ptr(), B * H * W, c_in, c_out,
        int(pw.relu6), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "prefix", code)
    prefix_pointwise.launches += 1
    return out


prefix_pointwise.launches = 0


def _check_depthwise(x, dw: Depthwise) -> None:
    if dw.spec not in DEPTHWISE_SPECS:
        raise ValueError(f"prefix_depthwise takes the specs {DEPTHWISE_SPECS}, got {dw.spec}")
    _bf16_nhwc(x, dw.taps.shape[1], "prefix_depthwise")
    c = dw.taps.shape[1]
    if (dw.taps.dtype != torch.float32 or dw.taps.shape != (9, c)
            or dw.b.dtype != torch.float32 or dw.b.shape != (c,)):
        raise ValueError("prefix_depthwise takes (9, c) f32 taps and an f32 bias")


def _out_size(size: int, stride: int) -> int:
    return -(-size // stride)


def prefix_depthwise_plain(x: torch.Tensor, dw: Depthwise) -> torch.Tensor:
    """The 3x3 depthwise conv in plain PyTorch: TF SAME zero padding
    (``same_pad``), f32 products (exact: bf16 by bf16) summed in f32 in the
    order ky, kx, + bias, ReLU6, bf16."""
    from ..backbones.mobilenet_v2 import same_pad

    B, H, W, _ = x.shape
    s = dw.stride
    Ho, Wo = _out_size(H, s), _out_size(W, s)
    (t, b), (l, r) = same_pad(H, 3, s), same_pad(W, 3, s)
    xp = F.pad(x.float(), (0, 0, l, r, t, b))
    acc = torch.zeros((B, Ho, Wo, x.shape[3]), dtype=torch.float32, device=x.device)
    for ky in range(3):
        for kx in range(3):
            win = xp[:, ky: ky + s * (Ho - 1) + 1: s, kx: kx + s * (Wo - 1) + 1: s, :]
            acc = acc + win * dw.taps[ky * 3 + kx]
    return torch.clamp(acc + dw.b, 0.0, 6.0).to(torch.bfloat16)


def prefix_depthwise(x: torch.Tensor, dw: Depthwise) -> torch.Tensor:
    """(B, H, W, c) bf16 -> (B, ceil(H / s), ceil(W / s), c) bf16 through
    the depthwise conv ``dw`` (TF SAME padding, + bias, ReLU6), any H and W.
    Specs: ``DEPTHWISE_SPECS``; ValueError otherwise, on either device. A
    CUDA tensor launches ``prefix_depthwise_kernel`` once (counted in
    ``launches``); a CPU tensor runs :func:`prefix_depthwise_plain`."""
    _check_depthwise(x, dw)
    if x.device.type == "cpu":
        return prefix_depthwise_plain(x, dw)
    for t in (dw.taps, dw.b):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("prefix_depthwise's operands must be contiguous, on x's device")
    B, H, W, c = x.shape
    s = dw.stride
    lib = _build.load("prefix")
    out = torch.empty((B, _out_size(H, s), _out_size(W, s), c), dtype=torch.bfloat16,
                      device=x.device)
    code = lib.prefix_depthwise(x.data_ptr(), out.data_ptr(), dw.taps.data_ptr(),
                                dw.b.data_ptr(), B, H, W, c, s,
                                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "prefix", code)
    prefix_depthwise.launches += 1
    return out


prefix_depthwise.launches = 0


def prefix_blocks(x: torch.Tensor, blocks: Sequence[PrefixBlock]) -> torch.Tensor:
    """Run packed blocks over NHWC bf16 ``x``: for each, [expand] ->
    depthwise -> project [+ the block input]; one launch a conv on the
    card."""
    for ex, dw, pj in blocks:
        h = prefix_pointwise(x, ex) if ex is not None else x
        h = prefix_depthwise(h, dw)
        x = prefix_pointwise(h, pj, x if pj.residual else None)
    return x
