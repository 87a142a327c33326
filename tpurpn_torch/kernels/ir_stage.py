"""Fused inverted-residual stage: MobileNetV2 blocks 7-12 + block_13_expand
(port of ``tpurpn/kernels/ir_stage_pallas.py``).

``fused_ir_stage`` on a CUDA tensor launches the hand-written kernel in
``csrc/ir_stage.cu`` (its source note says what bounds it and how it is
laid out); on a CPU tensor it runs ``fused_ir_stage_plain``, the same
function in plain PyTorch. There is no fallback: a CUDA tensor the kernel
does not take raises.

Numerics, as ``tpurpn``'s kernel: bf16 1x1-conv operands with f32
accumulation, bias and ReLU6 in f32, the depthwise in f32 over the f32
expanded activation, bf16 rounding after the depthwise ReLU6 and after the
project bias, a bf16 residual add. Agreement with the folded flax forward is
at bf16 tolerance (tests/test_torch_kernels.py).
"""

from __future__ import annotations

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


def _launch(x: torch.Tensor, weights, blocks) -> torch.Tensor:
    if (x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[1] != x.shape[2]
            or x.shape[3] != blocks[0][0]):
        raise ValueError(f"fused_ir_stage takes (B, S, S, {blocks[0][0]}) bf16, "
                         f"got {x.dtype} {tuple(x.shape)}")
    B, S, _, _ = x.shape
    for w in weights:
        if w.device != x.device or not w.is_contiguous():
            raise ValueError("fused_ir_stage weights must be contiguous, on x's device")
    lib = _build.load("ir_stage")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    x = x.contiguous()
    wi = 0
    for c_in, c_exp, c_out, residual in blocks:
        we, be = weights[wi], weights[wi + 1]
        wi += 2
        if c_out is None:
            out = torch.empty((B, S, S, c_exp), dtype=torch.bfloat16, device=x.device)
            code = lib.ir_expand(x.data_ptr(), out.data_ptr(), we.data_ptr(),
                                 be.data_ptr(), B, S, c_in, c_exp, stream)
        else:
            kdw, bdw, wp, bp = weights[wi : wi + 4]
            wi += 4
            out = torch.empty((B, S, S, c_out), dtype=torch.bfloat16, device=x.device)
            code = lib.ir_block(x.data_ptr(), out.data_ptr(), we.data_ptr(),
                                be.data_ptr(), kdw.data_ptr(), bdw.data_ptr(),
                                wp.data_ptr(), bp.data_ptr(), B, S, c_in, c_out,
                                int(residual), stream)
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
