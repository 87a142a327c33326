#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpurpn_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--batch 128]

Drives the paths of the port through the entry points a user calls, each
with every kernel's launch count set to 0 just before it and read just
after: the MobileNetV2 serving path at full width (500x500 images, batch
128, seeded random weights with perturbed BatchNorm statistics, folded); the
training step of VGG16 and of MobileNetV2 (500x500, batch 8, SyntheticVOC
375x500 frames, augment on, seeded random weights); the standalone batched
NMS at BASELINE config 4 (top-2000 -> 300 at batch 32), with the IoU
matching entry beside it; the predictor CLI on the committed trained
weights and the trained weights served; and the trainer CLI. It checks
them:

1. builds the port's CUDA kernels from ``tpurpn_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes: the fused IR stage on (B, 32, 32, 64) bf16 at the bf16
   tolerance (rel 0.02 of max(1, |ref|max)), the proposal kernel on decoded
   (B, 9216) candidates bit for bit; then both at edges the main path does
   not reach (S = 9, 17, 25, 31 and one image; score ties, duplicate boxes,
   fewer candidates than topn, pre not a multiple of the chunk, the 300th
   keep inside a chunk, an image of -inf scores, max_output > pre); then
   the IR stage over the rest of its domain (``ir_stage_domain``: the
   serving stage at S = 33, 40, 47, 63, blocks 4-5 at S = 63, 80 with
   c_exp_split 1-3, block_2 at S = 52, 125, 160, each with dw_input_bf16
   off and on, a tail at each c_in; each case's tiling from
   ``ir_block_plan``, flat runs and column strips both) and its tilings:
   the S = 40 and 63 runs (flat) and block_2's S = 125 run (strips)
   bit-equal to a 32-wide crop's inside the crop, across thread-block
   boundaries of the wide run; then (``prefix``) the serving prefix's
   kernels on the Conv1 activations of the B uint8 frames: each of the 20
   launches against its plain version (the depthwise bit for bit, the 1x1
   within one bf16 ulp) and the module's ops for the same conv, timed
   beside its byte bound, its plain version and those ops; the walk
   against the module's forward; 13 + 7 host launches in a fast serving
   call's capture and none in a replay, and in a traced replay the
   kernels the card ran inside ``rpn.replay`` (13 + 7 prefix, 6 + 1 IR
   stage, 1 proposal); a traced eager call with 13 + 7 launches and
   nothing else inside ``rpn.prefix``;
3. runs ``make_predict_fn(fast=True)`` on B bf16 images and
   ``make_predict_fn(fast=True, from_uint8=True)`` on B uint8 375x500
   frames, with every kernel's launch count set to 0 just before each run and
   read just after (a fresh predict fn's first call: eager; step 2 counts a
   replay's kernels); checks shapes, finiteness, ``0 <= num_valid <= 300`` and
   that both kernels launched; holds the fast forward against the plain
   folded forward at the bf16 tolerance;
   then (``serving_640``) the same two entry points at 640x640 (a 40x40 tap,
   14,400 anchors; uint8 480x640 frames take the s2d route), 7 IR-stage
   and 1 proposal launches a batch, heads within the bf16 tolerance of the
   unfused folded forward, ms a batch, busy time and where the time goes;
   the IR stage at the 640, 750 and 1000 px taps (S = 40, 47, 63, batch B)
   against its plain version, and its flat tiling bit-equal to and timed
   beside column strips;
4. holds the target kernel (config 3: VGG16 anchors N=8,649, B=8, M=8)
   and the IoU-matching kernel against their plain versions: labels and
   indices bit for bit, delta rows 2-3 (logf) at rel 1e-6; then M=64 with
   padded rows, an image without GT, a 22,500-anchor grid, a positive
   budget above the candidates and one below them, no negative candidate,
   budgets of 0, N on each side of the size up to which the selection
   keys stay in shared memory (25,600), and the edges of the matching's
   cluster slices (a tie across a slice boundary, a GT disjoint from every
   anchor, IoUs of -0 and +0, N = 5 < C, N = 8,651, M = 1, B = 1); reports
   each entry's cluster size C (one cluster of C blocks an image). Holds
   the NMS kernel against its plain version on the top-2000 of 32 serving
   images' decoded candidates bit for bit (keep mask and count), and at
   ties, duplicate boxes, all-invalid rows, n not a multiple of the block,
   blocks of 32 and 256, the count reaching max_output exactly at a
   block's end and inside a chunk, n < 32, one image, and a kept list too
   large for shared memory;
5. takes 5 train steps per backbone on a fixed batch, flip mask and words:
   finite losses, the last below the first, one target-kernel launch per step, BatchNorm
   running statistics moved (MobileNetV2); then one step with the plain
   target path on the same flip mask and words gives the same labels and
   the same loss at the bf16 tolerance;
6. times each kernel and its plain version, the stages of the serving path
   and of each train step, both serving variants, the train steps and the
   config-4 NMS with CUDA events after a warm-up; each IR-stage launch by
   block shape, the kernel-ready weight pack, and the proposal wrapper's
   sort apart from its selection kernel (with the candidates each image's
   walk visits), the NMS wrapper's sorts apart from its keep kernel (with
   the boxes and rounds each image's walk decides); a torch.profiler trace
   of each end-to-end run, of each kernel wrapper and of the NMS wrapper
   gives the card's busy time and idle share; each kernel's ``device_ms`` is
   the device time of its own launches in such a trace, a call (the phase
   fails unless the trace holds the launches its wrapper counted for a
   whole number of calls);

7. builds the native batch generator (``tpurpn_torch/native``, g++; its
   version and build seconds in the ``setup`` line), times a batch of 128
   375x500 frames, holds its bytes to the crc32 of
   ``tpurpn.native``'s (NATIVE_CRC_SEED1) and checks that two calls agree;
8. runs the predictor CLI (``cli.predictor_main``) on the committed trained
   weights (``trained/rpn_mobilenet_v2_trained.npz``) over the 256 test
   frames at batch 128, with ``--fast`` and without, with the launch counts
   set to 0 just before each: the IR stage launches 7 times a batch with
   ``--fast``, the proposal kernel once a batch; recall@300 within 0.01 of
   ``tpurpn``'s on the same frames (REF_RECALL_TEST); the PNG it draws is
   read back; then with ``--img-size 640 --fast`` against tpurpn's recall
   at 640 (REF_RECALL_640);
9. serves the trained, folded weights on 128 validation frames (bf16,
   ``fast=True``): ms per batch, the proposal walk's length and the NMS
   rounds on the top-2000 of 32 images, beside the random weights' (the
   kernels held against their plain versions on these candidates too);
10. runs the trainer CLI (``cli.trainer_main``, MobileNetV2 at 500x500,
   batch 8, 5 steps, recall every epoch) into a temporary directory: one
   target-kernel launch per train step and per validation-loss batch, the
   checkpoint written, and the predictor CLI on that checkpoint;
11. ``device_data_train``: per backbone, ``make_scan_train_steps`` (8 steps
   of batch 8 over 64 device-resident 375x500 frames, one CUDA graph of the
   step replayed after an eager first step) against a host loop of
   ``make_train_step`` from the same state and generator: num_pos equal,
   losses within rel 1e-4, parameters within a tenth of the largest
   update; ms/step of both, the replay's device busy time and idle share,
   the target launches the counter sees (the eager step and the capture)
   and those the card runs (a graph replay runs its launch again);
12. ``s2d_serving``: ``make_predict_fn(fast=True, from_uint8=True)`` on
   128 uint8 375x500 frames, random and trained weights, routed through
   ``inference.fast_uint8_forward`` (counted), its head outputs within the
   bf16 tolerance of ``preprocess_batch`` + ``fast_mobilenet_forward``,
   recall@300 of the trained weights over the 256 test frames within 0.01
   of REF_RECALL_TEST, and both routes' ms per batch;
13. ``data_parallel``: two ranks sharing the card over gloo (spawned) take
   the MobileNetV2 mesh step at batch 8 against one device, in f32 and in
   bf16 (loss, parameters and running statistics within STEP_LIMITS; rank
   0's rows stepped alone, without reduction, outside them); then one rank
   over NCCL: the mesh step (cuDNN deterministic), eval loss and predict
   bit for bit against one device; then the trainer CLI with
   ``--device-data --data-parallel`` for 5 steps (its graph captured once
   and replayed 4 times, counted on the graph);
14. ``vitdet_serving`` (run after ``serving_640``): ViTDet-B's RPN at 1024 px
   (seeded random weights, the head drawn wider) through
   ``make_predict_fn(from_uint8=True)`` on 16 uint8 480x640 frames: one
   ``proposal_kernel_levels`` launch, 8 + 4 attention cores and 4,768
   candidates an image into NMS, counted from 0; the level kernel held bit
   for bit against its plain version on the candidates that call selected
   from (261,888 anchors an image, 1,000 out) and on them twice over, the
   copies on levels of their own (kept beside their boxes; none kept
   without levels), the served output its own; the batch, the
   wrapper, its sort and kernel timed beside the level-wise walk's bound
   (the ``kernels`` line's ``fused_proposals_levels`` row). The 12 cores
   are 12 ``relpos_attention_kernel`` launches; the first global and the
   first window core's own q, k, v and tables hold the kernel against its
   plain version (bf16 tolerance) and time it beside the plain version,
   SDPA with the materialised bias (``library_ms``) and the bound (the
   ``relpos_attention_global`` and ``_window`` rows).
15. ``mvit_serving`` (after ``vitdet_serving``): MViTv2-B's RPN on the 800 x
   1088 canvas (seeded random weights) through
   ``make_predict_fn(from_uint8=True)`` on 16 uint8 480x640 frames: 24
   ``mvit_pool_kernel`` launches (one a block) and one proposal launch,
   counted from 0; at each distinct (grid, stride_q, stride_kv, heads) of
   its blocks the kernel's output in that call held against the plain
   pooling in f32 on the same qkv product within one bf16 rounding; the
   batch and the 24 launches timed (wrapper, kernel device time) beside the
   plain pooling, the library pair it replaced (the split copy, cuDNN's
   depthwise convs, PyTorch's LayerNorm) and the byte bound of those calls
   (the ``kernels`` line's ``mvit_pool`` row).
16. ``swin_serving`` (after ``mvit_serving``): Swin-B's RPN on the 800 x
   1088 canvas (seeded random weights, the tables at std 1 and a qkv bias
   drawn, so that both are live) through ``make_predict_fn(from_uint8=True)``
   on 16 uint8 480x640 frames: 24 ``swin_attention_kernel`` launches (one
   a block) and one proposal launch, counted from 0; at each distinct
   (grid, heads, shift, masked) of its blocks the kernel's output in that
   call held against the plain version in f32 on the same qkv product
   (within 2^-8 of each value plus 2^-8 of the largest |v|); the batch,
   the 24 launches (wrapper, kernel device time) and each stage's launches
   timed beside their byte bound, the plain version and the path the
   kernel replaced (pad, gather, SDPA with the expanded bias, gather back:
   ``library_swin``) (the ``kernels`` line's ``swin_attention`` row).
h5py, PIL and tensorboardX are reported in the ``setup`` line and then
blocked for the run: no check depends on them.

``python3 chip_smoke.py --ranks N`` (N GPUs on one host) builds the
kernels and runs only the data-parallel paths over NCCL, one rank a GPU:
the MobileNetV2 mesh step against one device on every rank (within
STEP_LIMITS, a step without reduction outside them), the device-resident graph steps of each backbone at 8 rows a
rank against one GPU at 8 rows (weak scaling, replayed and eager), and the
trainer under ``python -m torch.distributed.run --standalone``.

Output: the card's name and power limit (``nvidia-smi``), JSON lines of
measurements, one ``{"kernels": [...]}`` line, and last the line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that last line; so it does without a CUDA device, and
outside a checkout of the repository. TF32 is off for matmuls and
convolutions, so f32 plain versions run in full f32.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from dataclasses import replace
from pathlib import Path

# Published peaks of one H100 SXM (dense): bf16 tensor cores, f32 outside
# them, HBM3 bandwidth. A bound is the larger of bytes / bandwidth and of
# operations / peak for each operand type (the tensor cores and the f32
# units run at the same time).
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
IOU_OPS = 14  # f32 operations of one IoU test (4 min/max, 4 sub, 3 max, mul, add, div)
TOL_REL = 0.02
BF16_ULP = 2.0 ** -7
# Limits of a mesh step against one device on the same global batch. f32:
# the reduction order alone. bf16, where a rounding to bf16 moves with the
# statistics' last bits: between the largest readings of sound runs (two
# ranks on one card and four GPUs: loss rel 1.2e-3, parameters 2.8e-4,
# running statistics 1.5e-4) and those of rank 0's rows stepped alone,
# without any reduction (two ranks: 1.0e-2, 6.3e-4, 8.8e-3), which every
# run requires to fail the parameters' and statistics' limits.
STEP_LIMITS = {"float32": {"loss_rel": 1e-5, "params": 1e-5, "running_stats": 1e-5},
               "bfloat16": {"loss_rel": 4e-3, "params": 4e-4, "running_stats": 4e-4}}
REPO = Path(__file__).resolve().parent
TRAINED_NPZ = REPO / "trained" / "rpn_mobilenet_v2_trained.npz"
# crc32 of tpurpn.native.generate_batch(1, indices 0-7, 375, 500, 8, 1, 20):
# images, boxes and labels chained (tests/test_torch_data.py asserts it
# against tpurpn).
NATIVE_CRC_SEED1 = 0x1C68A8F8
# tpurpn's recall@300 on the 256 test frames (SyntheticVOC seed 2, native)
# with the trained weights, on the CPU:
#   python rpn_predictor.py --backbone mobilenet_v2 \
#       --weights trained/rpn_mobilenet_v2_trained.h5 --batch-size 16
# (the same 256 frames as at batch 128, in batches the CPU holds at a few
# GB) printed "proposal recall@300 (IoU>=0.5): 0.8287 over 6234 GT boxes".
REF_RECALL_TEST, REF_GT_TEST, RECALL_TOL = 0.8287, 6234, 0.01
# ... and at 640x640 (a 40x40 tap, 14,400 anchors), with --img-size 640
# added to that command: "proposal recall@300 (IoU>=0.5): 0.8114 over 6234
# GT boxes".
REF_RECALL_640 = 0.8114
OPTIONAL = ("h5py", "PIL", "tensorboardX")
RECALL_LINE = re.compile(r"proposal recall@(\d+) \(IoU>=0\.5\): ([0-9.]+) over (\d+) GT boxes")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def close_err(got, ref):
    """(max |got - ref|, allowed) at the bf16 tolerance of tests/test_ir_stage.py."""
    got, ref = got.float(), ref.float()
    scale = max(1.0, float(ref.abs().max()))
    err = (got - ref).abs()
    excess = float((err - (TOL_REL * scale + TOL_REL * ref.abs())).max())
    return float(err.max()), excess <= 0.0


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def trace_device_events(torch, fn, iters: int):
    """The operations that ran on the card in the last ``iters`` of
    ``iters + 1`` traced calls of ``fn`` (the first is a warm-up: the
    kernels launched just after tracing starts can be missing from it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=iters),
                 on_trace_ready=lambda p: traces.append(list(p.events()))) as prof:
        for _ in range(iters + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # the step annotations (ProfilerStep#) span each step on the card too
    return [e for e in (traces[-1] if traces else [])
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and not e.name.startswith("ProfilerStep")]


def device_profile(torch, fn, iters: int = 5, tries: int = 3):
    """(device busy ms, device operations) per call of ``fn`` from a
    torch.profiler trace: the summed durations of the operations that ran on
    the card (kernels, copies, fills, not the step annotations), which one
    stream runs one after another. A trace whose device operations do not
    divide evenly among the calls is taken again, up to ``tries`` times.
    (None, 0) when no trace holds a whole number of calls' device time."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        on_device = trace_device_events(torch, fn, iters)
        busy_us = sum(e.self_device_time_total for e in on_device)
        if busy_us and len(on_device) % iters == 0:
            return busy_us / iters / 1e3, len(on_device) / iters
    return None, 0


def kernel_device_ms(torch, fn, names, counter, iters: int = 5, tries: int = 3):
    """(kernel ms, wrapper ms) per call of the wrapper call ``fn`` on the
    card: the summed device time of the kernel's own launches (trace
    operations whose name holds one of ``names``), and of every device
    operation of the call, over the calls the trace holds. A trace must
    hold the launches that ``counter`` (the wrapper) counts for a whole
    number of calls, at least one and at most ``iters`` (the profiler can
    drop a call's launches: seen for the target kernel, one call of five
    in every trace of a process); it is taken again up to ``tries`` times,
    and the check fails if none does."""
    before = counter.launches
    fn()
    torch.cuda.synchronize()
    per_call = counter.launches - before
    found = []
    for _ in range(tries):
        on_device = trace_device_events(torch, fn, iters)
        mine = [e for e in on_device if any(n in e.name for n in names)]
        found.append(len(mine))
        calls = len(mine) // per_call if per_call else 0
        if calls and len(mine) == per_call * calls and calls <= iters:
            return (sum(e.self_device_time_total for e in mine) / calls / 1e3,
                    sum(e.self_device_time_total for e in on_device) / calls / 1e3)
    raise RuntimeError(f"chip_smoke check failed: traces held {found} launches of {names}, "
                       f"not a whole number of calls of {per_call} up to {per_call * iters}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def perturb_batch_norm(model, generator, torch) -> None:
    """Draw BN statistics and affine terms away from identity, so the fold
    does real work."""
    from tpurpn_torch.backbones.mobilenet_v2 import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=generator) + 0.5)
                m.bias.copy_(torch.randn(n, generator=generator) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=generator) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=generator) + 0.5)


def ir_stage_bound(x, weights, blocks):
    """(bound_ms, bound_by) of the fused IR stage on input ``x``."""
    B, S = x.shape[0], x.shape[1]
    px = B * S * S
    mm = dw = 0
    for c_in, c_exp, c_out, _ in blocks:
        mm += 2 * px * c_in * c_exp
        if c_out is not None:
            dw += 2 * 9 * px * c_exp
            mm += 2 * px * c_exp * c_out
    c_last = blocks[-1][2] or blocks[-1][1]
    nbytes = (x.numel() * x.element_size() + px * c_last * 2
              + sum(w.numel() * w.element_size() for w in weights))
    t_ops = max(mm / PEAK_BF16, dw / PEAK_F32)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# The IR stage's kernels, as the profiler names them.
IR_KERNELS = ("ir_block_kernel", "ir_expand_kernel")


@contextlib.contextmanager
def strips_forced(ir_stage_module):
    """Within the block, the IR-stage wrapper tiles every S with column
    strips (``strip_plan`` in place of ``ir_block_plan``): the comparison of
    the plan's tiling with the strips it replaces, never a main path."""
    plan = ir_stage_module.ir_block_plan
    ir_stage_module.ir_block_plan = ir_stage_module.strip_plan
    try:
        yield
    finally:
        ir_stage_module.ir_block_plan = plan


def block_of(plan, y, x, S):
    """The thread block of an image that outputs pixel (y, x) under ``plan``."""
    if plan.tiling == "flat":
        return (y * S + x) // plan.width
    return (y // 8) * plan.strips + x // plan.width


def ir_domain_phase(torch, bb, gen, dev):
    """The IR-stage kernel against its plain version over its domain beyond
    the serving stage at S <= 32 (random bf16 inputs in [-1, 1), B = 2, the
    seeded folded weights, the bf16 tolerance): the serving stage at S = 33,
    40, 47, 63 (flat); blocks 4-5 at S = 63 (flat), 80 (strips) with
    c_exp_split 1, 2, 3; block_2 at S = 52 (flat) and 125, 160 (strips);
    each with dw_input_bf16 off and on; splits whose groups are not whole
    16-channel steps (blocks 4-5 at 8, block_2 at 2 and 4); a tail at each
    c_in (the tails at 24, 32 and 64 are block_2's, block_4's and block_7's
    expand convs). Each case records the tiling and blocks an image of
    ``ir_block_plan``.
    Then tiling: the serving stage at S = 40 and 63 (flat) and block_2 at
    S = 125 (strips), each against a 32-wide crop of its input (one strip)
    holding boundaries between the S run's thread blocks inside, bit for bit
    on the crop's pixels 6 or more from its edge (six 3x3 depthwise reach 6;
    block_2's one reaches 1)."""
    from tpurpn_torch.inference import _FUSED_BLOCKS as SERVING_BLOCKS
    from tpurpn_torch.kernels.ir_stage import (fused_ir_stage, fused_ir_stage_plain,
                                               ir_block_plan, pack_stage_weights)

    cases = [(f"serving_S{S}_dw{int(dw)}", SERVING_BLOCKS, "block_13_expand", S, 64,
              {"dw_input_bf16": dw}) for S in (33, 40, 47, 63) for dw in (False, True)]
    cases += [(f"blocks45_S{S}_dw{int(dw)}_split{split}", ("block_4", "block_5"), None, S, 32,
               {"dw_input_bf16": dw, "c_exp_split": split})
              for S in (63, 80) for dw in (False, True) for split in (1, 2, 3)]
    cases += [(f"block2_S{S}_dw{int(dw)}", ("block_2",), None, S, 24, {"dw_input_bf16": dw})
              for S in (52, 125, 160) for dw in (False, True)]
    cases += [(f"blocks45_S63_dw{int(dw)}_split8", ("block_4", "block_5"), None, 63, 32,
               {"dw_input_bf16": dw, "c_exp_split": 8}) for dw in (False, True)]
    cases += [(f"block2_S125_dw0_split{split}", ("block_2",), None, 125, 24,
               {"c_exp_split": split}) for split in (2, 4)]
    cases += [(f"tail{c_in}_S47", (), tail, 47, c_in, {})
              for tail, c_in in (("block_2", 24), ("block_4", 32), ("block_7", 64),
                                 ("block_13_expand", 96))]
    out = {"phase": "ir_stage_domain", "B": 2,
           "tolerance": f"rel {TOL_REL} of max(1, |ref|max)"}
    tilings = set()
    with torch.no_grad():
        for name, names, tail, S, c_in, opts in cases:
            weights, blocks = pack_stage_weights(bb, names, tail_expand=tail)
            x = (torch.rand((2, S, S, c_in), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
            got = fused_ir_stage(x, weights, blocks, **opts)
            ref = fused_ir_stage_plain(x, weights, blocks, **opts)
            torch.cuda.synchronize()
            c_last = blocks[-1][2] or blocks[-1][1]
            require(got.shape == (2, S, S, c_last), f"IR stage {name}: shape {tuple(got.shape)}")
            err, ok = close_err(got, ref)
            require(ok, f"IR stage kernel vs plain, {name}: max abs err {err}")
            out[f"{name}_max_abs_err"] = err
            plan = ir_block_plan(S)
            if any(spec[2] is not None for spec in blocks):
                tilings.add((plan.tiling, opts.get("dw_input_bf16", False)))
                out[f"{name}_tiling"] = {"tiling": plan.tiling, "blocks_per_image": plan.blocks}
        require(tilings == {(t, dw) for t in ("flat", "strips") for dw in (False, True)},
                f"the domain cases take both tilings with dw_input_bf16 off and on: {tilings}")

        for name, names, tail, S, off, reach in (
                ("serving_S40", SERVING_BLOCKS, "block_13_expand", 40, 4, 6),
                ("serving_S63", SERVING_BLOCKS, "block_13_expand", 63, 16, 6),
                ("block2_S125", ("block_2",), None, 125, 40, 1)):
            weights, blocks = pack_stage_weights(bb, names, tail_expand=tail)
            plan = ir_block_plan(S)
            lo, hi = off + reach, off + 32 - reach  # the crop's inner pixels in the S run
            inside = {block_of(plan, y, x, S) for y in range(lo, hi) for x in range(lo, hi)}
            require(len(inside) > 1, f"no thread-block boundary of {plan} in [{lo}, {hi})^2")
            x = (torch.rand((2, S, S, blocks[0][0]), generator=gen, device=dev) * 2 - 1).to(
                torch.bfloat16)
            whole = fused_ir_stage(x, weights, blocks)
            crop = fused_ir_stage(x[:, off:off + 32, off:off + 32].contiguous(), weights, blocks)
            a = whole[:, lo:hi, lo:hi]
            b = crop[:, reach:32 - reach, reach:32 - reach]
            require(torch.equal(a, b), f"IR stage tiling, {name}: the S={S} run and its 32-wide "
                    f"crop differ by {max_diff(torch, a, b)} inside the crop")
            out[f"tiling_{name}"] = {"tiling": plan.tiling, "blocks_per_image": plan.blocks,
                                     "strips": plan.strips, "width": plan.width,
                                     "blocks_inside": len(inside), "crop_offset": off,
                                     "reach": reach,
                                     "compared_pixels": int(a.shape[0] * a.shape[1] * a.shape[2]),
                                     "bit_equal": True}
    return out


def ir_wide_stage(torch, ir_stage_module, x, weights, blocks):
    """The IR stage on ``x`` (B, S, S, c_in) at the tiling of the plan: the
    kernel against its plain version (bf16 tolerance) and against the same
    stage tiled in column strips (bit for bit: a pixel's arithmetic does not
    depend on its tile); launches, ms (CUDA events), device ms of the
    kernels' own launches, plain ms, bound, and the strips' ms beside."""
    fn = ir_stage_module.fused_ir_stage
    S = x.shape[1]
    plan, strips = ir_stage_module.ir_block_plan(S), ir_stage_module.strip_plan(S)
    got = fn(x, weights, blocks)
    err, ok = close_err(got, ir_stage_module.fused_ir_stage_plain(x, weights, blocks))
    require(ok and got.shape[:3] == x.shape[:3], f"IR stage at S={S}: max abs err {err}")
    with strips_forced(ir_stage_module):
        striped = fn(x, weights, blocks)
    require(torch.equal(got, striped), f"IR stage at S={S}: {plan.tiling} and strips differ by "
            f"{max_diff(torch, got, striped)}")
    launches = fn.launches
    fn(x, weights, blocks)
    launches = fn.launches - launches
    ms = time_ms(torch, lambda: fn(x, weights, blocks), 20)
    device, wrapper_device = kernel_device_ms(torch, lambda: fn(x, weights, blocks),
                                              IR_KERNELS, fn)
    with strips_forced(ir_stage_module):
        strips_ms = time_ms(torch, lambda: fn(x, weights, blocks), 20)
        strips_device, _ = kernel_device_ms(torch, lambda: fn(x, weights, blocks),
                                            IR_KERNELS, fn)
    plain_ms = time_ms(torch, lambda: ir_stage_module.fused_ir_stage_plain(x, weights, blocks), 3)
    bound, by = ir_stage_bound(x, weights, blocks)
    return {"S": S, "B": x.shape[0], "tiling": plan.tiling, "blocks_per_image": plan.blocks,
            "width": plan.width, "launches": launches, "max_abs_err": err, "ms": ms,
            "device_ms": device, "wrapper_device_ms": wrapper_device, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by,
            "strips": {"blocks_per_image": strips.blocks, "strips": strips.strips,
                       "width": strips.width, "ms": strips_ms, "device_ms": strips_device,
                       "bit_equal": True}}


def proposal_bound(torch, boxes, scores, pre, max_output, thr, levels=None):
    """(bound_ms, bound_by, visited) of top-``pre`` + greedy NMS on these
    candidates: every score is read (the top-k needs all), the boxes the
    greedy walk visits (up to the last keep; ``visited`` (B,) counts them)
    are read once, each visited candidate is tested against the boxes kept
    before it, and the outputs are written. With ``levels`` ((N,) ids) a
    visited candidate is tested only against the kept boxes of its level,
    and its level is read beside its box."""
    from tpurpn_torch.boxes import batched_non_max_suppression
    from tpurpn_torch.kernels.proposal import top_candidates

    B, N = scores.shape
    idx = top_candidates(scores, pre)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_levels = torch.zeros_like(idx) if levels is None else levels.long()[idx]
    sel, nv = batched_non_max_suppression(
        top_boxes, torch.gather(scores, 1, idx), max_output, thr, presorted=True,
        use_kernel=False, levels=None if levels is None else top_levels)
    keep = torch.zeros((B, pre + 1), dtype=torch.int64, device=boxes.device)
    keep.scatter_(1, torch.where(sel >= 0, sel.long(), pre), 1)
    keep = keep[:, :pre]
    full = nv >= max_output
    visited = torch.where(full, sel[:, max_output - 1].long() + 1, pre)
    pos = torch.arange(pre, device=boxes.device)[None]
    mine = torch.nn.functional.one_hot(top_levels, int(top_levels.max()) + 1)
    kept = keep[..., None] * mine
    kept_before = ((torch.cumsum(kept, 1) - kept) * mine).sum(-1)
    tests = int((kept_before * (pos < visited[:, None])).sum())
    per_box = 16 if levels is None else 20
    nbytes = B * N * 4 + int(visited.sum()) * per_box + B * max_output * 20 + B * 4
    t_ops = tests * IOU_OPS / PEAK_F32
    t_bytes = nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, visited


def targets_bound(B, N, M):
    """(bound_ms, bound_by) of target assignment: B*N*M IoU tests, 2 x 4
    radix passes over the N keys of each image (compare, digit, count) plus
    the key and label work (~16 operations an anchor); the bytes of the
    anchors, GT rows, labels and words read once and of the deltas and
    labels written once."""
    ops = B * N * M * IOU_OPS + B * N * (2 * 4 * 3 + 16)
    nbytes = N * 16 + B * M * 20 + B * 2 * N * 4 + B * N * 20
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def matching_bound(B, N, M):
    """(bound_ms, bound_by) of IoU matching: B*N*M IoU tests and two
    compares each; anchors and GT read once, three outputs written once."""
    ops = B * N * M * (IOU_OPS + 2)
    nbytes = N * 16 + B * M * 16 + B * N * 8 + B * M * 4
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nms_decided(torch, keep, max_output, block):
    """(B,) boxes each image decides: the blocks up to the one in which its
    count reaches max_output (the stop rule), or all n."""
    n = keep.shape[1]
    # first position whose block ends the walk: where the count reaches max_output
    reached = torch.cumsum(keep.long(), 1) >= max_output
    first = torch.where(reached.any(1), reached.float().argmax(1), n - 1)
    return torch.clamp((first // block + 1) * block, max=n)


def nms_bound(torch, keep, valid, max_output, block):
    """(bound_ms, bound_by) of the NMS keep mask on this run's boxes: the
    boxes each image decides (nms_decided) that are valid are each tested
    against the boxes kept before it; those boxes are read once, the mask
    and counts written once."""
    B, n = keep.shape
    k = keep.long()
    kept_before = torch.cumsum(k, 1) - k
    end = nms_decided(torch, keep, max_output, block)
    pos = torch.arange(n, device=keep.device)[None]
    visited = (pos < end[:, None]) & valid
    tests = int((kept_before * visited).sum())
    nbytes = int(end.sum()) * 17 + B * n + B * 4
    t_ops, t_bytes = tests * IOU_OPS / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def target_executions(launches, graphs):
    """Executions of the target kernel on the card: the counter's launches,
    less the one each capture recorded, plus one a replay (the counter does
    not see replays)."""
    return launches - sum(g.captures for g in graphs) + sum(g.replays for g in graphs)


# the kernels a replayed fast serving call runs on the card, by name
REPLAYED = {"prefix_pointwise_kernel": 13, "prefix_depthwise_kernel": 7, "ir_block_kernel": 6,
            "ir_expand_kernel": 1, "proposal_kernel": 1}


def replay_kernels(torch, fn, x, tries: int = 3):
    """Kernels of ``REPLAYED`` that the card ran inside ``rpn.replay``'s
    device range in a traced call ``fn(x)`` (after a traced warm-up call,
    whose first launches the profiler can miss); traced again, up to
    ``tries`` times, while they differ from ``REPLAYED`` (the profiler can
    drop a launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from tpurpn_torch import profiling

    for _ in range(tries):
        traces = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traces.append(list(p.events()))) as prof, \
                profiling._on(annotate=True):
            for _ in range(2):
                fn(x)
                torch.cuda.synchronize()
                prof.step()
        events = traces[-1] if traces else []
        ranges = [e.time_range for e in events
                  if e.name == "rpn.replay" and e.device_type == DeviceType.CUDA]
        found = dict.fromkeys(REPLAYED, 0)
        for e in events:
            if (e.device_type == DeviceType.CUDA and not e.is_user_annotation and len(ranges) == 1
                    and ranges[0].start <= e.time_range.start <= e.time_range.end
                    <= ranges[0].end):
                for name in found:
                    found[name] += name in e.name
        if found == REPLAYED:
            break
    return found


def step_gaps(metrics, tensors, ref_metrics, ref_tensors):
    """The loss's relative gap and the largest parameter and running
    statistic gaps of a step (metrics, state_dict) to a reference step."""
    gaps = {"loss_rel": abs(float(metrics["loss"]) / float(ref_metrics["loss"]) - 1.0)}
    for k, v in ref_tensors.items():
        if not k.endswith("num_batches_tracked"):
            kind = "running_stats" if "running" in k else "params"
            gaps[kind] = max(gaps.get(kind, 0.0), float((tensors[k].cpu() - v.cpu()).abs().max()))
    return gaps


def half_update(before, after):
    """The parameter gap of averaging the ranks' gradients instead of summing
    them: half the largest update (SGD's first step is -lr * gradient)."""
    return max(0.5 * float((after[k].cpu() - v.cpu()).abs().max())
               for k, v in before.items() if "running" not in k and not k.endswith("tracked"))


def check_mesh_step(what, dtype, gaps, alone):
    """The mesh step's gaps to one device within STEP_LIMITS, and those of
    a step without reduction (``alone``: rank 0's rows stepped by
    themselves) outside the parameters' and statistics' limits."""
    lim = STEP_LIMITS[dtype]
    require(all(gaps[k] <= v for k, v in lim.items()),
            f"{what} vs one device ({dtype}): {gaps}, limits {lim}")
    require(alone["params"] > lim["params"] and alone["running_stats"] > lim["running_stats"],
            f"{what} ({dtype}): a step without reduction passes the limits: {alone}")


def reset(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


def counts(kernels):
    return {n: k.launches for n, k in kernels.items()}


def check_targets(torch, fused, plain, args, what):
    """Target kernel vs plain: labels bit for bit, delta rows 0-1 bit for
    bit, rows 2-3 (logf vs log) at rel 1e-6. Returns (max |delta diff|,
    labels)."""
    (dk, lk), (dp, lp) = fused(*args), plain(*args)
    torch.cuda.synchronize()
    require(torch.equal(lk, lp), f"target kernel vs plain labels differ ({what})")
    require(torch.equal(dk[..., :2], dp[..., :2]), f"target kernel delta rows 0-1 differ ({what})")
    torch.testing.assert_close(dk[..., 2:], dp[..., 2:], rtol=1e-6, atol=0,
                               msg=f"target kernel delta rows 2-3 ({what})")
    return float((dk - dp).abs().max()), lk


def max_diff(torch, a, b) -> float:
    """Largest |a - b| over two tensors of one shape (bool and int too)."""
    require(a.shape == b.shape, f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_matching(torch, fused, plain, anchors, gt, what):
    """IoU-matching kernel vs plain, bit for bit. Returns the largest
    difference over merged IoU, best GT and best anchor."""
    k, p = fused(anchors, gt), plain(anchors, gt)
    torch.cuda.synchronize()
    for a, b, name in zip(k, p, ("merged_iou", "best_gt", "best_anchor")):
        require(torch.equal(a, b), f"IoU-matching kernel vs plain differ in {name} ({what})")
    return max(max_diff(torch, a, b) for a, b in zip(k, p))


def check_nms(torch, fused, plain, args, what):
    """NMS kernel vs plain, bit for bit. Returns (kept counts, the largest
    difference over keep mask and count)."""
    (kk, ck), (kp, cp) = fused(*args), plain(*args)
    torch.cuda.synchronize()
    require(torch.equal(kk, kp) and torch.equal(ck, cp),
            f"NMS kernel vs plain differ ({what}): counts {ck.tolist()[:8]} vs {cp.tolist()[:8]}")
    return ck, max(max_diff(torch, kk, kp), max_diff(torch, ck, cp))


def disjoint_boxes(torch, B, n, dev):
    """(B, n, 4) boxes on a grid, none overlapping another: every valid box
    is kept."""
    i = torch.arange(n, device=dev)
    yx = torch.stack([torch.div(i, 128, rounding_mode="floor"), i % 128], -1).float() / 128
    return torch.cat([yx, yx + 0.5 / 128], -1)[None].repeat(B, 1, 1).contiguous()


def random_gt(torch, gen, B, M, n_valid, dev):
    yx = torch.rand((B, M, 2), generator=gen, device=dev) * 0.6
    hw = torch.rand((B, M, 2), generator=gen, device=dev) * 0.25 + 0.1
    gt = torch.cat([yx, torch.clamp(yx + hw, max=1.0)], dim=-1)
    gt[:, n_valid:] = 0.0
    labels = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    labels[:, :n_valid] = 1
    return gt, labels


def train_phase(torch, backbone, args, dev, kernels, steps=5):
    """Steps of make_train_step at full width on a fixed batch; returns
    (phase line, timing line, launch counts of the steps)."""
    import copy

    from tpurpn_torch import (create_train_state, get_hyper_params, get_model, init_model,
                              make_train_step)
    from tpurpn_torch.anchors import generate_anchors
    from tpurpn_torch.data import SyntheticVOC, preprocess_batch
    from tpurpn_torch.losses import reg_loss, rpn_cls_loss
    from tpurpn_torch.target import calculate_rpn_actual_outputs, target_rand_bits
    from tpurpn_torch.train import TrainState, default_optimizer

    B = args.train_batch
    hp = get_hyper_params(backbone)  # 500x500; VGG16 31x31 (8,649 anchors), MobileNetV2 32x32
    ds = SyntheticVOC(num_samples=B, seed=args.seed)  # 375x500 frames, <= 8 boxes
    imgs, boxes, labels = (torch.from_numpy(a).to(dev) for a in next(ds.batches(B)))
    model = init_model(get_model(hp), torch.Generator().manual_seed(args.seed), device=dev)
    state = create_train_state(hp, model=model)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    step = make_train_step(hp, augment=True)
    bn = getattr(model.backbone, "bn_Conv1", None)
    var0 = None if bn is None else bn.running_var.clone()

    # a fixed objective: the same batch, flip mask and words every step
    flip = torch.rand((B,), generator=gen, device=dev) < 0.5
    bits = target_rand_bits(gen, B, hp.total_anchors, dev)
    reset(kernels)
    metrics = [step(state, imgs, boxes, labels, flip=flip, rand_bits=bits)[1]
               for _ in range(steps)]
    torch.cuda.synchronize()
    launches = counts(kernels)
    losses = [float(m["loss"]) for m in metrics]
    require(all(math.isfinite(x) for x in losses), f"{backbone}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"{backbone}: loss did not fall {losses}")
    require(launches["targets"] == steps,
            f"{backbone}: {launches['targets']} target-kernel launches in {steps} steps")
    moved = None
    if bn is not None:
        moved = float((bn.running_var - var0).abs().max())
        require(moved > 0, "MobileNetV2: BatchNorm running variance did not move")

    # the same step with the plain target path on the same draws
    anchors = generate_anchors(hp, dev)
    _, aug_boxes = preprocess_batch(imgs, boxes, hp.img_size, augment=True, flip=flip)
    lk = calculate_rpn_actual_outputs(anchors, aug_boxes, labels, hp, rand_bits=bits)[1]
    lp = calculate_rpn_actual_outputs(anchors, aug_boxes, labels, hp, rand_bits=bits,
                                      use_kernel=False)[1]
    require(torch.equal(lk, lp), f"{backbone}: kernel and plain target labels differ")
    pair = {}
    for use_kernel in (None, False):
        m = copy.deepcopy(state.model)
        st = TrainState(model=m, optimizer=default_optimizer(m.parameters()))
        _, mt = make_train_step(hp, augment=True, use_kernel=use_kernel)(
            st, imgs, boxes, labels, flip=flip, rand_bits=bits)
        pair[use_kernel] = mt
    require(int(pair[None]["num_pos"]) == int(pair[False]["num_pos"]),
            f"{backbone}: num_pos differs between kernel and plain targets")
    loss_err, loss_ok = close_err(pair[None]["loss"], pair[False]["loss"])
    require(loss_ok, f"{backbone}: loss with kernel vs plain targets: {loss_err}")

    # timing: the whole step, the card's busy share in it, then its stages
    step_ms = time_ms(torch, lambda: step(state, imgs, boxes, labels, gen), 5)
    busy_ms, device_ops = device_profile(torch, lambda: step(state, imgs, boxes, labels, gen))
    images, aug_boxes = preprocess_batch(imgs, boxes, hp.img_size, augment=True, flip=flip)
    deltas, tl = calculate_rpn_actual_outputs(anchors, aug_boxes, labels, hp, rand_bits=bits)
    opt = state.optimizer
    model.train()

    def fwd_bwd():
        opt.zero_grad(set_to_none=True)
        reg, cls = model(images)
        (reg_loss(deltas, reg) + rpn_cls_loss(tl, cls)).backward()

    stages = {
        "preprocess": time_ms(torch, lambda: preprocess_batch(
            imgs, boxes, hp.img_size, augment=True, flip=flip), 10),
        "targets": time_ms(torch, lambda: calculate_rpn_actual_outputs(
            anchors, aug_boxes, labels, hp, rand_bits=bits), 10),
        "forward_backward": time_ms(torch, fwd_bwd, 5),
        "optimizer": time_ms(torch, opt.step, 10),
    }
    model.eval()
    phase = {"phase": f"train_{backbone}", "batch": B, "img_size": hp.img_size,
             "anchors": hp.total_anchors, "steps": steps, "losses": losses,
             "launches": launches, "running_var_moved": moved,
             "kernel_vs_plain_loss_abs_err": loss_err}
    timing = {"phase": f"train_{backbone}_ms", "batch": B, "ms_per_step": step_ms,
              "img_per_s": B / step_ms * 1e3, "device_busy_ms": busy_ms,
              "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / step_ms,
              "device_ops_per_step": device_ops, **stages}
    return phase, timing, launches


def device_data_phase(torch, backbone, args, dev, kernels, steps=8, frames=64):
    """``make_scan_train_steps`` (one CUDA graph of the step, replayed) over
    a device-resident SyntheticVOC set against a host loop of
    ``make_train_step`` from the same state and generator over the same
    rows: num_pos equal at every step, losses within rel 1e-4 (cuDNN's
    backward may sum with atomics), the parameters within a tenth of the
    steps' largest update; then ms/step of each by CUDA events and the
    replay's device busy time and idle share."""
    from tpurpn_torch import (create_train_state, get_hyper_params, get_model, init_model,
                              make_scan_train_steps, make_train_step)
    from tpurpn_torch.data import SyntheticVOC

    B = args.train_batch
    hp = get_hyper_params(backbone)
    data = tuple(torch.from_numpy(a).to(dev) for a in next(
        SyntheticVOC(num_samples=frames, seed=args.seed).batches(frames)))

    def fresh():
        model = init_model(get_model(hp), torch.Generator().manual_seed(args.seed), device=dev)
        return (create_train_state(hp, model=model),
                torch.Generator(device=dev).manual_seed(args.seed + 1))

    (state_a, gen_a), (state_b, gen_b) = fresh(), fresh()
    p0 = [p.detach().clone() for p in state_a.model.parameters()]
    step = make_train_step(hp, augment=True)
    rows = [torch.arange(B, device=dev) + (s * B) % frames for s in range(steps)]

    def host_loop():
        return [step(state_a, *(t[r] for t in data), gen_a)[1] for r in rows]

    loop = host_loop()
    run = make_scan_train_steps(hp, augment=True, batch_size=B, num_steps=steps)
    reset(kernels)
    _, scan = run(state_b, gen_b, *data)
    torch.cuda.synchronize()
    launches = counts(kernels)
    replays, captures = run.graph.replays, run.graph.captures
    require(captures == 1 and replays == steps - 1,
            f"{backbone}: {captures} captures and {replays} replays for {steps} steps")
    executions = target_executions(launches["targets"], [run.graph])
    require(executions == steps, f"{backbone}: {executions} target executions for {steps} steps")
    require(launches["targets"] == 2,
            f"{backbone}: {launches['targets']} target launches: one eager step, one capture")
    loop_pos = [int(m["num_pos"]) for m in loop]
    require(scan["num_pos"].tolist() == loop_pos,
            f"{backbone}: num_pos {scan['num_pos'].tolist()} vs host loop {loop_pos}")
    loop_loss = torch.stack([m["loss"] for m in loop])
    loss_rel = float(((scan["loss"] - loop_loss).abs() / loop_loss.abs()).max())
    require(loss_rel <= 1e-4, f"{backbone}: scan vs host-loop losses, rel {loss_rel}")
    update = max(float((p.detach() - q).abs().max())
                 for p, q in zip(state_a.model.parameters(), p0))
    diff = max(float((p.detach() - q.detach()).abs().max())
               for p, q in zip(state_b.model.parameters(), state_a.model.parameters()))
    require(diff <= 0.1 * update, f"{backbone}: parameters differ by {diff} (update {update})")
    require(state_b.step == state_a.step == steps, "steps counted")

    calls = 3
    replay_ms = time_ms(torch, lambda: run(state_b, gen_b, *data), calls, warmup=1) / steps
    eager_ms = time_ms(torch, host_loop, calls, warmup=1) / steps
    busy, ops = device_profile(torch, lambda: run(state_b, gen_b, *data), iters=3)
    return {"phase": f"device_data_train_{backbone}", "batch": B, "img_size": hp.img_size,
            "frames": frames, "dataset_mb": sum(t.numel() * t.element_size() for t in data) / 1e6,
            "steps": steps, "num_pos": loop_pos, "losses_scan": scan["loss"].tolist(),
            "losses_host_loop": loop_loss.tolist(), "loss_max_rel_err": loss_rel,
            "param_max_abs_err": diff, "param_max_update": update,
            "launches_counter": launches, "graph_captures": captures, "graph_replays": replays,
            "targets_executions": executions,
            "launch_note": "the Python counter sees the eager step and the capture; each "
                           "replay runs the captured launch again: executions = "
                           "counter - captures + replays",
            "ms_per_step_replay": replay_ms, "ms_per_step_eager_loop": eager_ms,
            "img_per_s_replay": B / replay_ms * 1e3,
            "device_busy_ms_per_step": None if busy is None else busy / steps,
            "device_ops_per_step": ops / steps,
            "device_idle_share_replay": None if busy is None else 1.0 - busy / (replay_ms * steps)}


def dp_problem(torch, seed, batch, dev, dtype="bfloat16"):
    """The data-parallel phases' step: MobileNetV2 at 500x500 computing in
    ``dtype`` from a seeded init, a SyntheticVOC batch (global) and global
    draws from a CPU generator, the same in every process."""
    from tpurpn_torch import create_train_state, get_hyper_params, get_model, init_model
    from tpurpn_torch.data import SyntheticVOC
    from tpurpn_torch.target import target_rand_bits

    hp = get_hyper_params("mobilenet_v2", compute_dtype=dtype)
    model = init_model(get_model(hp), torch.Generator().manual_seed(seed), device=dev)
    data = tuple(torch.from_numpy(a) for a in next(
        SyntheticVOC(num_samples=batch, seed=seed).batches(batch)))
    g = torch.Generator().manual_seed(seed + 7)
    flip = torch.rand((batch,), generator=g) < 0.5
    bits = target_rand_bits(g, batch, hp.total_anchors)
    return hp, create_train_state(hp, model=model), data, flip, bits


def two_rank_worker(rank, store, out, seed, batch):
    """One of two ranks sharing the card over gloo: the mesh step of
    ``dp_problem`` in f32 and in bf16; rank 0 also steps its own rows alone
    (no reduction), and saves the metrics and tensors of both."""
    import copy

    import torch
    import torch.distributed as dist
    from tpurpn_torch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    try:
        mesh = train.make_data_mesh(2, device="cuda")
        results = {}
        for dtype in ("float32", "bfloat16"):
            hp, state, data, flip, bits = dp_problem(torch, seed, batch, torch.device("cuda"),
                                                     dtype)
            alone = copy.deepcopy(state)
            state = train.replicate(mesh, state)
            _, m = train.make_train_step(hp, mesh=mesh)(
                state, *train.shard_batch(mesh, *data), flip=flip, rand_bits=bits)
            results[dtype] = {"metrics": {k: v.cpu() for k, v in m.items()},
                              "tensors": {k: v.cpu() for k, v in state.model.state_dict().items()}}
            if rank == 0:
                rows = slice(0, batch // 2)
                _, ma = train.make_train_step(hp)(
                    alone, *train.shard_batch(mesh, *data), flip=flip[rows], rand_bits=bits[rows])
                results[dtype]["alone"] = ({k: v.cpu() for k, v in ma.items()},
                                           {k: v.cpu() for k, v in alone.model.state_dict().items()})
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def data_parallel_phase(torch, args, dev, kernels, cli, tmp):
    """The mesh paths on the card: two ranks on the one card over gloo
    (spawned) against the single-device step; the mesh step, eval loss and
    predict over NCCL with one rank, bit for bit against one device (cuDNN
    deterministic); then the trainer CLI with --device-data --data-parallel."""
    import copy

    import torch.multiprocessing as mp

    from tpurpn_torch import make_predict_fn, train

    B = args.train_batch
    out = {"phase": "data_parallel", "batch": B, "backbone": "mobilenet_v2", "img_size": 500}
    # 1. two ranks, gloo, CUDA tensors: the cross-rank BatchNorm on the card
    store, result = str(Path(tmp) / "store"), str(Path(tmp) / "two_ranks.pt")
    t0 = time.perf_counter()
    ctx = mp.start_processes(two_rank_worker, args=(store, result, args.seed, B), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError("chip_smoke check failed: the two-rank step timed out")
    out["two_ranks_wall_s"] = time.perf_counter() - t0
    two = torch.load(result, weights_only=True)
    for dtype in ("float32", "bfloat16"):
        hp, state, data, flip, bits = dp_problem(torch, args.seed, B, dev, dtype)
        before = copy.deepcopy(state.model.state_dict())
        _, m = train.make_train_step(hp)(state, *data, flip=flip, rand_bits=bits)
        got, ref = two[dtype], state.model.state_dict()
        gaps = step_gaps(got["metrics"], got["tensors"], m, ref)
        alone = step_gaps(*got["alone"], m, ref)
        out[f"two_ranks_gloo_{dtype}"] = {
            "loss": float(got["metrics"]["loss"]), "loss_single_device": float(m["loss"]),
            "num_pos": int(m["num_pos"]), **gaps, "limits": STEP_LIMITS[dtype],
            "control_without_reduction": alone,
            "control_averaged_gradients_params": half_update(before, ref)}
        require(int(got["metrics"]["num_pos"]) == int(m["num_pos"]),
                f"two ranks ({dtype}): num_pos differs")
        check_mesh_step("two ranks", dtype, gaps, alone)

    # 2. one rank over NCCL: the mesh paths against one device, bit for bit
    mesh = train.make_data_mesh(device="cuda")
    out["backend"] = torch.distributed.get_backend()
    hp, state, data, flip, bits = dp_problem(torch, args.seed, B, dev)
    mstate = train.replicate(mesh, copy.deepcopy(state))
    with deterministic_cudnn(torch):
        _, m1 = train.make_train_step(hp)(state, *data, flip=flip, rand_bits=bits)
        reset(kernels)
        _, mm = train.make_train_step(hp, mesh=mesh)(
            mstate, *train.shard_batch(mesh, *data), flip=flip, rand_bits=bits)
        torch.cuda.synchronize()
        launches = counts(kernels)
    require(launches["targets"] == 1, f"mesh step launches {launches}")
    for k in m1:
        require(torch.equal(m1[k], mm[k]), f"one-rank mesh step differs in {k}")
    for (k, a), b in zip(state.model.state_dict().items(), mstate.model.state_dict().values()):
        require(torch.equal(a, b), f"one-rank mesh step differs in {k}")
    words = torch.randint(-(2**31), 2**31, (B, 2, hp.total_anchors), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(args.seed + 9))
    e1 = train.make_eval_loss_fn(hp)(state, *data, rand_bits=words)
    em = train.make_eval_loss_fn(hp, mesh=mesh)(mstate, *train.shard_batch(mesh, *data),
                                                rand_bits=words)
    require(torch.equal(e1, em), f"one-rank mesh eval loss {float(em)} vs {float(e1)}")
    images = torch.rand((B, 500, 500, 3), generator=torch.Generator().manual_seed(3)).to(dev)
    p1 = make_predict_fn(state.model, hp, device=dev)(images)
    reset(kernels)
    pm = make_predict_fn(mstate.model, hp, device=dev, mesh=mesh)(train.shard_batch(mesh, images))
    torch.cuda.synchronize()
    launches_predict = counts(kernels)
    require(launches_predict["proposals"] == 1, f"mesh predict launches {launches_predict}")
    for k in p1:
        require(torch.equal(p1[k], pm[k]), f"one-rank mesh predict differs in {k}")
    out["one_rank_nccl"] = {"step": "bit-equal", "eval_loss": float(em), "predict": "bit-equal",
                            "launches_step": launches, "launches_predict": launches_predict,
                            "cudnn": "deterministic"}

    # 3. the trainer CLI, device-resident and data-parallel, on that group
    steps, val_batches = 5, 256 // B
    graphs, made = [], cli.make_scan_train_steps

    def recorded(*a, **k):  # the CLI's scan runs, for their graphs' counts
        run = made(*a, **k)
        graphs.append(run.graph)
        return run

    cli.make_scan_train_steps = recorded
    reset(kernels)
    t0 = time.perf_counter()
    try:
        text = run_cli(cli.trainer_main,
                       ["--backbone", "mobilenet_v2", "--batch-size", str(B), "--epochs", "1",
                        "--steps-per-epoch", str(steps), "--device-data", "--data-parallel",
                        "--output-dir", str(Path(tmp) / "dp")], tmp)
    finally:
        cli.make_scan_train_steps = made
    torch.cuda.synchronize()
    launches = counts(kernels)
    require("sharded over 1 ranks" in text and "saved best checkpoint" in text,
            f"trainer --device-data --data-parallel: {text[-400:]!r}")
    epoch = re.search(r"loss=([0-9.naninf]+) val_loss=([0-9.]+)", text)
    require(epoch is not None and math.isfinite(float(epoch.group(1))), f"epoch line: {text[-300:]!r}")
    # one 5-step chunk: an eager step, one capture and 4 replays; then 32
    # validation batches
    captures, replays = sum(g.captures for g in graphs), sum(g.replays for g in graphs)
    require(len(graphs) == 1 and captures == 1 and replays == steps - 1,
            f"trainer CLI: {len(graphs)} scan runs, {captures} captures, {replays} replays")
    require(launches["targets"] == 2 + val_batches, f"trainer CLI launches {launches}")
    executions = target_executions(launches["targets"], graphs)
    require(executions == steps + val_batches, f"trainer CLI: {executions} target executions")
    torch.distributed.destroy_process_group()
    out["trainer_cli"] = {"steps": steps, "loss": float(epoch.group(1)),
                          "val_loss": float(epoch.group(2)), "launches_counter": launches,
                          "graph_captures": captures, "graph_replays": replays,
                          "targets_executions": executions,
                          "wall_s": time.perf_counter() - t0}
    return out


def graph_steps_ms(torch, hp, data, batch, seed, steps, mesh=None):
    """ms per step of ``make_scan_train_steps`` (replays; the first call's
    eager step and capture are not timed) and of the eager mesh or
    single-device step on the same rows."""
    from tpurpn_torch import create_train_state, get_model, init_model, make_scan_train_steps, train

    dev = data[0].device
    model = init_model(get_model(hp), torch.Generator().manual_seed(seed), device=dev)
    state = create_train_state(hp, model=model)
    if mesh is not None:
        state = train.replicate(mesh, state)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    run = make_scan_train_steps(hp, batch_size=batch, num_steps=steps, mesh=mesh)
    run(state, gen, *data)
    replay = time_ms(torch, lambda: run(state, gen, *data), 3, warmup=1) / steps
    step = train.make_train_step(hp, mesh=mesh)
    per = batch if mesh is None else batch // mesh.size()  # this rank's rows a step
    rows = [torch.arange(per, device=dev) + (s * per) % data[0].shape[0] for s in range(steps)]

    def eager():
        for r in rows:
            step(state, *(t[r] for t in data), gen)

    return replay, time_ms(torch, eager, 3, warmup=1) / steps


def multichip_worker(rank, n, store, out, seed, batch, frames, steps):
    """One of ``n`` NCCL ranks, one a GPU: the mesh step of ``dp_problem``
    (global batch ``batch``) against one device on every rank, then the
    device-resident graph steps at ``batch`` rows a rank (weak scaling)."""
    import copy

    import torch
    import torch.distributed as dist
    from tpurpn_torch import get_hyper_params, train
    from tpurpn_torch.data import SyntheticVOC

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, n), rank=rank, world_size=n)
    try:
        mesh = train.make_data_mesh(n, device="cuda")
        dev = torch.device("cuda", rank)
        res = {"rank_device": torch.cuda.get_device_name(dev)}
        for dtype in ("float32", "bfloat16"):
            hp, state, data, flip, bits = dp_problem(torch, seed, batch, dev, dtype)
            single, alone = copy.deepcopy(state), copy.deepcopy(state)
            before = copy.deepcopy(state.model.state_dict())
            state = train.replicate(mesh, state)
            _, m = train.make_train_step(hp, mesh=mesh)(
                state, *train.shard_batch(mesh, *data), flip=flip, rand_bits=bits)
            _, m1 = train.make_train_step(hp)(single, *data, flip=flip, rand_bits=bits)
            ref = single.model.state_dict()
            rows = slice(rank * batch // n, (rank + 1) * batch // n)
            _, ma = train.make_train_step(hp)(alone, *train.shard_batch(mesh, *data),
                                              flip=flip[rows], rand_bits=bits[rows])
            res[f"step_{dtype}"] = {
                **step_gaps(m, state.model.state_dict(), m1, ref),
                "num_pos_equal": int(m["num_pos"]) == int(m1["num_pos"]),
                "control_without_reduction": step_gaps(ma, alone.model.state_dict(), m1, ref),
                "control_averaged_gradients_params": half_update(before, ref)}
        for backbone in ("vgg16", "mobilenet_v2"):
            hp = get_hyper_params(backbone)
            data = train.shard_batch(mesh, *next(
                SyntheticVOC(num_samples=frames * n, seed=seed).batches(frames * n)))
            replay, eager = graph_steps_ms(torch, hp, data, batch * n, seed, steps, mesh)
            res[f"graph_{backbone}"] = {"ms_per_step_replay": replay, "ms_per_step_eager": eager}
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


def multichip(torch, args, smi, tmp):
    """``--ranks N``: the data-parallel paths over N GPUs with NCCL, one rank
    a GPU: the mesh step against one device (within STEP_LIMITS; a step
    without reduction outside them), the
    graph steps at 8 rows a rank against one GPU at 8 rows (weak scaling),
    and the trainer under ``torch.distributed.run``."""
    import torch.multiprocessing as mp

    from tpurpn_torch import get_hyper_params
    from tpurpn_torch.data import SyntheticVOC

    n, B, frames, steps = args.ranks, args.train_batch, 64, 8
    require(torch.cuda.device_count() >= n, f"--ranks {n} needs {n} GPUs, "
            f"{torch.cuda.device_count()} visible")
    out = {"phase": "multichip_data_parallel", "ranks": n, "batch_per_rank": B,
           "backend": "nccl", "nvidia_smi": smi}
    for backbone in ("vgg16", "mobilenet_v2"):  # one GPU, batch B: the reference
        data = tuple(torch.from_numpy(a).cuda() for a in next(
            SyntheticVOC(num_samples=frames, seed=args.seed).batches(frames)))
        replay, eager = graph_steps_ms(torch, get_hyper_params(backbone), data, B, args.seed,
                                       steps)
        out[f"one_gpu_{backbone}"] = {"ms_per_step_replay": replay, "ms_per_step_eager": eager}
    result = str(Path(tmp) / "ranks.pt")
    t0 = time.perf_counter()
    ctx = mp.start_processes(multichip_worker,
                             args=(n, str(Path(tmp) / "store"), result, args.seed, B, frames,
                                   steps),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError("chip_smoke check failed: the multi-GPU ranks timed out")
    out["ranks_wall_s"] = time.perf_counter() - t0
    res = torch.load(result, weights_only=True)
    for dtype in ("float32", "bfloat16"):
        e = res[f"step_{dtype}"]
        require(e["num_pos_equal"], f"{n} ranks ({dtype}): num_pos differs")
        check_mesh_step(f"{n} ranks", dtype, e, e["control_without_reduction"])
        out[f"step_{dtype}"] = {**e, "limits": STEP_LIMITS[dtype]}
    for backbone in ("vgg16", "mobilenet_v2"):
        g, one = res[f"graph_{backbone}"], out[f"one_gpu_{backbone}"]
        out[f"ranks_{backbone}"] = {
            **g, "global_batch": B * n,
            "img_per_s_replay": B * n / g["ms_per_step_replay"] * 1e3,
            "weak_scaling_efficiency_replay": one["ms_per_step_replay"] / g["ms_per_step_replay"],
            "weak_scaling_efficiency_eager": one["ms_per_step_eager"] / g["ms_per_step_eager"]}
    # the trainer as users launch it
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", str(REPO / "rpn_trainer_torch.py"), "--backbone",
           "mobilenet_v2", "--batch-size", str(B * n), "--epochs", "1", "--steps-per-epoch",
           "5", "--data-parallel", "--device-data", "--output-dir", str(Path(tmp) / "out")]
    r = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr, flush=True)
    require(r.returncode == 0 and f"data-parallel over {n} ranks" in r.stdout
            and "saved best checkpoint" in r.stdout, f"torchrun trainer: rc {r.returncode}")
    epoch = re.search(r"loss=([0-9.naninf]+) val_loss=([0-9.]+)", r.stdout)
    require(epoch is not None and math.isfinite(float(epoch.group(1))), "torchrun epoch line")
    out["torchrun_trainer"] = {"loss": float(epoch.group(1)), "val_loss": float(epoch.group(2)),
                               "wall_s": time.perf_counter() - t0,
                               "lines": r.stdout.count("[tpurpn_torch]")}
    return out


@contextlib.contextmanager
def deterministic_cudnn(torch):
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def s2d_serving_phase(torch, args, dev, kernels, folded, trained, data):
    """``make_predict_fn(fast=True, from_uint8=True)`` on 375x500 uint8
    frames at batch B: routed through ``fast_uint8_forward`` (counted), its
    head outputs within the bf16 tolerance of preprocess_batch +
    ``fast_mobilenet_forward``, recall@300 of the trained weights over the
    256 test frames within RECALL_TOL of tpurpn's, and both routes timed."""
    from tpurpn_torch import get_hyper_params, inference, make_predict_fn
    from tpurpn_torch.data import preprocess_batch
    from tpurpn_torch.eval import proposal_recall

    B = args.batch
    hp = get_hyper_params("mobilenet_v2")
    calls = []
    real = inference.fast_uint8_forward

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    out = {"phase": "s2d_serving", "batch": B, "raw": [375, 500], "img_size": hp.img_size}
    test = data.get_dataset("synthetic", "test", max_boxes=64)
    inference.fast_uint8_forward = counted
    try:
        for name, model in (("random", folded), ("trained", trained)):
            u8 = make_predict_fn(model, hp, fast=True, from_uint8=True, device=dev)
            bf16 = make_predict_fn(model, hp, fast=True, device=dev)
            frames = torch.from_numpy(next(test.batches(B))[0]).to(dev)

            def pre_route():
                x, _ = preprocess_batch(frames, torch.zeros((B, 1, 4), device=dev), hp.img_size,
                                        dtype=torch.bfloat16)
                return bf16(x)

            del calls[:]
            reset(kernels)
            o = u8(frames)
            torch.cuda.synchronize()
            launches, stem_calls = counts(kernels), len(calls)
            require(stem_calls == 1 and launches["ir_stage"] == 7 and launches["proposals"] == 1,
                    f"s2d route ({name}): {stem_calls} stem calls, launches {launches}")
            check_proposals(torch, o, B, hp.test_nms_topn)
            with torch.no_grad():
                x, _ = preprocess_batch(frames, torch.zeros((B, 1, 4), device=dev), hp.img_size,
                                        dtype=torch.bfloat16)
                ref = inference.fast_mobilenet_forward(model, x)
                got = real(model, frames)
            errs = [close_err(g, r) for g, r in zip(got, ref)]
            require(all(ok for _, ok in errs), f"s2d head outputs ({name}): {errs}")
            rec = gt = 0
            for imgs, boxes, labels in test.batches(B):
                imgs, boxes, labels = (torch.from_numpy(a).to(dev) for a in (imgs, boxes, labels))
                pr = u8(imgs)
                r = proposal_recall(pr["roi_boxes"], pr["num_valid"], boxes, labels)
                rec += int(r["num_recalled"])
                gt += int(r["num_gt"])
            s2d_ms = time_ms(torch, lambda: u8(frames), 5)
            pre_ms = time_ms(torch, pre_route, 5)
            busy, ops = device_profile(torch, lambda: u8(frames))
            out[name] = {"stem_calls": stem_calls, "launches": launches,
                         "rpn_reg_max_abs_err": errs[0][0], "rpn_cls_max_abs_err": errs[1][0],
                         "recall": rec / gt, "gt": gt, "ms_per_batch_s2d": s2d_ms,
                         "ms_per_batch_preprocess_route": pre_ms,
                         "device_busy_ms_s2d": busy, "device_ops_s2d": ops}
            if name == "trained":
                require(gt == REF_GT_TEST and abs(rec / gt - REF_RECALL_TEST) <= RECALL_TOL,
                        f"s2d route recall {rec / gt} over {gt} GT vs tpurpn's {REF_RECALL_TEST}")
    finally:
        inference.fast_uint8_forward = real
    out["tolerance"] = f"rel {TOL_REL} of max(1, |ref|max); recall within {RECALL_TOL}"
    return out


def serving_640_phase(torch, args, dev, kernels, smi):
    """Fast serving at 640x640 (MobileNetV2, the 40x40 tap, 14,400 anchors)
    through the entry points: ``make_predict_fn(fast=True)`` on B bf16
    images and ``make_predict_fn(fast=True, from_uint8=True)`` on B uint8
    480x640 frames (the s2d route), each with every count at 0 just before
    it: 7 IR-stage launches and 1 proposal launch a batch, proposals well
    formed; the fast heads within the bf16 tolerance of the unfused folded
    forward (the uint8 route's against preprocess_batch + the unfused
    forward); the IR-stage kernel at S = 40 against its plain version and
    the proposal kernel at N = 14,400 against its own, bit for bit; then ms a
    batch, the card's busy time, and where the time goes."""
    from tpurpn_torch import fold_batch_norm, get_hyper_params, get_model, init_model, inference
    from tpurpn_torch.anchors import generate_anchors
    from tpurpn_torch.data import preprocess_batch
    from tpurpn_torch.inference import _FUSED_BLOCKS as SERVING_BLOCKS
    from tpurpn_torch.kernels import ir_stage as ir_stage_module
    from tpurpn_torch.kernels.ir_stage import stage_weights_cached
    from tpurpn_torch.kernels.proposal import fused_proposals, fused_proposals_plain
    from tpurpn_torch.model import apply_rpn_head, to_device
    from tpurpn_torch.predict import decode_outputs, make_predict_fn

    B = args.batch
    hp = get_hyper_params("mobilenet_v2", img_size=640)
    require(hp.feature_map_shape == 40 and hp.total_anchors == 14400,
            f"640 px: a {hp.feature_map_shape} tap, {hp.total_anchors} anchors")
    gen = torch.Generator().manual_seed(args.seed)
    model = get_model(hp)
    init_model(model, gen, device="cpu")
    perturb_batch_norm(model, gen, torch)
    folded = fold_batch_norm(to_device(model, dev))
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 640)
    images = torch.rand((B, 640, 640, 3), generator=dgen, device=dev).to(torch.bfloat16)
    frames = torch.randint(0, 256, (B, 480, 640, 3), generator=dgen, device=dev,
                           dtype=torch.uint8)
    require(inference.s2d_stem_supported(hp, frames.shape), "480x640 frames must take s2d")
    pre, topn, thr = min(hp.pre_nms_topn, hp.total_anchors), hp.test_nms_topn, hp.nms_iou_threshold
    predict = make_predict_fn(folded, hp, fast=True, device=dev)
    predict_u8 = make_predict_fn(folded, hp, fast=True, from_uint8=True, device=dev)
    out = {"phase": "serving_640", "batch": B, "img_size": 640, "raw": [480, 640],
           "tap": 40, "anchors": hp.total_anchors, "pre": pre, "topn": topn, "nvidia_smi": smi,
           "tolerance": f"rel {TOL_REL} of max(1, |ref|max)"}
    for variant, fn, x in (("bf16", predict, images), ("uint8", predict_u8, frames)):
        reset(kernels)
        o = fn(x)
        torch.cuda.synchronize()
        launches = counts(kernels)
        require(launches["ir_stage"] == 7 and launches["proposals"] == 1,
                f"640 serving ({variant}) launches {launches}")
        check_proposals(torch, o, B, topn)
        out[f"main_path_{variant}"] = {"call": "eager", "launches": launches,
                                       "num_valid_min": int(o["num_valid"].min()),
                                       "num_valid_mean": float(o["num_valid"].float().mean())}

    with torch.no_grad():
        ref_reg, ref_cls = folded(images)
        fast_reg, fast_cls = inference.fast_mobilenet_forward(folded, images)
        x_pre, _ = preprocess_batch(frames, torch.zeros((B, 1, 4), device=dev), 640,
                                    dtype=torch.bfloat16)
        u8_ref = folded(x_pre)
        u8_got = inference.fast_uint8_forward(folded, frames)
        for name, got, ref in (("bf16_rpn_reg", fast_reg, ref_reg),
                               ("bf16_rpn_cls", fast_cls, ref_cls),
                               ("uint8_rpn_reg", u8_got[0], u8_ref[0]),
                               ("uint8_rpn_cls", u8_got[1], u8_ref[1])):
            err, ok = close_err(got, ref)
            require(ok and bool(torch.isfinite(got).all()),
                    f"640 fast heads vs the unfused forward, {name}: max abs err {err}")
            out[f"{name}_max_abs_err"] = err

        # the kernels at this size against their plain versions; the IR stage
        # also at the 750 and 1000 px taps (S = 47, 63) on random inputs
        feat6 = folded.backbone(images, stop_after_block=6).contiguous()
        weights, blocks = stage_weights_cached(folded.backbone, SERVING_BLOCKS,
                                               tail_expand="block_13_expand")
        feat = ir_stage_module.fused_ir_stage(feat6, weights, blocks)
        require(feat.shape == (B, 40, 40, 576), f"IR stage at S=40: {tuple(feat.shape)}")
        wide = {40: ir_wide_stage(torch, ir_stage_module, feat6, weights, blocks)}
        for S in (47, 63):
            x = (torch.rand((B, S, S, 64), generator=dgen, device=dev) * 2 - 1).to(torch.bfloat16)
            wide[S] = ir_wide_stage(torch, ir_stage_module, x, weights, blocks)
            del x
        anchors = generate_anchors(hp, dev)
        boxes, scores = decode_outputs(anchors, ref_reg, ref_cls, hp)
        pk = fused_proposals(boxes, scores, pre, thr, topn)
        pp = fused_proposals_plain(boxes, scores, pre, thr, topn)
        for k in pp:
            require(torch.equal(pk[k], pp[k]), f"proposal kernel vs plain at N=14,400: {k}")

        pr_ms = time_ms(torch, lambda: fused_proposals(boxes, scores, pre, thr, topn), 20)
        pr_device, pr_wrapper_device = kernel_device_ms(
            torch, lambda: fused_proposals(boxes, scores, pre, thr, topn), ("proposal_kernel",),
            fused_proposals)
        pr_bound, pr_by, visited = proposal_bound(torch, boxes, scores, pre, topn, thr)
        stages = {
            "prefix_to_block_6": time_ms(
                torch, lambda: folded.backbone(images, stop_after_block=6), 5),
            "ir_stage_kernel": wide[40]["ms"],
            "head": time_ms(torch, lambda: apply_rpn_head(folded, feat), 5),
            "decode": time_ms(torch, lambda: decode_outputs(anchors, ref_reg, ref_cls, hp), 5),
            "proposals_wrapper": pr_ms,
            "s2d_stem": time_ms(torch, lambda: inference.s2d_uint8_stem(folded, frames), 5),
        }
        for name, fn, x in (("fast_bf16", predict, images), ("fast_uint8", predict_u8, frames)):
            ms = time_ms(torch, lambda: fn(x), 5)
            busy, ops = device_profile(torch, lambda: fn(x))
            out[f"end_to_end_{name}"] = {
                "ms_per_batch": ms, "img_per_s": B / ms * 1e3, "device_busy_ms": busy,
                "device_ops": ops, "device_idle_share": None if busy is None else 1.0 - busy / ms}
    out["stages_ms"] = stages
    for S, stage in wide.items():
        out[f"ir_stage_s{S}"] = stage
    out["proposals_n14400"] = {"ms": pr_ms, "device_ms": pr_device,
                               "wrapper_device_ms": pr_wrapper_device, "bound_ms": pr_bound,
                               "bound_by": pr_by, "match": "bit-exact",
                               "visited_mean": float(visited.float().mean())}
    return out


def run_cli(main, argv, cwd):
    """Run a CLI entry point in process from ``cwd``; returns what it printed."""
    buf = io.StringIO()
    with contextlib.chdir(cwd), contextlib.redirect_stdout(buf):
        main(argv)
    text = buf.getvalue()
    print(text, file=sys.stderr, end="", flush=True)
    return text


def read_recall(text):
    m = RECALL_LINE.search(text)
    require(m is not None, f"no recall line in the predictor's output: {text[-500:]!r}")
    return int(m.group(1)), float(m.group(2)), int(m.group(3))


def read_png(path):
    """Decode the 8-bit RGB PNG the port writes (one or more IDAT chunks,
    filter byte 0 on every row) into (H, W, 3) bytes, checking the chunk
    CRCs."""
    data = Path(path).read_bytes()
    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, dims = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        require(crc == zlib.crc32(kind + body) & 0xFFFFFFFF, f"{path}: bad {kind} CRC")
        if kind == b"IHDR":
            dims = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    require(dims is not None and dims[2:4] == (8, 2), f"{path}: not 8-bit RGB: {dims}")
    w, h = dims[0], dims[1]
    rows = zlib.decompress(idat)
    require(len(rows) == h * (1 + 3 * w), f"{path}: {len(rows)} bytes for {w}x{h}")
    import numpy as np

    pix = np.frombuffer(rows, np.uint8).reshape(h, 1 + 3 * w)
    require(not pix[:, 0].any(), f"{path}: filtered rows")
    return pix[:, 1:].reshape(h, w, 3)


def native_build(native):
    """Build the native generator with g++; its version and the seconds."""
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()[0]
    prebuilt = native.library_path().exists()
    t0 = time.perf_counter()
    require(native.available(), "the native generator did not build")
    return {"gxx": gxx, "prebuilt": prebuilt, "build_s": time.perf_counter() - t0,
            "library": native.library_path().name}


def native_loader_phase(native):
    """Time a batch of 128 375x500 frames of the native generator, hold its
    bytes to tpurpn's and check two calls agree."""
    import numpy as np

    idx = np.arange(128)
    native.generate_batch(1, idx, 375, 500, 8, 1, 20)  # warm: page in the buffers
    t0 = time.perf_counter()
    a = native.generate_batch(1, idx, 375, 500, 8, 1, 20)
    batch_ms = (time.perf_counter() - t0) * 1e3
    b = native.generate_batch(1, idx, 375, 500, 8, 1, 20)
    require(all(np.array_equal(x, y) for x, y in zip(a, b)), "native batches differ between calls")
    crc = 0
    for x in native.generate_batch(1, idx[:8], 375, 500, 8, 1, 20):
        crc = zlib.crc32(np.ascontiguousarray(x).tobytes(), crc)
    require(crc == NATIVE_CRC_SEED1,
            f"native bytes crc32 {crc:#x} != tpurpn's {NATIVE_CRC_SEED1:#x}")
    for x, y in zip(native.generate_batch(1, idx[:8], 375, 500, 8, 1, 20), a):
        require(np.array_equal(x, y[:8]), "a batch's first 8 frames differ from the 8 alone")
    return {"phase": "native_loader", "cpu_count": os.cpu_count(), "batch": 128, "raw": [375, 500], "batch_ms_host": batch_ms,
            "img_per_s_host": 128 / batch_ms * 1e3, "crc32_seed1_0_7": f"{crc:#010x}",
            "deterministic": True}


def predictor_trained_phase(torch, kernels, cli, batch, tmp, img_size=500, variants=(True, False),
                            ref_recall=REF_RECALL_TEST):
    """The predictor CLI on the trained weights over the 256 test frames at
    ``img_size``, with --fast and without (``variants``): host launches,
    recall against tpurpn's (``ref_recall``), the PNG."""
    out = {"phase": "predictor_trained" + ("" if img_size == 500 else f"_{img_size}"),
           "weights": str(TRAINED_NPZ.relative_to(REPO)), "img_size": img_size,
           "frames": "SyntheticVOC test (seed 2), native", "max_boxes": 64, "batch": batch,
           "ref_recall": ref_recall, "tolerance": RECALL_TOL}
    batches = 256 // batch
    for fast in variants:
        name = "fast" if fast else "plain_backbone"
        png = Path(tmp) / "proposals_mobilenet_v2.png"
        if png.exists():
            png.unlink()
        reset(kernels)
        t0 = time.perf_counter()
        text = run_cli(cli.predictor_main,
                       ["--backbone", "mobilenet_v2", "--weights", str(TRAINED_NPZ),
                        "--batch-size", str(batch), "--img-size", str(img_size),
                        "--output-dir", str(tmp)]
                       + (["--fast"] if fast else []),
                       tmp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(kernels)
        topn, recall, n_gt = read_recall(text)
        require("ignoring" not in text, f"predictor dropped --fast: {text[-300:]!r}")
        # host launches: with --fast an eager call and the capture, then
        # replays, which launch nothing from the host
        calls = min(batches, 2) if fast else batches
        require(launches["ir_stage"] == (7 * calls if fast else 0)
                and launches["proposals"] == calls and launches["targets"] == 0,
                f"predictor ({name}, {img_size}) launches {launches}")
        require(topn == 300 and n_gt == REF_GT_TEST, f"predictor ({name}): {n_gt} GT boxes")
        require(abs(recall - ref_recall) <= RECALL_TOL,
                f"predictor ({name}, {img_size}) recall {recall} vs tpurpn's {ref_recall}")
        pixels = read_png(png)
        red = int((pixels == (255, 40, 40)).all(-1).sum())
        require(pixels.shape == (img_size, img_size, 3) and red > 0,
                f"predictor ({name}) PNG {pixels.shape}, {red} outline pixels")
        out[name] = {"recall": recall, "gt": n_gt, "launches": launches, "wall_s": wall,
                     "png": list(pixels.shape), "png_outline_pixels": red}
    return out


def trainer_cli_phase(torch, kernels, cli, data, batch, tmp):
    """The trainer CLI for 5 steps with recall every epoch, then the
    predictor CLI on its checkpoint."""
    steps, bs = 5, 8
    val_batches = len(data.get_dataset("synthetic", "validation")) // bs
    reset(kernels)
    t0 = time.perf_counter()
    text = run_cli(cli.trainer_main,
                   ["--backbone", "mobilenet_v2", "--img-size", "500", "--batch-size", str(bs),
                    "--epochs", "1", "--steps-per-epoch", str(steps), "--eval-recall-every", "1",
                    "--output-dir", str(Path(tmp) / "trained")], tmp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernels)
    ckpt = Path(tmp) / "trained" / "rpn_mobilenet_v2"
    require((ckpt / "state.pt").is_file(), f"no checkpoint at {ckpt}")
    require("saved best checkpoint" in text and "val_recall@300=" in text,
            f"trainer output: {text[-400:]!r}")
    require(launches["targets"] == steps + val_batches,
            f"trainer: {launches['targets']} target launches for {steps} steps + {val_batches} "
            "validation batches")
    require(launches["proposals"] == val_batches, f"trainer recall launches {launches}")
    epoch = re.search(r"loss=([0-9.naninf]+) val_loss=([0-9.]+) val_recall@300=([0-9.]+)", text)
    require(epoch is not None and math.isfinite(float(epoch.group(1))),
            f"trainer epoch line: {text[-400:]!r}")
    reset(kernels)
    ptext = run_cli(cli.predictor_main, ["--backbone", "mobilenet_v2", "--weights", str(ckpt),
                                         "--batch-size", str(batch), "--output-dir", str(tmp)], tmp)
    torch.cuda.synchronize()
    _, recall, n_gt = read_recall(ptext)
    require("restored checkpoint" in ptext and n_gt == REF_GT_TEST, f"predictor: {ptext[-300:]!r}")
    return {"phase": "trainer_cli", "steps": steps, "batch": bs, "val_batches": val_batches,
            "launches": launches, "loss": float(epoch.group(1)), "val_loss": float(epoch.group(2)),
            "val_recall": float(epoch.group(3)), "wall_s": wall,
            "checkpoint_bytes": (ckpt / "state.pt").stat().st_size,
            "predictor_on_checkpoint": {"recall": recall, "gt": n_gt,
                                        "launches": counts(kernels)}}


def ulp_err(got, ref):
    """(max |got - ref|, within one bf16 ulp of max(1, |ref|max) plus one of
    |ref|): the f32 summation order of a 1x1 product before its one bf16
    rounding."""
    got, ref = got.float(), ref.float()
    scale = max(1.0, float(ref.abs().max()))
    err = (got - ref).abs()
    return float(err.max()), float((err - BF16_ULP * (scale + ref.abs())).max()) <= 0.0


def prefix_phase(torch, folded, frames, dev):
    """The serving prefix's kernels (``kernels/prefix.py``) at the serving
    shapes: the Conv1 activations of B uint8 frames through the s2d stem,
    then each of the 20 convolutions of expanded_conv .. block_6 in turn on
    the kernel's own output. Each launch against its plain version (the
    depthwise bit for bit, the 1x1 within one bf16 ulp) and against the
    module's ops for the same conv (cuDNN's conv with its bias add, and its
    pad at stride 2, then clamp and the residual add: the yardstick, which
    the port no longer calls) at the bf16 tolerance; each timed with CUDA
    events beside its bound (its input, residual and output bytes over
    PEAK_BYTES), its plain version and the yardstick. Then the whole walk
    against ``bb(x, stop_after_block=6, skip_stem=True)``, both timed and
    profiled; 13 prefix_pointwise and 7 prefix_depthwise host launches in a
    fast serving call's capture and none in a replay (the counters count
    host launches), and the kernels that a traced replay ran inside
    ``rpn.replay`` on the card (``REPLAYED``); and a traced first (eager)
    call of a fresh predict fn: no host op inside ``rpn.prefix`` that
    convolves, adds, clamps, fills, pads or copies, and the device
    operations inside it (kineto's device range of the span) those 20
    kernels alone; the serving call's ms with the prefix on the kernels and
    with the module's forward put back in its place."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpurpn_torch import inference, make_predict_fn, profiling
    from tpurpn_torch.backbones.mobilenet_v2 import relu6
    from tpurpn_torch.kernels import prefix as pk

    bb = folded.backbone
    B = frames.shape[0]
    out = {"phase": "prefix", "batch": B, "raw": list(frames.shape[1:3]),
           "tolerance": "depthwise bit-exact; 1x1 one bf16 ulp; yardstick and walk "
                        f"rel {TOL_REL} of max(1, |ref|max)"}
    rows = []
    with torch.no_grad():
        feat1 = inference.s2d_uint8_stem(folded, frames).contiguous()
        blocks = pk.pack_prefix(bb, inference._PREFIX_BLOCKS)
        x = feat1
        for name, (ex, dw, pj) in zip(inference._PREFIX_BLOCKS, blocks):
            blk = bb.get_submodule(name)
            block_in, h = x, x
            for part, op in ([("expand", ex)] if ex is not None else []) + [
                    ("depthwise", dw), ("project", pj)]:
                conv = blk.get_submodule(f"{name}_{part}")
                res = block_in if part == "project" and op.residual else None
                if part == "depthwise":
                    kern = lambda h=h, op=op: pk.prefix_depthwise(h, op)
                    plain = lambda h=h, op=op: pk.prefix_depthwise_plain(h, op)
                else:
                    kern = lambda h=h, op=op, res=res: pk.prefix_pointwise(h, op, res)
                    plain = lambda h=h, op=op, res=res: pk.prefix_pointwise_plain(h, op, res)

                def library(h=h, conv=conv, relu=part != "project", res=res):
                    y = conv(h.permute(0, 3, 1, 2))
                    y = (relu6(y) if relu else y).permute(0, 2, 3, 1)
                    return y + res if res is not None else y

                got, ref, lib = kern(), plain(), library()
                torch.cuda.synchronize()
                what = f"{name}_{part} {tuple(h.shape)} -> {tuple(got.shape)}"
                if part == "depthwise":
                    require(torch.equal(got, ref), f"prefix depthwise kernel vs plain: {what}")
                    err = float((got.float() - ref.float()).abs().max())
                else:
                    err, ok = ulp_err(got, ref)
                    require(ok, f"prefix 1x1 kernel vs plain: {what}: max abs err {err}")
                lib_err, lib_ok = close_err(got, lib)
                require(lib_ok, f"prefix kernel vs the module's conv: {what}: {lib_err}")
                nbytes = 2 * (h.numel() + got.numel() + (res.numel() if res is not None else 0))
                rows.append({"conv": f"{name}_{part}", "kernel": f"prefix_{'depthwise' if part == 'depthwise' else 'pointwise'}",
                             "spec": list(op.spec), "in": list(h.shape), "out": list(got.shape),
                             "max_abs_err": err, "library_max_abs_err": lib_err,
                             "ms": time_ms(torch, kern, 20), "bound_ms": nbytes / PEAK_BYTES * 1e3,
                             "plain_ms": time_ms(torch, plain, 2, 1),
                             "library_ms": time_ms(torch, library, 20)})
                h = got
            x = h
        for r in rows:
            r["bound_share"] = r["bound_ms"] / r["ms"]
        out["convs"] = rows
        for k in ("prefix_pointwise", "prefix_depthwise"):
            mine = [r for r in rows if r["kernel"] == k]
            out[k] = {f: sum(r[f] for r in mine) for f in ("ms", "bound_ms", "plain_ms",
                                                          "library_ms")}
            out[k]["convs"] = len(mine)

        def walk():
            return pk.prefix_blocks(feat1, blocks)

        def module():
            return bb(feat1, stop_after_block=6, skip_stem=True)

        err, ok = close_err(walk(), module())
        require(ok, f"prefix walk vs the module's forward: max abs err {err}")
        out["walk"] = {"max_abs_err": err, "ms": time_ms(torch, walk, 10),
                       "module_ms": time_ms(torch, module, 10)}
        out["walk"]["device_busy_ms"], out["walk"]["device_ops"] = device_profile(torch, walk)
        out["walk"]["module_device_busy_ms"], out["walk"]["module_device_ops"] = (
            device_profile(torch, module))

    predict = make_predict_fn(folded, folded.hp, fast=True, from_uint8=True, device=dev)
    predict(frames)
    torch.cuda.synchronize()
    counters = {"prefix_pointwise": pk.prefix_pointwise, "prefix_depthwise": pk.prefix_depthwise}
    for call, want in (("capture", {"prefix_pointwise": 13, "prefix_depthwise": 7}),
                       ("replay", {"prefix_pointwise": 0, "prefix_depthwise": 0})):
        reset(counters)
        predict(frames)
        torch.cuda.synchronize()
        launches = counts(counters)
        require(launches == want, f"a fast serving call ({call}) launched {launches} "
                                  "from the host")
        out[f"host_launches_{call}"] = launches
    out["graph"] = {"eager_calls": predict.eager_calls, "captures": predict.captures,
                    "replays": predict.replays}
    require(out["graph"] == {"eager_calls": 1, "captures": 1, "replays": 1},
            f"three fast serving calls: {out['graph']}")
    out["replay_kernels"] = replay_kernels(torch, predict, frames)
    require(out["replay_kernels"] == REPLAYED,
            f"kernels inside rpn.replay in a traced replay: {out['replay_kernels']}")
    # a fresh predict fn's first call runs eager, its spans around its
    # launches (a replay opens rpn.upload and rpn.replay alone)
    traced = make_predict_fn(folded, folded.hp, fast=True, from_uint8=True, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            profiling._on(annotate=True):
        traced(frames)
        torch.cuda.synchronize()
    events = list(prof.events())
    host = [e for e in events if e.name == "rpn.prefix" and e.device_type == DeviceType.CPU]
    require(len(host) == 1, f"{len(host)} host ranges of rpn.prefix in the trace")
    inside, todo = set(), list(host[0].cpu_children)
    while todo:
        e = todo.pop()
        inside.add(e.name)
        todo += list(e.cpu_children)
    bad = sorted(n for n in inside if any(k in n.lower() for k in (
        "conv", "add", "clamp", "fill", "pad", "copy", "cudnn", "mul", "cat", "cast")))
    require(not bad, f"host operations inside rpn.prefix: {bad}")
    on_dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                     and not e.is_user_annotation), key=lambda e: e.time_range.start)
    # kineto's device range of the span: the operations launched in it
    ranges = [e for e in events if e.name == "rpn.prefix" and e.device_type == DeviceType.CUDA]
    require(len(ranges) == 1, f"{len(ranges)} device ranges of rpn.prefix in the trace")
    r0, r1 = ranges[0].time_range.start, ranges[0].time_range.end
    mine = [e for e in on_dev if e.time_range.start >= r0 and e.time_range.end <= r1]
    names = [e.name for e in mine]
    require(len(names) == 20 and all("prefix_pointwise_kernel" in n or "prefix_depthwise_kernel"
                                     in n for n in names),
            f"device operations inside rpn.prefix: {names}")
    out["trace"] = {"host_ops": sorted(inside), "device_ops": len(names),
                    "device_ms": sum(e.self_device_time_total for e in mine) / 1e3,
                    "host_ms": (host[0].time_range.end - host[0].time_range.start) / 1e3}
    out["serving_ms"] = time_ms(torch, lambda: predict(frames), 5)
    real = pk.prefix_blocks
    inference.prefix_blocks = lambda x, blocks: bb(x, stop_after_block=6, skip_stem=True)
    try:  # a fresh predict fn, whose graph holds the module's prefix
        module = make_predict_fn(folded, folded.hp, fast=True, from_uint8=True, device=dev)
        out["serving_ms_module_prefix"] = time_ms(torch, lambda: module(frames), 5)
    finally:
        inference.prefix_blocks = real
    return out


def kept_twice(torch, out):
    """(B,) the kept proposals of each image equal to one kept before them."""
    b, nv = out["roi_boxes"], out["num_valid"]
    valid = torch.arange(b.shape[1], device=b.device)[None] < nv[:, None]
    same = (b[:, :, None] == b[:, None]).all(-1) & valid[:, :, None] & valid[:, None]
    return torch.triu(same, diagonal=1).any(1).sum(1)


def vitdet_phase(torch, args, dev, batch: int = 16):
    """ViTDet-B's RPN at 1024 px served as users call it: seeded random
    weights (the objectness and delta convs drawn wider than detectron2's
    std 0.01, so that the logits spread over several units as a trained
    head's do) and ``make_predict_fn(from_uint8=True)`` on ``batch`` uint8
    480x640 SyntheticVOC frames in host memory. With every count at 0 just
    before: one ``proposal_kernel_levels`` launch, 8 window and 4 global
    attention cores and 4,768 candidates an image into NMS. The selection
    inputs that call handed ``fused_proposals`` are kept, and the kernel is
    held on them bit for bit against its plain version; the call's output is
    the kernel's (its scores through the sigmoid); then on those candidates
    twice over, the copies on levels of their own, against its plain
    version again: copies kept beside their boxes in every image, and none
    by the selection without levels. Times: the batch, the proposal wrapper,
    its sort and its kernel (CUDA events), the kernel's own device time and
    the batch's busy time (torch.profiler), the plain version, and the bound
    of the level-wise walk."""
    from tpurpn_torch import get_hyper_params, get_model, init_model
    from tpurpn_torch import predict as predict_module
    from tpurpn_torch.anchors import level_sizes
    from tpurpn_torch.backbones import vit
    from tpurpn_torch.data import SyntheticVOC
    from tpurpn_torch.kernels.nms import nms_keep
    from tpurpn_torch.kernels.proposal import (
        _select, fused_proposals, fused_proposals_plain, top_candidates)
    from tpurpn_torch.kernels.relpos_attention import relpos_attention
    from tpurpn_torch.model import to_device

    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    hp = get_hyper_params("vitdet_b")
    gen = torch.Generator().manual_seed(args.seed)
    model = init_model(get_model(hp), gen, device="cpu")
    with torch.no_grad():
        model.objectness.weight.normal_(0.0, 0.3, generator=gen)
        model.deltas.weight.normal_(0.0, 0.06, generator=gen)
    predict = predict_module.make_predict_fn(to_device(model, dev), hp, from_uint8=True, device=dev)
    frames = torch.from_numpy(next(SyntheticVOC(
        num_samples=batch, raw_h=480, raw_w=640, seed=args.seed).batches(batch))[0])
    require(frames.dtype == torch.uint8 and frames.shape == (batch, 480, 640, 3),
            f"frames {frames.dtype} {tuple(frames.shape)}")
    predict(frames)  # warm-up: the interpolated positions, cuDNN's plans
    torch.cuda.synchronize()

    seen, core_args = [], {}
    orig, orig_core = predict_module.fused_proposals, vit.attention_core

    def recorded(*a, levels=None, **k):
        out = orig(*a, levels=levels, **k)
        seen.append((a, levels, dict(out)))  # select_levels rebinds roi_scores in ``out``
        return out

    def recorded_core(*a):  # the first core of each kind: its q, k, v, tables, side
        core_args.setdefault(a[-1], a[:-1])
        return orig_core(*a)

    fused_proposals.launches = relpos_attention.launches = 0
    for kind in vit.attention_core.calls:
        vit.attention_core.calls[kind] = 0
    predict_module.select_levels.candidates = 0
    predict_module.fused_proposals, vit.attention_core = recorded, recorded_core
    try:
        out = predict(frames)
        torch.cuda.synchronize()
    finally:
        predict_module.fused_proposals, vit.attention_core = orig, orig_core
    launches = fused_proposals.launches
    attn_launches = relpos_attention.launches
    cores = dict(orig_core.calls)
    candidates = predict_module.select_levels.candidates
    topn, thr = hp.test_nms_topn, hp.nms_iou_threshold
    per_image = sum(min(hp.pre_nms_topn, n) for n in level_sizes(hp))
    n_global = len(hp.vit.global_blocks)
    require(launches == 1 and len(seen) == 1, f"vitdet serving: {launches} proposal launches")
    require(cores == {"window": hp.vit.depth - n_global, "global": n_global},
            f"vitdet attention cores {cores}")
    require(attn_launches == hp.vit.depth and sorted(core_args) == ["global", "window"],
            f"vitdet serving: {attn_launches} relpos_attention launches for {hp.vit.depth} cores")
    require(candidates == batch * per_image, f"vitdet candidates into NMS {candidates}")
    check_proposals(torch, out, batch, topn)
    (cand, score, pre, _, _), levels, k_out = seen[0]
    require(pre == per_image and levels is not None and levels.shape == (pre,),
            f"vitdet selection took pre={pre}, levels {None if levels is None else levels.shape}")
    with torch.no_grad():
        nms_keep.launches = 0
        p_out = fused_proposals_plain(cand, score, pre, thr, topn, levels=levels)
        torch.cuda.synchronize()
        require(nms_keep.launches == 0 and fused_proposals.launches == 1,
                "the level selection's plain version reached a kernel")
        for key in p_out:
            require(torch.equal(k_out[key], p_out[key]),
                    f"proposal_kernel_levels vs plain differ in {key}")
        valid = torch.arange(topn, device=dev)[None] < k_out["num_valid"][:, None]
        require(torch.equal(out["roi_boxes"], k_out["roi_boxes"])
                and torch.equal(out["num_valid"], k_out["num_valid"])
                and torch.equal(out["roi_scores"],
                                torch.where(valid, torch.sigmoid(k_out["roi_scores"]), 0.0)),
                "vitdet serving output is not its selection kernel's")
        # every candidate again on a level of its own: an exact copy (IoU 1)
        # is kept beside its box where levels part them, and never without
        twin = (torch.cat([cand, cand], 1).contiguous(), torch.cat([score, score], 1), 2 * pre,
                thr, topn)
        twin_levels = torch.cat([levels, levels + int(levels.max()) + 1])
        twin_k = fused_proposals(*twin, levels=twin_levels)
        twin_p = fused_proposals_plain(*twin, levels=twin_levels)
        for key in twin_p:
            require(torch.equal(twin_k[key], twin_p[key]),
                    f"proposal_kernel_levels vs plain on copied candidates differ in {key}")
        copies, copies_flat = kept_twice(torch, twin_k), kept_twice(torch, fused_proposals(*twin))
        require(bool((copies > 0).all()) and not bool(copies_flat.any()),
                f"copies on another level kept {copies.tolist()}, without levels "
                f"{copies_flat.tolist()}")

        order = top_candidates(score, pre)
        ms = time_ms(torch, lambda: predict(frames), 5, warmup=1)
        busy, ops = device_profile(torch, lambda: predict(frames), iters=3)
        pr_ms = time_ms(torch, lambda: fused_proposals(cand, score, pre, thr, topn,
                                                       levels=levels), 20)
        sort_ms = time_ms(torch, lambda: top_candidates(score, pre), 20)
        select_ms = time_ms(torch, lambda: _select(cand, score, order, thr, topn, levels), 20)
        plain_ms = time_ms(torch, lambda: fused_proposals_plain(cand, score, pre, thr, topn,
                                                                levels=levels), 3)
        device, wrapper_device = kernel_device_ms(
            torch, lambda: fused_proposals(cand, score, pre, thr, topn, levels=levels),
            ("proposal_kernel_levels",), fused_proposals)
    bound, by, visited = proposal_bound(torch, cand, score, pre, topn, thr, levels)
    peak = torch.cuda.max_memory_allocated()  # the served batches', before the checks below
    attention = {kind: attention_check(torch, relpos_attention, vit, *core_args[kind], n_cores)
                 for kind, n_cores in (("global", n_global),
                                       ("window", hp.vit.depth - n_global))}
    nv = k_out["num_valid"]
    phase = {"phase": "vitdet_serving", "batch": batch, "frames": "SyntheticVOC 480x640 uint8",
             "img_size": hp.img_size, "anchors": hp.total_anchors,
             "candidates_per_image": per_image, "topn": topn,
             "launches": {"proposals": launches, "relpos_attention": attn_launches},
             "attention_cores": cores, "attention": attention,
             "num_valid_min": int(nv.min()), "num_valid_mean": float(nv.float().mean()),
             "kernel_vs_plain": "bit-exact", "copies_kept_mean": float(copies.float().mean()),
             "ms_per_batch": ms, "img_per_s": batch / ms * 1e3,
             "device_busy_ms": busy, "device_ops": ops,
             "memory_peak_bytes": peak, "memory_held_before_bytes": held,
             "proposals": {"ms": pr_ms, "sort_ms": sort_ms, "select_ms": select_ms,
                           "device_ms": device, "wrapper_device_ms": wrapper_device,
                           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                           "visited_mean": float(visited.float().mean()),
                           "visited_max": int(visited.max())}}
    del predict, model, seen, cand, score, k_out, p_out, twin, twin_k, twin_p, out, core_args
    torch.cuda.empty_cache()
    return phase


def attention_bound(q, side, cores=1):
    """(bound ms, bound by) of ``cores`` attention cores over q's shape (N,
    h, side^2, d): q k^T, attention x v and the two q . R products at the
    bf16 peak, against q, k and v read, the output written and the two
    tables read once (bf16); as portbench's counts_levels.global_attn_bound."""
    n, h, t, d = q.shape
    ops = cores * n * h * (2 * 2 * t * t * d + 2 * 2 * t * side * d)
    nbytes = cores * (n * t * h * d * 2 * 4 + 2 * (2 * side - 1) * d * 2)
    op_ms, byte_ms = ops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def attention_check(torch, relpos_attention, vit, q, k, v, rel_h, rel_w, side, n_cores):
    """One served attention core's own q, k, v and tables: relpos_attention
    held against its plain version (each output within 2^-7 of its magnitude
    plus 2^-8 of the largest, the mean error under 1e-3: the kernel rounds P
    and its output to bf16, the plain version neither), then timed: the
    wrapper (CUDA events), the kernel's device time, the plain version, and
    SDPA with the bias materialised by the expansion product (the port's
    core before the kernel) as ``library_ms``; the bound of one core and of
    the batch's ``n_cores`` cores of this kind."""
    import torch.nn.functional as F

    from tpurpn_torch.kernels.relpos_attention import relpos_attention_plain

    n, h, t, d = q.shape
    with torch.no_grad():
        got = relpos_attention(q, k, v, rel_h, rel_w, side)
        err_max, err_sum = 0.0, 0.0
        for a in range(0, n, 8):
            want = relpos_attention_plain(q[a:a + 8], k[a:a + 8], v[a:a + 8], rel_h, rel_w, side)
            err = (got[a:a + 8].float() - want.float()).abs()
            limit = 2 ** -7 * want.float().abs() + 2 ** -8 * float(want.float().abs().max())
            require(bool((err <= limit).all()), f"relpos_attention vs plain at side {side}: "
                    f"max abs err {float(err.max())}")
            err_max, err_sum = max(err_max, float(err.max())), err_sum + float(err.sum())
        require(err_sum / got.numel() < 1e-3,
                f"relpos_attention vs plain at side {side}: mean err {err_sum / got.numel()}")

        def sdpa():
            rq = q.reshape(n, h, side, side, d)
            rel_h_ = torch.einsum("nhijc,ikc->nhijk", rq, vit.rel_table(rel_h, side).to(q.dtype))
            rel_w_ = torch.einsum("nhijc,jlc->nhijl", rq, vit.rel_table(rel_w, side).to(q.dtype))
            rel = torch.cat([rel_h_, rel_w_], -1).reshape(n, h, t, 2 * side)
            bias = torch.matmul(rel, vit.expansion(side, q.device, q.dtype))[..., :t]
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)

        call = lambda: relpos_attention(q, k, v, rel_h, rel_w, side)  # noqa: E731
        ms = time_ms(torch, call, 20)
        device, wrapper_device = kernel_device_ms(torch, call, ("relpos_attention_kernel",),
                                                  relpos_attention)
        plain_ms = time_ms(torch, lambda: relpos_attention_plain(q, k, v, rel_h, rel_w, side),
                           1, warmup=1)
        library_ms = time_ms(torch, sdpa, 5)
        m = min(n, 8)
        sdpa_err = float((sdpa()[:m].float() - relpos_attention_plain(
            q[:m], k[:m], v[:m], rel_h, rel_w, side).float()).abs().max())
    bound, by = attention_bound(q, side)
    batch_bound, _ = attention_bound(q, side, n_cores)
    return {"shape": [n, h, t, d], "side": side, "max_abs_err": err_max,
            "mean_abs_err": err_sum / got.numel(), "library_max_abs_err_first8": sdpa_err,
            "ms": ms, "device_ms": device, "wrapper_device_ms": wrapper_device,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
            "cores_a_batch": n_cores, "batch_bound_ms": batch_bound,
            "roofline_pct": 100.0 * bound / device if device else None}


def mvit_pool_bound(calls):
    """(bound ms, bytes) of MViT pooling calls, each (qkv shape (B, H, W,
    3 C), stride_q, stride_kv): of q, k and v the values a 3 x 3 tap
    reaches read once (every one at strides 1 and 2; at stride 4 the rows
    and columns 4 y - 1 .. 4 y + 1 only) and the pooled tensors written
    once, bf16, at the card's bandwidth."""
    def reached(n, s):
        return len({s * y + t - 1 for y in range(-(-n // s)) for t in range(3)} & set(range(n)))

    nbytes = 0
    for (b, h, w, c3), sq, skv in calls:
        for s in (sq, skv, skv):
            pixels = reached(h, s) * reached(w, s) + -(-h // s) * -(-w // s)
            nbytes += b * pixels * c3 // 3 * 2
    return nbytes / PEAK_BYTES * 1e3, nbytes


def library_pool(torch, qkv, heads, stride_q, stride_kv, convs, norms, eps):
    """The pooling as the port ran it before ``mvit_pool_kernel``: q, k and v
    copied out of the qkv product, then each through cuDNN's depthwise conv
    (the filters repeated per head, cast beforehand) and PyTorch's
    LayerNorm over each head."""
    import torch.nn.functional as F

    split = qkv.unflatten(-1, (3, -1)).permute(3, 0, 1, 2, 4).contiguous()
    out = []
    for x, s, w, (g, b) in zip(split, (stride_q, stride_kv, stride_kv), convs, norms):
        y = F.conv2d(x.permute(0, 3, 1, 2), w, None, s, 1, 1, x.shape[-1]).permute(0, 2, 3, 1)
        y = y.reshape(*y.shape[:3], heads, -1)
        out.append(F.layer_norm(y, y.shape[-1:], g, b, eps))
    return out


def mvit_phase(torch, args, dev, batch: int = 16):
    """MViTv2-B's RPN on the 800 x 1088 canvas served as users call it:
    seeded random weights and ``make_predict_fn(from_uint8=True)`` on
    ``batch`` uint8 480x640 SyntheticVOC frames in host memory. With every
    count at 0 just before: one ``mvit_pool_kernel`` launch a block (24) and
    one proposal launch. Every block's pooling call in that batch is kept;
    at each distinct (grid, stride_q, stride_kv, heads) the kernel's output
    is held against the plain pooling in f32 on the same qkv product and the
    weights on the bf16 grid the kernel reads (each value within 2^-8 of
    itself, one bf16 rounding, plus 1e-5 of the largest for the other sum
    order), its device time (torch.profiler) beside its byte bound. Times:
    the batch; the 24 calls through the wrapper (CUDA events) and the
    kernel's device time (torch.profiler); the plain pooling and the
    library pair it replaced (``library_pool``) on the same products; their
    byte bound (``mvit_pool_bound``)."""
    from tpurpn_torch import get_hyper_params, get_model, init_model
    from tpurpn_torch import predict as predict_module
    from tpurpn_torch.backbones import mvit
    from tpurpn_torch.data import SyntheticVOC
    from tpurpn_torch.kernels.mvit_pool import mvit_pool, mvit_pool_plain
    from tpurpn_torch.kernels.proposal import fused_proposals
    from tpurpn_torch.model import to_device

    torch.cuda.reset_peak_memory_stats()
    hp = get_hyper_params("mvitv2_b")
    model = init_model(get_model(hp), torch.Generator().manual_seed(args.seed), device="cpu")
    predict = predict_module.make_predict_fn(to_device(model, dev), hp, from_uint8=True, device=dev)
    frames = torch.from_numpy(next(SyntheticVOC(
        num_samples=batch, raw_h=480, raw_w=640, seed=args.seed).batches(batch))[0])
    predict(frames)  # warm-up: tables, cuDNN's plans
    torch.cuda.synchronize()

    calls, held = [], {}

    def recorded(qkv, heads, sq, skv, convs, norms, eps):
        out = orig(qkv, heads, sq, skv, convs, norms, eps)
        calls.append((qkv, heads, sq, skv, convs, norms, eps))
        held.setdefault((tuple(qkv.shape), sq, skv, heads), (len(calls) - 1, out))
        return out

    orig = mvit.mvit_pool
    mvit_pool.launches = fused_proposals.launches = 0
    mvit.mvit_pool = recorded
    try:
        with torch.no_grad():
            out = predict(frames)
        torch.cuda.synchronize()
    finally:
        mvit.mvit_pool = orig
    launches = {"mvit_pool": mvit_pool.launches, "proposals": fused_proposals.launches}
    n_blocks = hp.mvit.depth
    require(launches == {"mvit_pool": n_blocks, "proposals": 1} and len(calls) == n_blocks,
            f"mvit serving: launches {launches} for {n_blocks} blocks")
    check_proposals(torch, out, batch, hp.test_nms_topn)

    checked = {}
    with torch.no_grad():
        for (shape, sq, skv, heads), (i, got) in held.items():
            qkv, _, _, _, convs, norms, eps = calls[i]
            grid = (shape[1], shape[2])
            on_grid = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
            want = mvit_pool_plain(qkv.float(), heads, sq, skv, [on_grid(w) for w in convs],
                                   [(on_grid(g), on_grid(b)) for g, b in norms], eps)
            err_max, used = 0.0, 0.0  # the largest error, and of its limit
            for y, w in zip(got, want):
                require(y.shape == w.shape and y.dtype == torch.bfloat16 and y.is_contiguous(),
                        f"mvit_pool at block {i}: {tuple(y.shape)} {y.dtype}")
                err = (y.float() - w).abs()
                limit = 2 ** -8 * w.abs() + 1e-5 * float(w.abs().max())
                require(bool((err <= limit).all()),
                        f"mvit_pool vs plain at block {i} {grid} s {sq}/{skv}: max abs err "
                        f"{float(err.max())}")
                err_max = max(err_max, float(err.max()))
                used = max(used, float((err / limit).max()))
            del want
            device, _ = kernel_device_ms(torch, lambda: mvit_pool(*calls[i]),
                                         ("mvit_pool_kernel",), mvit_pool)
            bound, _ = mvit_pool_bound([(shape, sq, skv)])
            checked[f"block{i}"] = {"grid": list(grid), "stride_q": sq, "stride_kv": skv,
                                    "heads": heads, "max_abs_err": err_max,
                                    "max_err_of_limit": used, "device_ms": device,
                                    "bound_ms": bound, "roofline_pct": 100.0 * bound / device}
        torch.cuda.empty_cache()

        inputs = [c[:4] for c in calls]
        pool = lambda: [mvit_pool(*c) for c in calls]  # noqa: E731
        lib_args = [(qkv, heads, sq, skv,
                     [w.to(torch.bfloat16).repeat(heads, 1, 1, 1) for w in convs],
                     [(g.to(torch.bfloat16), b.to(torch.bfloat16)) for g, b in norms], eps)
                    for qkv, heads, sq, skv, convs, norms, eps in calls]
        ms = time_ms(torch, lambda: predict(frames), 5, warmup=1)
        pool_ms = time_ms(torch, pool, 10)
        device, wrapper_device = kernel_device_ms(torch, pool, ("mvit_pool_kernel",), mvit_pool)
        plain_ms = time_ms(torch, lambda: [mvit_pool_plain(*c) for c in calls], 3)
        library_ms = time_ms(torch, lambda: [library_pool(torch, *c) for c in lib_args], 3)
    peak = torch.cuda.max_memory_allocated()
    bound, nbytes = mvit_pool_bound([(tuple(q.shape), sq, skv) for q, _, sq, skv in inputs])
    phase = {"phase": "mvit_serving", "batch": batch, "frames": "SyntheticVOC 480x640 uint8",
             "canvas": list(calls[0][0].shape[1:3]), "launches": launches, "checked": checked,
             "ms_per_batch": ms, "img_per_s": batch / ms * 1e3, "memory_peak_bytes": peak,
             "pool": {"calls": len(calls), "ms": pool_ms, "device_ms": device,
                      "wrapper_device_ms": wrapper_device, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound, "bound_by": "bytes",
                      "bound_bytes": nbytes,
                      "roofline_pct": 100.0 * bound / device if device else None,
                      "max_abs_err": max(c["max_abs_err"] for c in checked.values()),
                      "max_err_of_limit": max(c["max_err_of_limit"] for c in checked.values())}}
    del predict, model, calls, held, lib_args, out, pool, inputs
    torch.cuda.empty_cache()
    return phase


def swin_attention_bound(shapes):
    """(bound ms, bytes) of Swin attention cores, each the (B, H, W, 3 C)
    shape of its qkv product: q, k and v read and the output written once
    over the grid padded to windows of 7, bf16, at the card's bandwidth
    (``portbench.counts_swin.attn_bound``'s count)."""
    nbytes = sum(b * -(-h // 7) * 7 * -(-w // 7) * 7 * c3 // 3 * 4 * 2 for b, h, w, c3 in shapes)
    return nbytes / PEAK_BYTES * 1e3, nbytes


def library_swin(torch, qkv, bias, table, heads, shift, masked):
    """The core as the port ran it before ``swin_attention_kernel``, as one
    call: the block's C-wide tokens zero-padded and gathered into window
    order (``window_order``), cuDNN's SDPA on the window-ordered product
    with the bf16 bias as its mask (in a shifted block the bias plus the
    mask, expanded over the images), one gather back to the grid
    (``grid_order``). The window-ordered product (the Linear on the
    gathered tokens) is made once beforehand; the tokens are the product's
    first C channels, of the same shape."""
    import torch.nn.functional as F

    from tpurpn_torch.kernels import swin_attention as sa

    b, hh, ww, c3 = qkv.shape
    c, dev = c3 // 3, qkv.device
    hp, wp = sa.padded(hh, 7), sa.padded(ww, 7)
    full = bias.expand(b, hp, wp, c3).clone()
    full[:, :hh, :ww] = qkv
    win = full.reshape(b, hp * wp, c3).index_select(1, sa.window_order(hh, ww, 7, shift, dev))
    q, k, v = win.reshape(-1, 49, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    del full

    def rows16(t, lead=()):  # rows padded to 16 keys in memory, as SDPA's mask took them
        out = torch.empty((*lead, *t.shape[:-1], 64), dtype=t.dtype, device=dev)[..., :49]
        out.copy_(t)
        return out

    bias_f = sa.relative_bias(table, 7, torch.float32)
    if masked:
        mask = rows16((bias_f[None] + sa.shift_mask(hp, wp, 7, shift, dev)[:, None]).to(q.dtype))
    else:
        mask = rows16(bias_f.to(q.dtype)[None])
    x = qkv[..., :c]
    fwd, back = sa.window_order(hh, ww, 7, shift, dev), sa.grid_order(hh, ww, 7, shift, dev)

    def run():
        xw = F.pad(x, (0, 0, 0, wp - ww, 0, hp - hh)).reshape(b, hp * wp, c).index_select(1, fwd)
        m = rows16(mask, (b,)).flatten(0, 1) if masked else mask
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=m)
        return xw, out.transpose(1, 2).reshape(b, -1, c).index_select(1, back)
    return run


def swin_phase(torch, args, dev, batch: int = 16):
    """Swin-B's RPN on the 800 x 1088 canvas served as users call it:
    seeded random weights and ``make_predict_fn(from_uint8=True)`` on
    ``batch`` uint8 480x640 SyntheticVOC frames in host memory. With every
    count at 0 just before: one ``swin_attention_kernel`` launch a block
    (24) and one proposal launch. Every block's core call in that batch is
    kept; at each distinct (grid, heads, shift, masked) the kernel's output
    in that call is held against the plain version in f32 on the same qkv
    product (each value within 2^-8 of itself plus 2^-8 of the largest |v|:
    the output's rounding to bf16 and P's for P V, whose error is at most
    2^-9 of a probability times a value of v), its device time
    (torch.profiler) beside its byte bound. Times: the batch; the 24 calls
    through the wrapper (CUDA events), the kernel's device time and each
    stage's (torch.profiler); the plain version and the path it replaced
    (``library_swin``) on the same products; their byte bound
    (``swin_attention_bound``)."""
    from tpurpn_torch import get_hyper_params, get_model, init_model
    from tpurpn_torch import predict as predict_module
    from tpurpn_torch.backbones import swin
    from tpurpn_torch.data import SyntheticVOC
    from tpurpn_torch.kernels.proposal import fused_proposals
    from tpurpn_torch.kernels.swin_attention import swin_attention, swin_attention_plain
    from tpurpn_torch.model import to_device

    torch.cuda.reset_peak_memory_stats()
    hp = get_hyper_params("swin_b")
    model = init_model(get_model(hp), torch.Generator().manual_seed(args.seed), device="cpu")
    g = torch.Generator().manual_seed(args.seed)
    with torch.no_grad():  # tables at std 1 (the benchmark's) and a qkv bias: live terms
        for m in model.modules():
            if isinstance(m, swin.WindowAttention):
                m.relative_position_bias_table.normal_(0.0, 1.0, generator=g)
                m.qkv.bias.normal_(0.0, 0.5, generator=g)
    predict = predict_module.make_predict_fn(to_device(model, dev), hp, from_uint8=True, device=dev)
    frames = torch.from_numpy(next(SyntheticVOC(
        num_samples=batch, raw_h=480, raw_w=640, seed=args.seed).batches(batch))[0])
    predict(frames)  # warm-up: the kernel library, cuDNN's plans
    torch.cuda.synchronize()

    calls, held = [], {}

    def recorded(qkv, qkv_bias, table, heads, window, shift, masked):
        out = orig(qkv, qkv_bias, table, heads, window, shift, masked)
        calls.append((qkv, qkv_bias, table, heads, window, shift, masked))
        held.setdefault((tuple(qkv.shape), heads, shift, masked), (len(calls) - 1, out))
        return out

    orig = swin.swin_attention
    swin_attention.launches = fused_proposals.launches = 0
    swin.swin_attention = recorded
    try:
        with torch.no_grad():
            out = predict(frames)
        torch.cuda.synchronize()
    finally:
        swin.swin_attention = orig
    launches = {"swin_attention": swin_attention.launches, "proposals": fused_proposals.launches}
    n_blocks = sum(hp.swin.depths)
    require(launches == {"swin_attention": n_blocks, "proposals": 1} and len(calls) == n_blocks,
            f"swin serving: launches {launches} for {n_blocks} blocks")
    check_proposals(torch, out, batch, hp.test_nms_topn)

    checked = {}
    with torch.no_grad():
        for (shape, heads, shift, masked), (i, got) in held.items():
            qkv, bias, table = calls[i][:3]
            want = swin_attention_plain(qkv.float(), bias.float(), table.float(), heads, 7, shift,
                                        masked)
            require(got.shape == want.shape and got.dtype == torch.bfloat16,
                    f"swin_attention at block {i}: {tuple(got.shape)} {got.dtype}")
            c = shape[-1] // 3
            vmax = max(float(qkv[..., 2 * c:].abs().max()), float(bias[2 * c:].abs().max()))
            err = (got.float() - want).abs()
            limit = 2 ** -8 * (want.abs() + vmax)
            require(bool((err <= limit).all()),
                    f"swin_attention vs plain at block {i} {shape[1:3]} shift {shift}: max abs "
                    f"err {float(err.max())}")
            del want
            device, _ = kernel_device_ms(torch, lambda: swin_attention(*calls[i]),
                                         ("swin_attention_kernel",), swin_attention)
            bound, _ = swin_attention_bound([shape])
            checked[f"block{i}"] = {"grid": list(shape[1:3]), "heads": heads, "shift": shift,
                                    "masked": masked, "max_abs_err": float(err.max()),
                                    "max_err_of_limit": float((err / limit).max()),
                                    "device_ms": device, "bound_ms": bound,
                                    "roofline_pct": 100.0 * bound / device}
        torch.cuda.empty_cache()

        cores = lambda sel=calls: [swin_attention(*c) for c in sel]  # noqa: E731
        stages = {}
        for c in calls:
            stages.setdefault(tuple(c[0].shape[1:3]), []).append(c)
        by_stage = {}
        for grid, sel in stages.items():
            device, _ = kernel_device_ms(torch, lambda sel=sel: cores(sel),
                                         ("swin_attention_kernel",), swin_attention)
            bound, _ = swin_attention_bound([tuple(c[0].shape) for c in sel])
            by_stage["x".join(map(str, grid))] = {
                "launches": len(sel), "device_ms": device, "bound_ms": bound,
                "roofline_pct": 100.0 * bound / device}
        ms = time_ms(torch, lambda: predict(frames), 5, warmup=1)
        core_ms = time_ms(torch, cores, 10)
        device, wrapper_device = kernel_device_ms(torch, cores, ("swin_attention_kernel",),
                                                  swin_attention)
        plain_ms = time_ms(torch, lambda: [swin_attention_plain(*c) for c in calls], 3)
        library_ms = 0.0
        for c in calls:  # one block's inputs at a time: the expanded masks are large
            run = library_swin(torch, *c[:4], c[5], c[6])
            library_ms += time_ms(torch, run, 3)
            del run
    peak = torch.cuda.max_memory_allocated()
    bound, nbytes = swin_attention_bound([tuple(c[0].shape) for c in calls])
    phase = {"phase": "swin_serving", "batch": batch, "frames": "SyntheticVOC 480x640 uint8",
             "canvas": [4 * x for x in calls[0][0].shape[1:3]], "launches": launches,
             "checked": checked, "ms_per_batch": ms, "img_per_s": batch / ms * 1e3,
             "memory_peak_bytes": peak, "by_stage": by_stage,
             "attention": {"calls": len(calls), "ms": core_ms, "device_ms": device,
                           "wrapper_device_ms": wrapper_device, "plain_ms": plain_ms,
                           "library_ms": library_ms, "bound_ms": bound, "bound_by": "bytes",
                           "bound_bytes": nbytes,
                           "roofline_pct": 100.0 * bound / device if device else None,
                           "max_abs_err": max(c["max_abs_err"] for c in checked.values()),
                           "max_err_of_limit": max(c["max_err_of_limit"]
                                                   for c in checked.values())}}
    del predict, model, calls, held, out, cores, stages
    torch.cuda.empty_cache()
    return phase


def check_proposals(torch, out, B, topn) -> None:
    boxes, scores, nv = out["roi_boxes"], out["roi_scores"], out["num_valid"]
    require(boxes.shape == (B, topn, 4) and scores.shape == (B, topn)
            and nv.shape == (B,), f"proposal shapes {boxes.shape} {scores.shape} {nv.shape}")
    require(nv.dtype == torch.int32, f"num_valid dtype {nv.dtype}")
    require(bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all()),
            "non-finite proposals")
    require(bool(((nv >= 0) & (nv <= topn)).all()), "num_valid out of [0, topn]")
    past = torch.arange(topn, device=nv.device)[None] >= nv[:, None]
    require(not bool(boxes[past].any() or scores[past].any()), "nonzero past num_valid")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--train-batch", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=1,
                    help="N > 1: only the data-parallel paths over N GPUs (NCCL)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the card",
              file=sys.stderr)
        return 2
    from tpurpn_torch import fold_batch_norm, get_hyper_params, get_model, init_model
    from tpurpn_torch.data import preprocess_batch
    from tpurpn_torch.inference import _FUSED_BLOCKS, fast_mobilenet_forward
    from tpurpn_torch import cache
    from tpurpn_torch.kernels import _build
    from tpurpn_torch.kernels.ir_stage import (
        fused_ir_stage, fused_ir_stage_plain, kernel_pack, kernel_pack_cached,
        pack_stage_weights, stage_weights_cached)
    from tpurpn_torch.kernels.proposal import (
        _select, fused_proposals, fused_proposals_plain, top_candidates)
    from tpurpn_torch.kernels.targets import cluster_size, fused_iou_matching, fused_rpn_targets
    from tpurpn_torch.kernels.nms import nms_keep, nms_keep_plain
    from tpurpn_torch.kernels.prefix import prefix_depthwise, prefix_pointwise
    from tpurpn_torch.boxes import batched_non_max_suppression
    from tpurpn_torch.data import SyntheticVOC
    from tpurpn_torch.target import iou_matching, iou_matching_plain, rpn_targets_plain
    from tpurpn_torch.model import apply_rpn_head, to_device
    from tpurpn_torch.predict import decode_outputs, make_predict_fn
    from tpurpn_torch.anchors import generate_anchors
    from tpurpn_torch.backbones.mobilenet_v2 import relu6
    from tpurpn_torch import cli, data, native
    from tpurpn_torch.eval import proposal_recall
    from tpurpn_torch.io_utils import load_keras_h5_weights

    smi = nvidia_smi()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # which optional packages this machine has; then none of them may be
    # imported by what follows (a check must not depend on them)
    optional = {m: importlib.util.find_spec(m) is not None for m in OPTIONAL}
    for m in OPTIONAL:
        sys.modules[m] = None
    emit({"phase": "setup", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "optional_packages": optional,
          "native_build": native_build(native),
          "tf32_matmul": False, "tf32_cudnn": False, "seed": args.seed,
          "batch": args.batch})

    # 1. build every kernel of the path, one nvcc per source, in parallel
    t0 = time.perf_counter()
    sources = ("proposal", "ir_stage", "targets", "nms", "prefix", "relpos_attention", "mvit_pool",
               "swin_attention")
    _build.build(sources)
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in sources}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})
    if args.ranks > 1:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        emit(multichip(torch, args, smi, tmp))
        shutil.rmtree(tmp, ignore_errors=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    emit(native_loader_phase(native))

    # the model: seeded random weights, BN statistics perturbed, then folded
    B = args.batch
    hp = get_hyper_params("mobilenet_v2")  # 500x500 -> 32x32x576, 9,216 anchors
    gen = torch.Generator().manual_seed(args.seed)
    model = get_model(hp)
    init_model(model, gen, device="cpu")
    perturb_batch_norm(model, gen, torch)
    folded = fold_batch_norm(to_device(model, dev))
    dgen = torch.Generator(device=dev).manual_seed(args.seed)
    images = torch.rand((B, hp.img_size, hp.img_size, 3), generator=dgen,
                        device=dev).to(torch.bfloat16)
    frames = torch.randint(0, 256, (B, 375, 500, 3), generator=dgen, device=dev,
                           dtype=torch.uint8)
    pre, topn, thr = min(hp.pre_nms_topn, hp.total_anchors), hp.test_nms_topn, hp.nms_iou_threshold

    # 2. each kernel against its plain version at the main path's shapes
    with torch.no_grad():
        feat6 = folded.backbone(images, stop_after_block=6).contiguous()
        weights, blocks = pack_stage_weights(folded.backbone, _FUSED_BLOCKS,
                                             tail_expand="block_13_expand")
        ir_k = fused_ir_stage(feat6, weights, blocks)
        ir_p = fused_ir_stage_plain(feat6, weights, blocks)
        torch.cuda.synchronize()
        require(ir_k.shape == (B, 32, 32, 576) and ir_k.dtype == torch.bfloat16,
                f"IR stage output {ir_k.shape} {ir_k.dtype}")
        ir_err, ir_ok = close_err(ir_k, ir_p)
        require(ir_ok, f"IR stage kernel vs plain: max abs err {ir_err}")

        ref_reg, ref_cls = folded(images)
        anchors = generate_anchors(hp, dev)
        boxes, scores = decode_outputs(anchors, ref_reg, ref_cls, hp)
        pr_k = fused_proposals(boxes, scores, pre, thr, topn)
        nms_keep.launches = 0
        pr_p = fused_proposals_plain(boxes, scores, pre, thr, topn)
        torch.cuda.synchronize()
        require(nms_keep.launches == 0, "the proposal kernel's plain version reached a kernel")
        pr_err = max(float((pr_k[k].float() - pr_p[k].float()).abs().max()) for k in pr_p)
        for k in pr_p:
            require(torch.equal(pr_k[k], pr_p[k]), f"proposal kernel vs plain differ in {k}")
    emit({"phase": "kernel_vs_plain",
          "ir_stage": {"shape": list(feat6.shape), "max_abs_err": ir_err,
                       "tolerance": f"rel {TOL_REL} of max(1, |ref|max)"},
          "proposals": {"B": B, "N": hp.total_anchors, "pre": pre, "topn": topn,
                        "max_abs_err": pr_err, "tolerance": "bit-exact",
                        "num_valid_mean": float(pr_k["num_valid"].float().mean())}})

    # ... and at the edges the main path does not reach: partial 8-row
    # tiles (S not a multiple of 8), one image; score ties, duplicate boxes,
    # fewer candidates than topn, pre not a multiple of the 32-candidate
    # chunk (nor of the 1,024-candidate page), the 300th keep inside a
    # chunk, an image whose every score is -inf, max_output > pre
    edges = {}
    with torch.no_grad():
        for B_e, S in ((3, 9), (3, 17), (3, 25), (3, 31), (1, 32)):
            x = torch.rand((B_e, S, S, 64), generator=dgen, device=dev).to(torch.bfloat16)
            err, ok = close_err(fused_ir_stage(x, weights, blocks),
                                fused_ir_stage_plain(x, weights, blocks))
            require(ok, f"IR stage kernel vs plain at B={B_e}, S={S}: max abs err {err}")
            edges[f"ir_stage_B{B_e}_S{S}_max_abs_err"] = err
        for case, n, pre_e, out_e in (
                ("ties", 2000, pre, topn), ("duplicates", 2000, pre, topn),
                ("fewer_than_topn", 160, pre, topn), ("pre_1037", 2000, 1037, topn),
                ("keep_300_mid_chunk", 2000, pre, topn), ("all_neg_inf_image", 2000, pre, topn),
                ("max_output_gt_pre", 2000, 250, topn)):
            y1x1 = torch.rand((4, n, 2), generator=dgen, device=dev) * 0.6
            hw = torch.rand((4, n, 2), generator=dgen, device=dev) * 0.38 + 0.02
            cand = torch.cat([y1x1, y1x1 + hw], dim=-1)
            sc = torch.rand((4, n), generator=dgen, device=dev)
            if case == "ties":
                sc = torch.floor(sc * 7) / 7
            if case == "duplicates":  # one box n-1 times and one apart
                cand[:] = torch.tensor([0.1, 0.1, 0.3, 0.3], device=dev)
                cand[:, -1] = torch.tensor([0.6, 0.6, 0.9, 0.9], device=dev)
                sc[:, -1] = 2.0
            if case == "keep_300_mid_chunk":  # disjoint boxes: every candidate kept
                i = torch.arange(n, device=dev, dtype=torch.float32)
                yx = torch.stack([torch.div(i, 50, rounding_mode="floor"), i % 50], -1) * 0.02
                cand = torch.cat([yx, yx + 0.01], -1)[None].repeat(4, 1, 1).contiguous()
            if case == "all_neg_inf_image":
                sc[0] = -float("inf")
            k = fused_proposals(cand, sc, min(pre_e, n), thr, out_e)
            p = fused_proposals_plain(cand, sc, min(pre_e, n), thr, out_e)
            for key in p:
                require(torch.equal(k[key], p[key]), f"proposal kernel vs plain, {case}: {key}")
            edges[f"proposals_{case}_num_valid"] = k["num_valid"].tolist()
        require(edges["proposals_duplicates_num_valid"] == [2] * 4,
                "duplicate candidates must leave two proposals an image")
        require(edges["proposals_keep_300_mid_chunk_num_valid"] == [topn] * 4
                and topn % 32, "every disjoint candidate is kept up to topn, inside a chunk")
        require(edges["proposals_all_neg_inf_image_num_valid"][0] == 0,
                "an image without candidates keeps none")
        require(max(edges["proposals_max_output_gt_pre_num_valid"]) <= 250,
                "no more keeps than candidates")
    emit({"phase": "kernel_edge_cases", **edges})
    ir_domain = ir_domain_phase(torch, folded.backbone, dgen, dev)
    emit({**ir_domain, "nvidia_smi": smi})
    pfx = prefix_phase(torch, folded, frames, dev)
    emit({**pfx, "nvidia_smi": smi})

    # the target and IoU-matching kernels at config 3: VGG16 anchors, B=8
    # SyntheticVOC samples (M=8), words from a seeded generator
    hp3 = get_hyper_params("vgg16")
    anchors3 = generate_anchors(hp3, dev)
    tb = args.train_batch
    _, gt3, lab3 = (torch.from_numpy(a).to(dev)
                    for a in next(SyntheticVOC(num_samples=tb, seed=args.seed).batches(tb)))
    words3 = torch.randint(-(2**31), 2**31, (tb, 2, hp3.total_anchors), generator=dgen,
                           device=dev, dtype=torch.int32)
    tg_args = (anchors3, gt3, lab3, words3, hp3)
    tg_err, _ = check_targets(torch, fused_rpn_targets, rpn_targets_plain, tg_args, "config 3")
    mt_err = check_matching(torch, fused_iou_matching, iou_matching_plain, anchors3, gt3,
                            "config 3")
    tgt_edges = {}
    hp_big = get_hyper_params("vgg16", img_size=800)  # 22,500 anchors: a 15-bit index field

    def random_anchors(n):
        yx = torch.rand((n, 2), generator=dgen, device=dev) * 0.8
        return torch.cat([yx, yx + torch.rand((n, 2), generator=dgen, device=dev) * 0.3 + 0.02], -1)

    # the matching runs one cluster of C blocks an image, block r on the
    # anchors [r*S, (r+1)*S), S = ceil(N / C): a tie across slice
    # boundaries (copies of anchor 3 in later slices, C = 8 or 16), a GT
    # disjoint from every anchor, IoUs of -0 and +0 (anchors ending at y =
    # -0.0 touch a GT starting at +0.0), empty slices (N < C) and a short
    # last one (N not a multiple of C)
    n3 = hp3.total_anchors
    anchors5 = random_anchors(5)
    tie_anchors = anchors3.clone()
    s16 = -(-n3 // 16)
    for k in range(1, 16):
        tie_anchors[k * s16 + 5] = anchors3[3]
    zero_anchors = random_anchors(n3)
    zero_anchors[:, 0::2] += 0.5  # below y = 0.5: disjoint from the touching GT
    zero_anchors[1::7] = torch.tensor([-0.5, 0.1, -0.0, 0.3], device=dev)
    gt_rows = {  # GT rows set in place of the first random ones, and their best anchor
        "tie_across_slices": ([anchors3[3].tolist()], 3),
        "gt_disjoint": ([[5.0, 5.0, 6.0, 6.0]], 0),
        "signed_zero_ious": ([[0.0, 0.1, 0.2, 0.3], [5.0, 5.0, 6.0, 6.0]], 0),
    }
    # the selection keys of an image stay in shared memory up to N = 25,600
    for name, (hpe, an, Bt, M, nv) in {
        "M64_padded": (hp3, anchors3, 4, 64, 20), "no_gt": (hp3, anchors3, 2, 8, 0),
        "N22500": (hp_big, generate_anchors(hp_big, dev), 2, 8, 5),
        "total_pos_above_candidates": (replace(hp3, total_pos_bboxes=4096), anchors3, 4, 8, 8),
        "candidates_above_total_pos": (replace(hp3, pos_threshold=0.3), anchors3, 4, 8, 8),
        "no_negative_candidate": (replace(hp3, neg_threshold=0.0), anchors3, 2, 8, 8),
        "k_zero": (replace(hp3, total_pos_bboxes=0, total_neg_bboxes=0), anchors3, 2, 8, 8),
        # every anchor touching a GT is a positive candidate: 128 positives
        # fill the minibatch, and the negatives' budget is 0
        "negative_budget_zero": (replace(hp3, pos_threshold=0.0, total_neg_bboxes=0),
                                 anchors3, 2, 8, 8),
        "N25600_keys_in_shared_memory": (hp3, random_anchors(25600), 2, 8, 8),
        "N25601_keys_in_global_memory": (hp3, random_anchors(25601), 2, 8, 8),
        "tie_across_slices": (hp3, tie_anchors, 4, 8, 8),
        "gt_disjoint": (hp3, anchors3, 4, 8, 4),
        "signed_zero_ious": (hp3, zero_anchors, 2, 4, 2),
        "N5_empty_slices": (hp3, anchors5, 2, 8, 3),
        "N8651_short_last_slice": (hp3, random_anchors(8651), 2, 8, 8),
        "M1": (hp3, anchors3, 4, 1, 1),
        "B1": (hp3, anchors3, 1, 8, 5),
    }.items():
        gt, lab = random_gt(torch, dgen, Bt, M, nv, dev)
        if name in gt_rows:
            rows, best = gt_rows[name]
            gt[:, :len(rows)] = torch.tensor(rows, device=dev)
            require(bool((fused_iou_matching(an, gt)[2][:, :len(rows)] == best).all()),
                    f"IoU-matching kernel: best anchor of the {name} GT is not {best}")
        w = torch.randint(-(2**31), 2**31, (Bt, 2, an.shape[0]), generator=dgen,
                          device=dev, dtype=torch.int32)
        tgt_edges[f"targets_{name}_max_abs_err"], labels_e = check_targets(
            torch, fused_rpn_targets, rpn_targets_plain, (an, gt, lab, w, hpe), name)
        tgt_edges[f"targets_{name}_labels_pos_neg"] = [
            int((labels_e == 1).sum()), int((labels_e == 0).sum())]
        tgt_edges[f"matching_{name}_max_abs_err"] = check_matching(
            torch, fused_iou_matching, iou_matching_plain, an, gt, name)
    require(tgt_edges["targets_k_zero_labels_pos_neg"] == [0, 0], "budgets of 0 selected anchors")
    require(tgt_edges["targets_negative_budget_zero_labels_pos_neg"] == [2 * 128, 0],
            "a negative budget of 0 selected anchors")
    require(tgt_edges["targets_no_gt_labels_pos_neg"][0] == 0, "positives without a GT box")
    require(tgt_edges["targets_no_negative_candidate_labels_pos_neg"][1] == 0,
            "negatives selected without a negative candidate")
    clusters = {e: cluster_size(e) for e in ("iou_matching", "rpn_targets")}
    emit({"phase": "targets_kernel_vs_plain", "B": tb, "N": hp3.total_anchors,
          "M": int(gt3.shape[1]), "max_abs_err": tg_err, "matching_max_abs_err": mt_err,
          "cluster": clusters,
          "tolerance": "labels and indices bit-exact, deltas rows 0-1 bit-exact, rows 2-3 rel 1e-6",
          **tgt_edges})

    # the NMS kernel at config 4: the top-2000 of 32 serving images' candidates
    nb, n4, out4, thr4 = min(32, B), 2000, 300, 0.7
    top4 = top_candidates(scores[:nb], n4)
    boxes4 = torch.gather(boxes[:nb], 1, top4[..., None].expand(-1, -1, 4)).contiguous()
    scores4 = torch.gather(scores[:nb], 1, top4)
    valid4 = torch.ones((nb, n4), dtype=torch.bool, device=dev)
    cnt4, nms_err = check_nms(torch, nms_keep, nms_keep_plain, (boxes4, valid4, thr4, out4),
                              "config 4")
    nms_edges = {"config4_count_min": int(cnt4.min()), "config4_count_max": int(cnt4.max())}
    y1x1 = torch.rand((4, 1037, 2), generator=dgen, device=dev) * 0.6
    hw = torch.rand((4, 1037, 2), generator=dgen, device=dev) * 0.38 + 0.02
    rnd = torch.cat([y1x1, y1x1 + hw], dim=-1)
    dup = rnd.clone()
    dup[:] = torch.tensor([0.1, 0.1, 0.3, 0.3], device=dev)
    dup[:, ::5] = torch.tensor([0.6, 0.6, 0.9, 0.9], device=dev)
    half_invalid = torch.ones((4, 1037), dtype=torch.bool, device=dev)
    half_invalid[:2] = False
    ties = torch.floor(torch.rand((4, 1037), generator=dgen, device=dev) * 7) / 7
    tie_order = torch.sort(ties, dim=1, descending=True, stable=True).indices
    tie_boxes = torch.gather(rnd, 1, tie_order[..., None].expand(-1, -1, 4)).contiguous()
    all_valid = torch.ones((4, 1037), dtype=torch.bool, device=dev)
    grid = disjoint_boxes(torch, 4, 1037, dev)
    one = torch.ones((1, n4), dtype=torch.bool, device=dev)
    for name, a in {
        "random_n1037": (rnd, all_valid, 0.7, 300),
        "ties_sorted_stably": (tie_boxes, all_valid, 0.5, 100),
        "duplicates": (dup, all_valid, 0.7, 300),
        "all_invalid_rows": (rnd, half_invalid, 0.7, 50),
        "block_256": (rnd, all_valid, 0.6, 40, 256),
        "block_32": (rnd, all_valid, 0.7, 300, 32),
        # every box kept: the count reaches 256 exactly at the end of block 2
        "count_reaches_max_at_block_end": (grid, all_valid, 0.7, 256),
        # ... and the 300th keep lands in block 3's second chunk: the rest of
        # the block is still decided, 384 keeps
        "keep_300_mid_chunk": (grid, all_valid, 0.7, 300),
        "n_below_32": (rnd[:, :20].contiguous(), all_valid[:, :20].contiguous(), 0.5, 300),
        "one_image": (boxes4[:1].contiguous(), one, thr4, out4),
        "max_output_3000_block_1024": (torch.cat([rnd, rnd, rnd], 1)[:2, :3000].contiguous(),
                                       all_valid[:2].repeat(1, 3)[:, :3000], 0.9, 3000, 1024),
        # 10,240 kept boxes (200 KB) exceed shared memory: the kept list
        # lives in the global scratch row
        "kept_in_global_memory": (disjoint_boxes(torch, 2, 10240, dev),
                                  torch.ones((2, 10240), dtype=torch.bool, device=dev),
                                  0.7, 10240, 1024),
    }.items():
        cnt, err = check_nms(torch, nms_keep, nms_keep_plain, a, name)
        nms_edges[f"{name}_counts"], nms_edges[f"{name}_max_abs_err"] = cnt.tolist(), err
    require(nms_edges["duplicates_counts"] == [2] * 4, "duplicates must leave two boxes an image")
    require(nms_edges["all_invalid_rows_counts"][:2] == [0, 0], "all-invalid rows kept boxes")
    require(nms_edges["count_reaches_max_at_block_end_counts"] == [256] * 4,
            "a count reaching max_output at a block's end must stop there")
    require(nms_edges["keep_300_mid_chunk_counts"] == [384] * 4,
            "the block of the 300th keep must be decided whole")
    require(nms_edges["kept_in_global_memory_counts"] == [10240] * 2,
            "every disjoint box must be kept")
    emit({"phase": "nms_kernel_vs_plain", "B": nb, "n": n4, "max_output": out4,
          "max_abs_err": nms_err,
          "tolerance": "bit-exact keep mask and count", **nms_edges})

    # 3. the main paths, each with every count at 0 just before it
    kernels = {"ir_stage": fused_ir_stage, "proposals": fused_proposals,
               "targets": fused_rpn_targets, "iou_matching": fused_iou_matching,
               "nms": nms_keep, "prefix_pointwise": prefix_pointwise,
               "prefix_depthwise": prefix_depthwise}
    predict = make_predict_fn(folded, hp, fast=True, device=dev)
    predict_u8 = make_predict_fn(folded, hp, fast=True, from_uint8=True, device=dev)
    launches, outs = {}, {}
    for variant, fn, x in (("bf16", predict, images), ("uint8", predict_u8, frames)):
        reset(kernels)
        out = outs[variant] = fn(x)
        torch.cuda.synchronize()
        launches[variant] = counts(kernels)
        for n in ("ir_stage", "proposals"):
            require(launches[variant][n] > 0, f"{variant} main path never launched the {n} kernel")
        require(launches[variant]["prefix_pointwise"] == 13
                and launches[variant]["prefix_depthwise"] == 7,
                f"{variant} main path's prefix launches: {launches[variant]}")
        check_proposals(torch, out, B, topn)
        emit({"phase": f"main_path_{variant}", "call": "eager", "launches": launches[variant],
              "num_valid_min": int(out["num_valid"].min()),
              "num_valid_mean": float(out["num_valid"].float().mean())})

    # serving under inference mode, with the derived weights emptied first so
    # that they are made inside it: the same proposals
    cache.clear()
    with torch.inference_mode():
        out_im = predict(images)
    torch.cuda.synchronize()
    for k in out_im:
        require(torch.equal(out_im[k], outs["bf16"][k]),
                f"serving under inference mode differs in {k}")
    emit({"phase": "main_path_bf16_inference_mode", "same_as_bf16": True})

    with torch.no_grad():
        fast_reg, fast_cls = fast_mobilenet_forward(folded, images)
        reg_err, reg_ok = close_err(fast_reg, ref_reg)
        cls_err, cls_ok = close_err(fast_cls, ref_cls)
        require(reg_ok and cls_ok and bool(torch.isfinite(fast_reg).all()),
                f"fast forward vs plain folded forward: {reg_err} {cls_err}")
    emit({"phase": "fast_vs_plain_forward", "rpn_reg_max_abs_err": reg_err,
          "rpn_cls_max_abs_err": cls_err, "ref_reg_absmax": float(ref_reg.abs().max()),
          "tolerance": f"rel {TOL_REL} of max(1, |ref|max)"})

    # the training step of each backbone at full width
    train_timing = {}
    for backbone in ("vgg16", "mobilenet_v2"):
        phase, timing, launches[backbone] = train_phase(torch, backbone, args, dev, kernels)
        emit(phase)
        train_timing[backbone] = timing
    # ... and its device-resident steps: one CUDA graph of the step, replayed
    device_data = {}
    for backbone in ("vgg16", "mobilenet_v2"):
        device_data[backbone] = device_data_phase(torch, backbone, args, dev, kernels)
        emit({**device_data[backbone], "nvidia_smi": smi})

    # standalone NMS at config 4 (unsorted top-2000 -> 300, batch 32) and
    # the IoU-matching entry on the config-3 batch
    reset(kernels)
    nms_sel, nms_nv = batched_non_max_suppression(boxes4, scores4, out4, thr4)
    torch.cuda.synchronize()
    launches["nms_path"] = counts(kernels)
    require(launches["nms_path"]["nms"] > 0, "batched_non_max_suppression never launched nms")
    ref_sel, ref_nv = batched_non_max_suppression(boxes4, scores4, out4, thr4, use_kernel=False)
    require(torch.equal(nms_sel, ref_sel) and torch.equal(nms_nv, ref_nv),
            "batched_non_max_suppression: kernel and plain routes select differently")
    reset(kernels)
    iou_matching(anchors3, gt3)
    torch.cuda.synchronize()
    launches["matching_path"] = counts(kernels)
    require(launches["matching_path"]["iou_matching"] > 0, "iou_matching never launched its kernel")
    emit({"phase": "nms_and_matching_paths", "launches_nms": launches["nms_path"],
          "launches_matching": launches["matching_path"],
          "num_valid_min": int(nms_nv.min()), "num_valid_mean": float(nms_nv.float().mean())})
    for timing in train_timing.values():
        emit({**timing, "nvidia_smi": smi})

    # 4. timing (CUDA events, after warm-up)
    with torch.no_grad():
        ir_ms = time_ms(torch, lambda: fused_ir_stage(feat6, weights, blocks), 20)
        ir_plain_ms = time_ms(torch, lambda: fused_ir_stage_plain(feat6, weights, blocks), 5)
        pr_ms = time_ms(torch, lambda: fused_proposals(boxes, scores, pre, thr, topn), 20)
        pr_plain_ms = time_ms(torch, lambda: fused_proposals_plain(boxes, scores, pre, thr, topn), 3)
        # the wrapper's stable sort and the selection kernel, apart
        order = top_candidates(scores, pre)
        sort_ms = time_ms(torch, lambda: top_candidates(scores, pre), 20)
        select_ms = time_ms(torch, lambda: _select(boxes, scores, order, thr, topn), 20)
        # each IR-stage launch on its own input (the previous block's output)
        ir_block_ms, h, wi = {}, feat6, 0
        for i, blk in enumerate(blocks):
            n_w = 2 if blk[2] is None else 6
            wb, one = weights[wi:wi + n_w], (blk,)
            wi += n_w
            name = (f"block{i}_{blk[0]}to{blk[2]}" if blk[2] is not None
                    else f"block{i}_tail_{blk[0]}to{blk[1]}")
            ir_block_ms[name] = time_ms(torch, lambda: fused_ir_stage(h, wb, one), 20)
            h = fused_ir_stage(h, wb, one)
        stages = {
            "preprocess_uint8": time_ms(torch, lambda: preprocess_batch(
                frames, torch.zeros((B, 1, 4), device=dev), hp.img_size,
                dtype=torch.bfloat16), 5),
            "prefix_to_block_6": time_ms(
                torch, lambda: folded.backbone(images, stop_after_block=6), 5),
            "pack_stage_weights": time_ms(torch, lambda: pack_stage_weights(
                folded.backbone, _FUSED_BLOCKS, tail_expand="block_13_expand"), 5),
            "kernel_pack": time_ms(torch, lambda: kernel_pack(weights, blocks), 5),
            "stage_weights_cached_hit": time_ms(torch, lambda: kernel_pack_cached(
                *stage_weights_cached(folded.backbone, _FUSED_BLOCKS,
                                      tail_expand="block_13_expand")), 20),
            "ir_stage_kernel": ir_ms,
            "full_backbone_cudnn": time_ms(torch, lambda: folded.backbone(images), 5),
            "head": time_ms(torch, lambda: apply_rpn_head(folded, ir_k), 5),
            "decode": time_ms(torch, lambda: decode_outputs(anchors, ref_reg, ref_cls, hp), 5),
            "proposals_wrapper": pr_ms,
            "proposals_sort": sort_ms,
            "proposals_select_kernel": select_ms,
        }
        e2e = {}
        for name, fn, x in (
            ("fast_bf16", predict, images),
            ("fast_uint8", predict_u8, frames),
            ("plain_backbone_bf16", make_predict_fn(folded, hp, device=dev), images),
        ):
            ms = time_ms(torch, lambda: fn(x), 5)
            busy_ms, device_ops = device_profile(torch, lambda: fn(x))
            e2e[name] = {"ms_per_batch": ms, "img_per_s": B / ms * 1e3,
                         "device_busy_ms": busy_ms, "device_ops": device_ops,
                         "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / ms}
        # the prefix layer by layer (cuDNN convs), each on its real input
        bb = folded.backbone
        prefix = [("Conv1", lambda h: relu6(bb.Conv1(h)))] + [
            (n, bb.get_submodule(n)) for n in bb.block_names()[:7]]
        h = images.permute(0, 3, 1, 2)
        prefix_ms = {}
        for name, layer in prefix:
            prefix_ms[name] = time_ms(torch, lambda: layer(h), 5)
            h = layer(h)
        tg_ms = time_ms(torch, lambda: fused_rpn_targets(*tg_args), 20)
        tg_plain_ms = time_ms(torch, lambda: rpn_targets_plain(*tg_args), 5)
        mt_ms = time_ms(torch, lambda: fused_iou_matching(anchors3, gt3), 20)
        mt_plain_ms = time_ms(torch, lambda: iou_matching_plain(anchors3, gt3), 5)
        nms_args = (boxes4, valid4, thr4, out4)
        nms_ms = time_ms(torch, lambda: nms_keep(*nms_args), 20)
        nms_plain_ms = time_ms(torch, lambda: nms_keep_plain(*nms_args), 3)
        bnms_ms = time_ms(torch, lambda: batched_non_max_suppression(
            boxes4, scores4, out4, thr4), 20)
        # without the stable sort and gathers in front of the keep kernel
        bnms_presorted_ms = time_ms(torch, lambda: batched_non_max_suppression(
            boxes4, scores4, out4, thr4, presorted=True), 20)
        bnms_plain_ms = time_ms(torch, lambda: batched_non_max_suppression(
            boxes4, scores4, out4, thr4, use_kernel=False), 3)
        bnms_busy_ms, bnms_ops = device_profile(torch, lambda: batched_non_max_suppression(
            boxes4, scores4, out4, thr4))
        # each kernel's own launches on the card (and its wrapper's whole
        # device time), apart from the host's overhead
        device_ms, wrapper_device_ms = {}, {}
        for name, fn, counter, kernel_names in (
            ("ir_stage", lambda: fused_ir_stage(feat6, weights, blocks), fused_ir_stage,
             IR_KERNELS),
            ("proposals", lambda: fused_proposals(boxes, scores, pre, thr, topn),
             fused_proposals, ("proposal_kernel",)),
            ("targets", lambda: fused_rpn_targets(*tg_args), fused_rpn_targets,
             ("targets_kernel",)),
            ("iou_matching", lambda: fused_iou_matching(anchors3, gt3), fused_iou_matching,
             ("matching_kernel",)),
            # the same batch against 5 anchors: launch, staging and the two
            # cluster barriers with next to no IoU work
            ("iou_matching_n5", lambda: fused_iou_matching(anchors5, gt3), fused_iou_matching,
             ("matching_kernel",)),
            ("nms", lambda: nms_keep(*nms_args), nms_keep, ("nms_kernel",))):
            device_ms[name], wrapper_device_ms[name] = kernel_device_ms(
                torch, fn, kernel_names, counter)
    decided = nms_decided(torch, nms_keep(*nms_args)[0], out4, 128).float()
    rounds = torch.ceil(decided / 32)  # 32 candidates a round
    emit({"phase": "config4_nms_ms", "batch": nb, "n": n4, "max_output": out4,
          "nms_keep_kernel": nms_ms, "nms_keep_plain": nms_plain_ms,
          "batched_nms_kernel_route": bnms_ms, "batched_nms_plain_route": bnms_plain_ms,
          "batched_nms_presorted_kernel_route": bnms_presorted_ms,
          "sort_and_gathers_in_front": bnms_ms - bnms_presorted_ms,
          "glue_after_kernel": bnms_presorted_ms - nms_ms,
          "batched_nms_device_busy_ms": bnms_busy_ms, "batched_nms_device_ops": bnms_ops,
          "visited_boxes_mean": float(decided.mean()), "visited_boxes_max": int(decided.max()),
          "rounds_mean": float(rounds.mean()), "rounds_max": int(rounds.max()),
          "nvidia_smi": smi})
    emit({"phase": "stages_ms", "batch": B, **stages})
    emit({"phase": "ir_stage_blocks_ms", "batch": B, "nvidia_smi": smi, **ir_block_ms})
    emit({"phase": "prefix_layers_ms", "batch": B, **prefix_ms})
    emit({"phase": "end_to_end", "batch": B, "nvidia_smi": smi, **e2e})

    ir_bound, ir_by = ir_stage_bound(feat6, weights, blocks)
    pr_bound, pr_by, visited = proposal_bound(torch, boxes, scores, pre, topn, thr)
    emit({"phase": "proposals_ms", "batch": B, "pre": pre, "topn": topn, "nvidia_smi": smi,
          "sort": sort_ms, "select_kernel": select_ms, "wrapper": pr_ms,
          "visited_mean": float(visited.float().mean()), "visited_max": int(visited.max())})

    # fast serving at 640x640, counts at 0 before each of its two routes
    s640 = serving_640_phase(torch, args, dev, kernels, smi)
    emit(s640)
    # ViTDet-B served from uint8 frames: NMS within a level on the card
    vd = vitdet_phase(torch, args, dev)
    emit({**vd, "nvidia_smi": smi})
    # MViTv2-B served from uint8 frames: the pooling kernel at its published shapes
    mv = mvit_phase(torch, args, dev)
    emit({**mv, "nvidia_smi": smi})
    # Swin-B served from uint8 frames: the window attention kernel at its published shapes
    sw = swin_phase(torch, args, dev)
    emit({**sw, "nvidia_smi": smi})

    # 5. the CLIs and the trained weights, each with every count at 0 first
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    predictor = predictor_trained_phase(torch, kernels, cli, B, tmp)
    launches["predictor_cli"] = predictor["fast"]["launches"]
    emit(predictor)
    predictor640 = predictor_trained_phase(torch, kernels, cli, B, tmp, img_size=640,
                                           variants=(True,), ref_recall=REF_RECALL_640)
    emit(predictor640)

    # the trained, folded weights served on 128 validation frames (seed 1)
    trained = init_model(get_model(hp), torch.Generator().manual_seed(args.seed), device=dev)
    _, missing = load_keras_h5_weights(str(TRAINED_NPZ), trained)
    require(missing == [], f"trained weights miss {missing}")
    trained = fold_batch_norm(trained)
    val_u8, val_boxes, val_labels = (torch.from_numpy(a).to(dev) for a in next(
        data.get_dataset("synthetic", "validation").batches(B)))
    val_x, val_b = preprocess_batch(val_u8, val_boxes, hp.img_size, dtype=torch.bfloat16)
    predict_t = make_predict_fn(trained, hp, fast=True, device=dev)
    reset(kernels)
    out_t = predict_t(val_x)
    torch.cuda.synchronize()
    launches["serving_trained"] = counts(kernels)
    require(launches["serving_trained"]["ir_stage"] == 7
            and launches["serving_trained"]["proposals"] == 1,
            f"trained serving launches {launches['serving_trained']}")
    check_proposals(torch, out_t, B, topn)
    rec_t = proposal_recall(out_t["roi_boxes"], out_t["num_valid"], val_b, val_labels)
    with torch.no_grad():
        reg_t, cls_t = fast_mobilenet_forward(trained, val_x)
        boxes_t, scores_t = decode_outputs(anchors, reg_t, cls_t, hp)
        pk, pp = (fused_proposals(boxes_t, scores_t, pre, thr, topn),
                  fused_proposals_plain(boxes_t, scores_t, pre, thr, topn))
        for k in pp:
            require(torch.equal(pk[k], pp[k]), f"proposal kernel vs plain on trained scores: {k}")
        for k in pk:
            require(torch.equal(pk[k], out_t[k]), f"trained serving differs from its kernel in {k}")
        ms_t = time_ms(torch, lambda: predict_t(val_x), 5)
        busy_t, ops_t = device_profile(torch, lambda: predict_t(val_x))
    _, _, visited_t = proposal_bound(torch, boxes_t, scores_t, pre, topn, thr)
    top_t = top_candidates(scores_t[:nb], n4)
    boxes4_t = torch.gather(boxes_t[:nb], 1, top_t[..., None].expand(-1, -1, 4)).contiguous()
    scores4_t = torch.gather(scores_t[:nb], 1, top_t)
    cnt4_t, _ = check_nms(torch, nms_keep, nms_keep_plain, (boxes4_t, valid4, thr4, out4),
                          "trained config 4")
    sel_t, nv_t = batched_non_max_suppression(boxes4_t, scores4_t, out4, thr4)
    ref_sel_t, ref_nv_t = batched_non_max_suppression(boxes4_t, scores4_t, out4, thr4,
                                                      use_kernel=False)
    require(torch.equal(sel_t, ref_sel_t) and torch.equal(nv_t, ref_nv_t),
            "batched_non_max_suppression on trained scores: kernel and plain routes differ")
    decided_t = nms_decided(torch, nms_keep(boxes4_t, valid4, thr4, out4)[0], out4, 128).float()
    rounds_t = torch.ceil(decided_t / 32)
    e2e_random = e2e["fast_bf16"]
    emit({"phase": "serving_trained", "batch": B, "max_boxes": 8,
          "frames": "SyntheticVOC validation (seed 1), native",
          "dtype": "bfloat16", "nvidia_smi": smi, "launches": launches["serving_trained"],
          "recall": float(rec_t["recall"]), "gt": int(rec_t["num_gt"]),
          "num_valid_min": int(out_t["num_valid"].min()),
          "num_valid_mean": float(out_t["num_valid"].float().mean()),
          "ms_per_batch": ms_t, "img_per_s": B / ms_t * 1e3, "device_busy_ms": busy_t,
          "device_ops": ops_t,
          "random_weights_ms_per_batch": e2e_random["ms_per_batch"],
          "random_weights_img_per_s": e2e_random["img_per_s"],
          "visited_mean": float(visited_t.float().mean()), "visited_max": int(visited_t.max()),
          "random_weights_visited_mean": float(visited.float().mean()),
          "random_weights_visited_max": int(visited.max()),
          "config4_kept_min": int(cnt4_t.min()), "config4_kept_max": int(cnt4_t.max()),
          "config4_num_valid_min": int(nv_t.min()),
          "config4_decided_mean": float(decided_t.mean()),
          "config4_decided_max": int(decided_t.max()),
          "config4_rounds_mean": float(rounds_t.mean()), "config4_rounds_max": int(rounds_t.max()),
          "random_weights_config4_decided_mean": float(decided.mean()),
          "random_weights_config4_decided_max": int(decided.max()),
          "random_weights_config4_rounds_mean": float(rounds.mean()),
          "random_weights_config4_rounds_max": int(rounds.max())})

    trainer = trainer_cli_phase(torch, kernels, cli, data, B, tmp)
    launches["trainer_cli"] = trainer["launches"]
    emit(trainer)

    # raw frames through the s2d stem, then the data-parallel paths
    s2d = s2d_serving_phase(torch, args, dev, kernels, folded, trained, data)
    emit({**s2d, "nvidia_smi": smi})
    dp = data_parallel_phase(torch, args, dev, kernels, cli, tmp)
    emit({**dp, "nvidia_smi": smi})

    tg_bound, tg_by = targets_bound(tb, hp3.total_anchors, int(gt3.shape[1]))
    mt_bound, mt_by = matching_bound(tb, hp3.total_anchors, int(gt3.shape[1]))
    nms_bd, nms_by = nms_bound(torch, nms_keep(*nms_args)[0], valid4, out4, 128)
    emit({"kernels": [
        {"name": "fused_ir_stage", "route": "cuda",
         "source": "tpurpn_torch/kernels/csrc/ir_stage.cu",
         "replaces": "tpurpn/kernels/ir_stage_pallas.py:259",
         "launches": launches["bf16"]["ir_stage"],
         "launches_uint8": launches["uint8"]["ir_stage"],
         "launches_predictor_cli": launches["predictor_cli"]["ir_stage"],
         "launches_serving_trained": launches["serving_trained"]["ir_stage"],
         "launches_s2d_serving": s2d["random"]["launches"]["ir_stage"],
         "launches_640": s640["main_path_bf16"]["launches"]["ir_stage"],
         "launches_640_uint8": s640["main_path_uint8"]["launches"]["ir_stage"],
         "launches_predictor_cli_640": predictor640["fast"]["launches"]["ir_stage"],
         "max_abs_err": ir_err, "match": "bf16 tolerance", "ms": ir_ms,
         "device_ms": device_ms["ir_stage"],
         "wrapper_device_ms": wrapper_device_ms["ir_stage"],
         "plain_ms": ir_plain_ms, "bound_ms": ir_bound, "bound_by": ir_by,
         "library_ms": None,
         "max_abs_err_domain": max(v for k, v in ir_domain.items() if k.endswith("max_abs_err")),
         "s40": s640["ir_stage_s40"], "s47": s640["ir_stage_s47"],
         "s63": s640["ir_stage_s63"]},
        {"name": "fused_proposals", "route": "cuda",
         "source": "tpurpn_torch/kernels/csrc/proposal.cu",
         "replaces": "tpurpn/kernels/proposal_pallas.py:352",
         "launches": launches["bf16"]["proposals"],
         "launches_uint8": launches["uint8"]["proposals"],
         "launches_predictor_cli": launches["predictor_cli"]["proposals"],
         "launches_trainer_cli": launches["trainer_cli"]["proposals"],
         "launches_s2d_serving": s2d["random"]["launches"]["proposals"],
         "launches_mesh_predict": dp["one_rank_nccl"]["launches_predict"]["proposals"],
         "launches_640": s640["main_path_bf16"]["launches"]["proposals"],
         "max_abs_err": pr_err, "match": "bit-exact", "ms": pr_ms,
         "device_ms": device_ms["proposals"],
         "wrapper_device_ms": wrapper_device_ms["proposals"],
         "select_ms": select_ms, "sort_ms": sort_ms,
         "plain_ms": pr_plain_ms, "bound_ms": pr_bound, "bound_by": pr_by,
         "library_ms": None, "n14400": s640["proposals_n14400"]},
        {"name": "fused_proposals_levels", "kernel": "proposal_kernel_levels", "route": "cuda",
         "source": "tpurpn_torch/kernels/csrc/proposal.cu", "replaces": None,
         "launches": vd["launches"]["proposals"], "max_abs_err": 0.0, "match": "bit-exact",
         "B": vd["batch"], "candidates_per_image": vd["candidates_per_image"], "topn": vd["topn"],
         **{f: vd["proposals"][f] for f in ("ms", "device_ms", "wrapper_device_ms", "select_ms",
                                            "sort_ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None},
        *({"name": f"relpos_attention_{kind}", "kernel": "relpos_attention_kernel",
           "route": "cuda", "source": "tpurpn_torch/kernels/csrc/relpos_attention.cu",
           "replaces": None, "launches": vd["launches"]["relpos_attention"],
           "match": "bf16 tolerance", **vd["attention"][kind]} for kind in ("global", "window")),
        {"name": "mvit_pool", "kernel": "mvit_pool_kernel", "route": "cuda",
         "source": "tpurpn_torch/kernels/csrc/mvit_pool.cu", "replaces": None,
         "launches": mv["launches"]["mvit_pool"], "match": "one bf16 rounding",
         "B": mv["batch"], **mv["pool"]},
        {"name": "swin_attention", "kernel": "swin_attention_kernel", "route": "cuda",
         "source": "tpurpn_torch/kernels/csrc/swin_attention.cu", "replaces": None,
         "launches": sw["launches"]["swin_attention"],
         "match": "P and the output rounded to bf16", "B": sw["batch"], **sw["attention"]},
        {"name": "fused_rpn_targets", "route": "cuda",
         "source": "tpurpn_torch/kernels/csrc/targets.cu",
         "replaces": "tpurpn/kernels/target_pallas.py:355",
         "launches": launches["vgg16"]["targets"],
         "launches_mobilenet_v2": launches["mobilenet_v2"]["targets"],
         "launches_trainer_cli": launches["trainer_cli"]["targets"],
         "launches_device_data": {b: d["launches_counter"]["targets"]
                                  for b, d in device_data.items()},
         "executions_device_data": {b: d["targets_executions"]
                                    for b, d in device_data.items()},
         "launches_mesh_step": dp["one_rank_nccl"]["launches_step"]["targets"],
         "launches_trainer_cli_device_data": dp["trainer_cli"]["launches_counter"]["targets"],
         "executions_trainer_cli_device_data": dp["trainer_cli"]["targets_executions"],
         "max_abs_err": tg_err, "match": "labels bit-exact, deltas rel 1e-6",
         "ms": tg_ms, "device_ms": device_ms["targets"],
         "wrapper_device_ms": wrapper_device_ms["targets"], "plain_ms": tg_plain_ms,
         "bound_ms": tg_bound, "bound_by": tg_by,
         "library_ms": None, "cluster": clusters["rpn_targets"],
         "blocks": clusters["rpn_targets"] * tb},
        {"name": "fused_iou_matching", "route": "cuda",
         "source": "tpurpn_torch/kernels/csrc/targets.cu",
         "replaces": "tpurpn/kernels/target_pallas.py:413",
         "launches": launches["matching_path"]["iou_matching"],
         "max_abs_err": mt_err, "match": "bit-exact", "ms": mt_ms,
         "device_ms": device_ms["iou_matching"],
         "wrapper_device_ms": wrapper_device_ms["iou_matching"], "plain_ms": mt_plain_ms,
         "bound_ms": mt_bound, "bound_by": mt_by, "library_ms": None,
         "cluster": clusters["iou_matching"], "blocks": clusters["iou_matching"] * tb,
         "device_ms_n5": device_ms["iou_matching_n5"]},
        {"name": "nms_keep", "route": "cuda",
         "source": "tpurpn_torch/kernels/csrc/nms.cu",
         "replaces": "tpurpn/kernels/nms_pallas.py:191",
         "launches": launches["nms_path"]["nms"],
         "max_abs_err": nms_err, "match": "bit-exact", "ms": nms_ms,
         "device_ms": device_ms["nms"], "wrapper_device_ms": wrapper_device_ms["nms"],
         "plain_ms": nms_plain_ms,
         "bound_ms": nms_bd, "bound_by": nms_by, "library_ms": None},
        *({"name": k, "route": "cuda", "source": "tpurpn_torch/kernels/csrc/prefix.cu",
           "replaces": None, "launches": launches["bf16"][k],
           "launches_uint8": launches["uint8"][k],
           "match": "bit-exact" if k == "prefix_depthwise" else "one bf16 ulp",
           "max_abs_err": max(r["max_abs_err"] for r in pfx["convs"] if r["kernel"] == k),
           "bound_by": "bytes", **{f: pfx[k][f] for f in ("ms", "bound_ms", "plain_ms",
                                                          "library_ms", "convs")}}
          for k in ("prefix_pointwise", "prefix_depthwise")),
    ]})
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
