"""Frozen counts of the work the benchmarked paths need: forward FLOPs of
the backbones and the RPN head from their published layer shapes, and the
least time (bound) of the port's kernels from the operations and bytes
their inputs need.

Peaks are NVIDIA's data sheet for one H100 SXM, dense, at its 700 W power
limit: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them,
3.35 TB/s of HBM3. A bound is the larger of bytes over the bandwidth and of
operations over the peak of their type (the tensor cores and the f32 units
run at the same time). A roofline share is bound / measured time.

The kernel bounds are copies of the counts ``chip_smoke.py`` used to judge
the kernels (``ir_stage_bound``, ``proposal_bound``, ``targets_bound``),
taken from shapes here instead of tensors so that nothing of the program
enters the yardstick.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence, Tuple

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
IOU_OPS = 14  # f32 operations of one IoU test (4 min/max, 4 sub, 3 max, mul, add, div)


# ---------------------------------------------------------------------------
# forward FLOPs (2 per multiply-add of every convolution; activations,
# BatchNorm, pooling and the decode are not counted)
# ---------------------------------------------------------------------------


def conv_flops(h: int, w: int, c_in: int, c_out: int, k: int, stride: int = 1,
               groups: int = 1, same: bool = True) -> Tuple[int, int, int]:
    """(flops, h_out, w_out) of one convolution on an h x w input."""
    if same:
        ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    else:
        ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    return 2 * ho * wo * c_out * (c_in // groups) * k * k, ho, wo


# (blocks, expansion, channels, first stride) of MobileNetV2 (alpha 1.0) up
# to the stage that holds block_12; block_13_expand follows (Sandler et al.
# 2018, Table 2; Keras numbering)
MOBILENET_V2_STAGES = ((1, 1, 16, 1), (2, 6, 24, 2), (3, 6, 32, 2), (4, 6, 64, 2),
                       (3, 6, 96, 1))
# VGG16's convolutions up to block5_conv3 (Simonyan and Zisserman 2014,
# configuration D), a 2x2 VALID max-pool before blocks 2-5
VGG16_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))


def head_flops(fm: int, c_in: int, anchors: int = 9) -> int:
    """The RPN head: a 3x3 conv to 512, then 1x1 convs to the anchors'
    objectness and 4 deltas each."""
    f = conv_flops(fm, fm, c_in, 512, 3)[0]
    f += conv_flops(fm, fm, 512, anchors, 1)[0]
    f += conv_flops(fm, fm, 512, 4 * anchors, 1)[0]
    return f


def mobilenet_v2_flops(img: int) -> int:
    """MobileNetV2 up to block_13_expand (the tap block_13_expand_relu) plus
    the head, on an img x img input."""
    f, h, w = conv_flops(img, img, 3, 32, 3, 2)  # Conv1
    c = 32
    for n, t, c_out, s in MOBILENET_V2_STAGES:
        for i in range(n):
            stride = s if i == 0 else 1
            mid = c * t
            if t != 1:
                f += conv_flops(h, w, c, mid, 1)[0]
            df, h, w = conv_flops(h, w, mid, mid, 3, stride, groups=mid)
            f += df
            f += conv_flops(h, w, mid, c_out, 1)[0]
            c = c_out
    f += conv_flops(h, w, c, 576, 1)[0]  # block_13_expand
    return f + head_flops(h, 576)


def vgg16_flops(img: int) -> int:
    """VGG16 up to block5_conv3 plus the head, on an img x img input."""
    f, h, c = 0, img, 3
    for b, chans in enumerate(VGG16_BLOCKS):
        if b:
            h //= 2
        for c_out in chans:
            f += conv_flops(h, h, c, c_out, 3)[0]
            c = c_out
    return f + head_flops(h, 512)


def forward_flops(backbone: str, img: int) -> int:
    if backbone == "mobilenet_v2":
        return mobilenet_v2_flops(img)
    if backbone == "vgg16":
        return vgg16_flops(img)
    raise ValueError(f"no FLOP count for backbone {backbone!r}")


# ---------------------------------------------------------------------------
# kernel bounds
# ---------------------------------------------------------------------------


def _bound(ops_bf16: float, ops_f32: float, nbytes: float) -> Tuple[float, str]:
    t_ops = max(ops_bf16 / PEAK_BF16, ops_f32 / PEAK_F32)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# The MobileNetV2 serving stage the IR-stage kernel runs: blocks 7-12
# (c_in, c_exp, c_out) and block_13_expand as the expand-only tail.
SERVING_STAGE = ((64, 384, 64), (64, 384, 64), (64, 384, 64), (64, 384, 96),
                 (96, 576, 96), (96, 576, 96), (96, 576, None))


def ir_stage_bound(batch: int, s: int, blocks: Sequence[Tuple[int, int, Optional[int]]]
                   = SERVING_STAGE) -> Tuple[float, str]:
    """(bound ms, bound by) of the fused IR stage on a (batch, s, s, c_in)
    bf16 input: the 1x1 products on the tensor cores, the f32 depthwise;
    the input and output read and written once, and the stage's weights
    read once in the kernel's operand layout (bf16 1x1 weights, f32 biases
    and depthwise taps)."""
    px = batch * s * s
    mm = dw = 0
    wbytes = 0
    for c_in, c_exp, c_out in blocks:
        mm += 2 * px * c_in * c_exp
        wbytes += c_in * c_exp * 2 + c_exp * 4
        if c_out is not None:
            dw += 2 * 9 * px * c_exp
            mm += 2 * px * c_exp * c_out
            wbytes += 9 * c_exp * 4 + c_exp * 4 + c_exp * c_out * 2 + c_out * 4
    c_last = blocks[-1][2] or blocks[-1][1]
    nbytes = px * blocks[0][0] * 2 + px * c_last * 2 + wbytes
    return _bound(mm, dw, nbytes)


def proposal_bound(batch: int, n: int, max_output: int, tests: int, visited: int
                   ) -> Tuple[float, str]:
    """(bound ms, bound by) of top-k + greedy NMS for ``batch`` images of
    ``n`` candidates: every score is read (the top-k needs all), the
    ``visited`` boxes of the greedy walk (up to the last keep, summed over
    the images) are read once, each is tested against the boxes kept before
    it (``tests`` IoU tests in all), and the outputs are written."""
    nbytes = batch * n * 4 + visited * 16 + batch * max_output * 20 + batch * 4
    return _bound(0, tests * IOU_OPS, nbytes)


def nms_walk_counts(keep_flags: Iterable[bool], max_output: int) -> Tuple[int, int]:
    """(IoU tests, boxes visited) of one image's greedy walk over its
    score-sorted candidates, from the keep flags of the walk: a box is
    visited up to the ``max_output``-th keep (or to the end), and is tested
    against every box kept before it."""
    tests = visited = kept = 0
    for flag in keep_flags:
        visited += 1
        tests += kept
        kept += bool(flag)
        if kept >= max_output:
            break
    return tests, visited


def targets_bound(batch: int, n: int, m: int) -> Tuple[float, str]:
    """(bound ms, bound by) of target assignment: batch*n*m IoU tests, 2 x 4
    radix passes over the n keys of each image (compare, digit, count) plus
    the key and label work (~16 operations an anchor); the bytes of the
    anchors, GT rows, labels and words read once and of the deltas and
    labels written once."""
    ops = batch * n * m * IOU_OPS + batch * n * (2 * 4 * 3 + 16)
    nbytes = n * 16 + batch * m * 20 + batch * 2 * n * 4 + batch * n * 20
    return _bound(0, ops, nbytes)
