"""Frozen counts for MViTv2-B's RPN: the forward FLOPs of the published
model as it computes on a canvas, and the least time of its 24 pooled
attention cores. Peaks and the bound's rule are ``counts.py``'s (one H100
SXM at 700 W: 989 TFLOP/s bf16, 3.35 TB/s).

FLOPs are 2 per multiply-add of every matmul and convolution: the patch
embedding; in each block qkv over its input grid, the depthwise pooling
convs of q (at s_q) and of k and v (at s_kv), the attention core (q k^T,
attention x v and the two relative-position products q . R), proj over
the query grid, the skip's projection over the input grid where the width
changes, and the MLP; a window block's cores over its zero-padded windows,
as detectron2 computes them; the FPN's lateral and output convs; the RPN
head on every level. LayerNorm, GELU, softmax, the pools' max, the
upsampling and the decode are not counted.

The block shapes are derived from the configuration by detectron2's rules
(``reference.mvit.blocks``), not from the program.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from .counts import _bound
from .reference import mvit as ref


def _pooled(hw: Tuple[int, int], s: int) -> Tuple[int, int]:
    return tuple(-(-x // s) for x in hw)


def blocks(cfg: dict, hw: Tuple[int, int]) -> List[dict]:
    """Each block on a canvas of ``hw``: c_in, c_out, heads, the input, query
    and key grids, and its cores (``kind``, ``n`` cores an image, ``q`` and
    ``kv`` the grids each attends over), from ``reference.mvit.blocks``."""
    grid = ref.level_shapes(cfg, hw)[0]
    out = []
    for s in ref.blocks(cfg):
        q, kv = _pooled(grid, s["stride_q"]), _pooled(grid, s["stride_kv"])
        if s["window"]:
            qw, kw = s["window"] // s["stride_q"], s["window"] // s["stride_kv"]
            core = dict(kind="window", n=-(-q[0] // qw) * -(-q[1] // qw), q=(qw, qw), kv=(kw, kw))
        else:
            core = dict(kind="global", n=1, q=q, kv=kv)
        out.append(dict(c_in=s["dim"], c_out=s["dim_out"], heads=s["heads"], grid=grid, q=q, kv=kv,
                        core=core))
        grid = q
    return out


def core_flops(b: dict) -> int:
    """q k^T, attention x v and q . R_h, q . R_w of one block's cores, one
    image, all heads."""
    c = b["core"]
    tq, tk = math.prod(c["q"]), math.prod(c["kv"])
    d = b["c_out"] // b["heads"]
    per_head = 2 * 2 * tq * tk * d + 2 * tq * (c["kv"][0] + c["kv"][1]) * d
    return c["n"] * b["heads"] * per_head


def block_flops(b: dict) -> int:
    ci, co = b["c_in"], b["c_out"]
    g, q, kv = math.prod(b["grid"]), math.prod(b["q"]), math.prod(b["kv"])
    f = 2 * g * ci * 3 * co + 2 * 9 * co * (q + 2 * kv) + core_flops(b) + 2 * q * co * co
    f += 2 * g * ci * co if ci != co else 0
    return f + 2 * 2 * q * co * 4 * co


def fpn_flops(cfg: dict, hw: Tuple[int, int]) -> int:
    bl, o = blocks(cfg, hw), cfg["fpn_channels"]
    return sum(2 * math.prod(bl[i]["q"]) * (bl[i]["c_out"] * o + o * o * 9)
               for i in cfg["last_block_indexes"])


def head_flops(cfg: dict, hw: Tuple[int, int]) -> int:
    o, a = cfg["fpn_channels"], len(cfg["anchor_ratios"])
    per_px = cfg["head_convs"] * 2 * o * o * 9 + 2 * o * 5 * a
    return sum(math.prod(s) for s in ref.level_shapes(cfg, hw)) * per_px


def forward_flops(cfg: dict, hw: Tuple[int, int]) -> int:
    """FLOPs an image of the whole RPN forward on a canvas of ``hw``."""
    bl = blocks(cfg, hw)
    f = 2 * math.prod(bl[0]["grid"]) * 3 * cfg["patch_kernel"] ** 2 * cfg["embed_dim"]
    return f + sum(map(block_flops, bl)) + fpn_flops(cfg, hw) + head_flops(cfg, hw)


def attn_bound(batch: int, cfg: dict, hw: Tuple[int, int]) -> Tuple[float, str]:
    """(bound ms, bound by) of the 24 attention cores for a batch: their q
    k^T, attention x v and q . R products at the bf16 peak, against q, k and
    v read once, the output written once and the gathered tables read once
    (bf16), whichever is larger. It counts the work, not how it is done."""
    ops = nbytes = 0
    for b in blocks(cfg, hw):
        c, d = b["core"], b["c_out"] // b["heads"]
        ops += batch * core_flops(b)
        q, kv = math.prod(b["q"]), math.prod(b["kv"])
        nbytes += batch * (2 * q + 2 * kv) * b["c_out"] * 2
        nbytes += (c["q"][0] * c["kv"][0] + c["q"][1] * c["kv"][1]) * d * 2
    return _bound(ops, 0, nbytes)
