"""Frozen counts for the configurations with a feature pyramid (ViTDet):
the forward FLOPs of the published model as it computes, the least time of
its global attention cores, and the level-wise greedy walk that
``counts.proposal_bound`` is fed. Peaks and the bound's rule are
``counts.py``'s (one H100 SXM at 700 W: 989 TFLOP/s bf16, 3.35 TB/s).

FLOPs are 2 per multiply-add of every matmul and convolution: the patch
embedding; in each block qkv, proj and the MLP, and the attention core
(q k^T and attention x v, and the two relative-position products q . R);
a window block's qkv, proj and core over its zero-padded grid (64 x 64
tokens padded to 70 x 70 at 1024 px), as detectron2 computes them; the
pyramid's transposed and plain convolutions; the RPN head on every level.
LayerNorm, GELU, softmax, pooling and the decode are not counted.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

from .counts import _bound


def _grid(cfg: dict) -> int:
    return cfg["img_size"] // cfg["patch_size"]


def attention_core_flops(tokens_side: int, cfg: dict) -> int:
    """q k^T, attention x v and the two relative-position products of one
    image's attention over a side x side grid, all heads."""
    t, d = tokens_side * tokens_side, cfg["embed_dim"] // cfg["num_heads"]
    return cfg["num_heads"] * (2 * 2 * t * t * d + 2 * 2 * t * tokens_side * d)


def block_flops(cfg: dict, window: bool) -> int:
    """One block of one image: qkv and proj over the tokens it attends with
    (the padded grid in a window block), the core, the MLP."""
    g, c = _grid(cfg), cfg["embed_dim"]
    hidden = int(c * cfg["mlp_ratio"])
    if window:
        w = cfg["window_size"]
        side = math.ceil(g / w) * w
        tokens, core = side * side, (side // w) ** 2 * attention_core_flops(w, cfg)
    else:
        tokens, core = g * g, attention_core_flops(g, cfg)
    return 2 * tokens * c * 3 * c + 2 * tokens * c * c + core + 2 * 2 * g * g * c * hidden


def pyramid_flops(cfg: dict) -> int:
    g, c, o = _grid(cfg), cfg["embed_dim"], cfg["pyramid_channels"]
    up = lambda s, ci, co: 2 * s * s * ci * co * 4  # noqa: E731  a 2x2 stride-2 transposed conv
    f = up(g, c, c // 2) + up(2 * g, c // 2, c // 4) + up(g, c, c // 2)
    for side, ci in ((4 * g, c // 4), (2 * g, c // 2), (g, c), (g // 2, c)):
        f += 2 * side * side * (ci * o + o * o * 9)
    return f


def level_shapes(cfg: dict) -> Tuple[int, ...]:
    g = _grid(cfg)
    return (4 * g, 2 * g, g, g // 2, math.ceil(g // 2 / 2))


def head_flops(cfg: dict) -> int:
    o, a = cfg["pyramid_channels"], len(cfg["anchor_ratios"])
    per_px = cfg["head_convs"] * 2 * o * o * 9 + 2 * o * 5 * a
    return sum(s * s for s in level_shapes(cfg)) * per_px


def forward_flops(cfg: dict) -> int:
    """FLOPs an image of the whole RPN forward."""
    g, p, c = _grid(cfg), cfg["patch_size"], cfg["embed_dim"]
    f = 2 * g * g * 3 * p * p * c
    for i in range(cfg["depth"]):
        f += block_flops(cfg, i not in cfg["global_blocks"])
    return f + pyramid_flops(cfg) + head_flops(cfg)


def global_attn_bound(batch: int, cfg: dict) -> Tuple[float, str]:
    """(bound ms, bound by) of the global blocks' attention cores for a
    batch: q k^T and attention x v (and q . R) at the bf16 peak, against q,
    k and v read once, the output written once and each block's two tables
    read once (bf16)."""
    g, c = _grid(cfg), cfg["embed_dim"]
    n = len(cfg["global_blocks"])
    d = c // cfg["num_heads"]
    ops = n * batch * attention_core_flops(g, cfg)
    nbytes = n * (batch * g * g * c * 2 * 4 + 2 * (2 * g - 1) * d * 2)
    return _bound(ops, 0, nbytes)


def level_walk_counts(keep_flags: Iterable[bool], levels: Iterable[int], max_output: int
                      ) -> Tuple[int, int]:
    """(IoU tests, boxes visited) of one image's level-wise greedy walk over
    its merged score order: a box is visited up to the ``max_output``-th
    keep (or to the end) and tested against every box of its own level kept
    before it."""
    tests = visited = kept = 0
    per_level = {}
    for flag, lv in zip(keep_flags, levels):
        visited += 1
        tests += per_level.get(int(lv), 0)
        if flag:
            per_level[int(lv)] = per_level.get(int(lv), 0) + 1
            kept += 1
            if kept >= max_output:
                break
    return tests, visited


