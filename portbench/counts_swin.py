"""Frozen counts for Swin-B's RPN: the forward FLOPs of the published model
as it computes on a canvas, and the least time of its 24 window attention
cores. Peaks and the bound's rule are ``counts.py``'s (one H100 SXM at
700 W: 989 TFLOP/s bf16, 3.35 TB/s).

FLOPs are 2 per multiply-add of every matmul and convolution: the patch
embedding; in each block qkv, the attention core (q k^T and attention x
v) and proj over the grid zero-padded to whole windows, as Swin computes
them, and the MLP over the grid; each patch merging's reduction; the
FPN's lateral and output convs; the RPN head on every level. LayerNorm,
GELU, softmax, the bias and mask adds, the pools, the upsampling and the
decode are not counted.

The stage grids are derived from the configuration (the canvas over the
patch size, then ceiling halvings), not from the program.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from .counts import _bound
from .reference import swin as ref


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def stages(cfg: dict, hw: Tuple[int, int]) -> List[dict]:
    """Each stage on a canvas of ``hw``: ``dim``, ``depth``, ``heads``, its
    grid and the grid padded to whole windows."""
    m = cfg["window_size"]
    grid = tuple(_ceil(x, cfg["patch_size"]) for x in hw)
    out = []
    for s in ref.stages(cfg):
        out.append(dict(s, grid=grid, padded=tuple(_ceil(x, m) * m for x in grid)))
        grid = tuple(_ceil(x, 2) for x in grid)
    return out


def core_flops(cfg: dict, s: dict) -> int:
    """q k^T and attention x v of one block's windows, one image, all heads:
    4 M^2 d a query, over the padded grid's tokens and every head."""
    return 4 * cfg["window_size"] ** 2 * math.prod(s["padded"]) * s["dim"]


def block_flops(cfg: dict, s: dict) -> int:
    c, t, tp = s["dim"], math.prod(s["grid"]), math.prod(s["padded"])
    hidden = int(c * cfg["mlp_ratio"])
    return 2 * tp * c * 3 * c + core_flops(cfg, s) + 2 * tp * c * c + 2 * 2 * t * c * hidden


def backbone_flops(cfg: dict, hw: Tuple[int, int]) -> int:
    st = stages(cfg, hw)
    f = 2 * math.prod(st[0]["grid"]) * 3 * cfg["patch_size"] ** 2 * cfg["embed_dim"]
    for i, s in enumerate(st):
        f += s["depth"] * block_flops(cfg, s)
        if i < len(st) - 1:  # the merging's 4C -> 2C reduction on the next grid
            f += 2 * math.prod(st[i + 1]["grid"]) * 4 * s["dim"] * 2 * s["dim"]
    return f


def fpn_flops(cfg: dict, hw: Tuple[int, int]) -> int:
    o = cfg["fpn_channels"]
    return sum(2 * math.prod(s["grid"]) * (s["dim"] * o + o * o * 9) for s in stages(cfg, hw))


def head_flops(cfg: dict, hw: Tuple[int, int]) -> int:
    o, a = cfg["fpn_channels"], len(cfg["anchor_ratios"])
    per_px = cfg["head_convs"] * 2 * o * o * 9 + 2 * o * 5 * a
    return sum(math.prod(s) for s in ref.level_shapes(cfg, hw)) * per_px


def forward_flops(cfg: dict, hw: Tuple[int, int]) -> int:
    """FLOPs an image of the whole RPN forward on a canvas of ``hw``."""
    return backbone_flops(cfg, hw) + fpn_flops(cfg, hw) + head_flops(cfg, hw)


def attn_bound(batch: int, cfg: dict, hw: Tuple[int, int]) -> Tuple[float, str]:
    """(bound ms, bound by) of the 24 window attention cores for a batch:
    their q k^T and attention x v at the bf16 peak, against q, k and v read
    once and the output written once (bf16, over the padded grids),
    whichever is larger. The bias and the mask, a few kB a block once made,
    are left out. It counts the work, not how it is done."""
    ops = nbytes = 0
    for s in stages(cfg, hw):
        ops += batch * s["depth"] * core_flops(cfg, s)
        nbytes += batch * s["depth"] * 4 * math.prod(s["padded"]) * s["dim"] * 2
    return _bound(ops, 0, nbytes)
