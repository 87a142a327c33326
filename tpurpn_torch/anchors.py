"""Anchor-grid generation (port of ``tpurpn/anchors.py``).

Rebuild of the reference's ``utils/bbox_utils.generate_base_anchors`` and
``generate_anchors`` (SURVEY.md §2 row 5). Boxes are ``[y1, x1, y2, x2]`` in
image-normalized coordinates ([0, 1]).

The arithmetic is the JAX package's numpy code, kept op for op, so the grids
are bit-identical to ``tpurpn`` (9,216 anchors for MobileNetV2 at 500 px,
8,649 for VGG16). ``generate_anchors`` hands the grid over as a float32 tensor
on the requested device; it is computed once per ``HyperParams``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .config import HyperParams


def _base_anchors_np(hp: HyperParams) -> np.ndarray:
    scales = np.asarray(hp.anchor_scales, dtype=np.float64)
    ratios = np.asarray(hp.anchor_ratios, dtype=np.float64)
    # scale-major, ratio-minor ordering
    scale_grid = np.repeat(scales, len(ratios))
    ratio_grid = np.tile(ratios, len(scales))
    w = scale_grid / np.sqrt(ratio_grid)
    h = scale_grid * np.sqrt(ratio_grid)
    base = np.stack([-h / 2.0, -w / 2.0, h / 2.0, w / 2.0], axis=-1)
    return (base / hp.img_size).astype(np.float32)


def generate_base_anchors(hp: HyperParams, device=None) -> torch.Tensor:
    """Area-preserving base anchors centered at the origin, normalized by img_size.

    For each (scale, ratio) — scale-major order — width = scale / sqrt(ratio)
    and height = scale * sqrt(ratio). Returns (anchor_count, 4) float32.
    """
    return torch.tensor(_base_anchors_np(hp), device=device)


@functools.lru_cache(maxsize=None)
def _generate_anchors_np(hp: HyperParams) -> np.ndarray:
    fm = hp.feature_map_shape
    stride = 1.0 / fm
    coords = (np.arange(fm, dtype=np.float64) / fm) + stride / 2.0
    grid_x, grid_y = np.meshgrid(coords, coords)  # (fm, fm), x varies fastest
    centers = np.stack(
        [grid_y.ravel(), grid_x.ravel(), grid_y.ravel(), grid_x.ravel()], axis=-1
    )  # (fm*fm, 4)
    base = _base_anchors_np(hp).astype(np.float64)  # (A, 4)
    anchors = centers[:, None, :] + base[None, :, :]  # (fm*fm, A, 4)
    anchors = anchors.reshape(-1, 4)
    return np.clip(anchors, 0.0, 1.0).astype(np.float32)


def generate_anchors(hp: HyperParams, device=None) -> torch.Tensor:
    """Dense anchor grid: (fm*fm*anchor_count, 4) float32, clipped to [0, 1].

    Row order is row-major over (grid_y, grid_x, anchor), the layout of the
    conv head outputs reshaped to (B, fm*fm*A, ...).
    """
    # a copy: the cached array must not alias a tensor a caller may mutate
    return torch.tensor(_generate_anchors_np(hp), device=device)
