"""RPN training-target assignment (port of ``tpurpn/target.py``).

Rebuild of the reference's ``utils/train_utils.calculate_rpn_actual_outputs``
and ``randomly_select_xyz_mask`` (SURVEY.md §3.4), with static shapes:

* dense anchor x GT IoU matching (best GT per anchor, first max on ties);
* positives = IoU > pos_threshold, plus the forced best anchor of every valid
  GT;
* balanced subsampling: <= total_pos_bboxes positives, negatives fill the
  rest of the (total_pos + total_neg) minibatch;
* labels 1 / 0 / -1 and encoded deltas / variances at the positives.

**One selection contract, kernel and plain path.** Subsampling ranks the
candidates by unique 28-bit keys (the top random bits of a per-anchor int32
word above the anchor index, :func:`selection_keys`) and keeps the k
smallest. The CUDA kernel (``kernels.targets.fused_rpn_targets``) and the
plain path here consume the same words, so they select bit-identical
subsets, and both select what ``tpurpn`` selects from the same words. torch
cannot reproduce ``jax.random.bits``: the port draws its own words from a
``torch.Generator`` (:func:`target_rand_bits`); parity tests pass in
``tpurpn``'s.

The words are int32. ``lax.shift_right_logical`` is a logical shift; torch's
``>>`` on int32 is arithmetic (``-8 >> 1 == -4``), so the plain path shifts
the words as unsigned 32-bit values held in int64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .boxes import generate_iou_map, get_deltas_from_bboxes
from .config import HyperParams

KEY_SENTINEL = 1 << 29  # above any real selection key (< 2**28)


def _lane_bits_for(n: int) -> int:
    """Width of the anchor-index field in the 28-bit selection keys: 14 up
    to 16,384 anchors, wider for larger grids; at least 8 random bits must
    remain, so grids beyond 2**20 anchors raise."""
    bits = max(14, (n - 1).bit_length())
    if bits > 20:
        raise ValueError(
            f"anchor grid of {n} anchors needs a {bits}-bit index field, "
            "leaving <8 random rank bits in the 28-bit selection keys"
        )
    return bits


def selection_keys(rand_words: torch.Tensor, n: int) -> torch.Tensor:
    """Unique 28-bit selection keys from (..., n) int32 random words:
    (top (28 - lane_bits) random bits << lane_bits) | anchor_index, int32."""
    lane_bits = _lane_bits_for(n)
    lane = torch.arange(n, dtype=torch.int64, device=rand_words.device)
    unsigned = rand_words.long() & 0xFFFFFFFF  # logical, not arithmetic, shift
    hi = (unsigned >> (32 - (28 - lane_bits))) << lane_bits
    return (hi | lane).to(torch.int32)


def select_by_keys(
    cand: torch.Tensor,
    rand_words: torch.Tensor,
    k_eff: torch.Tensor,
    k_max: int | None = None,
) -> torch.Tensor:
    """Keep the ``k_eff`` candidates with the smallest selection keys.

    cand: (B, N) bool; rand_words: (B, N) int32; k_eff: (B,) float, the
    number to keep (callers pass min(budget, available)). Returns the (B, N)
    bool selected mask. ``k_max``, a static bound on ``k_eff``, takes the
    threshold from one top-k instead of a full sort; the selection is the
    same either way.
    """
    N = cand.shape[-1]
    keys = torch.where(cand, selection_keys(rand_words, N), KEY_SENTINEL)
    k_int = k_eff.to(torch.int64)
    if k_max is not None and 0 < k_max < N:
        sorted_keys = torch.topk(keys, k_max, dim=-1, largest=False, sorted=True).values
        k_idx = torch.clamp(k_int - 1, 0, k_max - 1)
    else:
        sorted_keys = torch.sort(keys, dim=-1).values
        k_idx = torch.clamp(k_int - 1, 0, N - 1)
    thr = torch.gather(sorted_keys, 1, k_idx[:, None])
    thr = torch.where(k_eff[:, None] > 0, thr, -1)
    return keys <= thr


def target_rand_bits(
    generator: torch.Generator, batch: int, n: int, device=None
) -> torch.Tensor:
    """(B, 2, N) int32 random words for positive (row 0) and negative
    (row 1) sampling, drawn from ``generator`` on its own device and moved to
    ``device`` (default: the generator's)."""
    words = torch.randint(
        -(2**31), 2**31, (batch, 2, n), generator=generator,
        device=generator.device, dtype=torch.int32,
    )
    return words if device is None else words.to(device)


def random_select_mask(
    mask: torch.Tensor,
    max_count,
    generator: torch.Generator,
    k_max: int | None = None,
) -> torch.Tensor:
    """Keep a uniformly random subset of at most ``max_count`` True entries
    of ``mask`` (..., N): the reference's ``randomly_select_xyz_mask``
    (random ranking, keep the first k), kept for API parity. The target
    path uses :func:`select_by_keys`. ``k_max`` bounds ``max_count`` and
    swaps two full argsorts for one top-k."""
    r = torch.rand(mask.shape, generator=generator, device=generator.device).to(mask.device)
    scores = torch.where(mask, r, -1.0)
    limit = torch.as_tensor(max_count, device=mask.device)
    if limit.ndim:
        limit = limit[..., None]
    if k_max is not None and k_max < mask.shape[-1]:
        v, idx = torch.topk(scores, k_max, dim=-1)  # descending
        ranks = torch.arange(k_max, device=mask.device)
        sel = (ranks < limit) & (v >= 0.0)  # uniform r >= 0; excluded carry -1
        return torch.zeros_like(mask).scatter(-1, idx, sel)
    order = torch.argsort(-scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1)
    return mask & (ranks < limit)


def iou_matching_plain(
    anchors: torch.Tensor, gt_boxes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`iou_matching` in plain PyTorch, through the (B, N, M) IoU map."""
    iou_map = generate_iou_map(anchors[None], gt_boxes)  # (B, N, M)
    return (
        torch.amax(iou_map, dim=2),
        torch.argmax(iou_map, dim=2).to(torch.int32),
        torch.argmax(iou_map, dim=1).to(torch.int32),
    )


def iou_matching(
    anchors: torch.Tensor, gt_boxes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense IoU matching reductions of (N, 4) anchors and (B, M, 4) GT boxes:
    (merged_iou (B, N) f32, best_gt_per_anchor (B, N) int32,
    best_anchor_per_gt (B, M) int32), each argmax the first maximum.

    Runs ``kernels.targets.fused_iou_matching``: the CUDA kernel on CUDA
    tensors, :func:`iou_matching_plain` on CPU tensors.
    """
    from .kernels.targets import fused_iou_matching

    return fused_iou_matching(anchors, gt_boxes)


def rpn_targets_plain(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    rand_bits: torch.Tensor,
    hp: HyperParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Target assignment in plain PyTorch, the plain version of
    ``kernels.targets.fused_rpn_targets``: (deltas (B, N, 4) f32, already
    divided by the variances; labels (B, N) f32 in {1, 0, -1})."""
    N = anchors.shape[0]
    merged_iou, best_gt, best_anchor = iou_matching_plain(anchors, gt_boxes)
    pos_cand = merged_iou > hp.pos_threshold

    # forced positive: the best anchor of every valid GT (padding rows have
    # label -1 and must not force anchor 0)
    valid_gt = gt_labels != -1  # (B, M)
    anchor_ids = torch.arange(N, device=anchors.device)[None, :, None]
    forced = ((best_anchor[:, None, :] == anchor_ids) & valid_gt[:, None, :]).any(dim=2)
    pos_cand = pos_cand | forced

    avail_pos = pos_cand.sum(dim=-1).float()
    pos_mask = select_by_keys(
        pos_cand, rand_bits[:, 0],
        torch.clamp(avail_pos, max=float(hp.total_pos_bboxes)),
        k_max=hp.total_pos_bboxes,
    )
    pos_count = pos_mask.sum(dim=-1).float()

    neg_cand = (merged_iou < hp.neg_threshold) & ~pos_mask
    avail_neg = neg_cand.sum(dim=-1).float()
    total = float(hp.total_pos_bboxes + hp.total_neg_bboxes)
    neg_mask = select_by_keys(
        neg_cand, rand_bits[:, 1], torch.minimum(total - pos_count, avail_neg),
        k_max=hp.total_pos_bboxes + hp.total_neg_bboxes,
    )
    labels = torch.where(pos_mask, 1.0, torch.where(neg_mask, 0.0, -1.0))

    # regression targets: the matched GT box of each positive, encoded
    gt_map = torch.gather(gt_boxes, 1, best_gt.long()[..., None].expand(-1, -1, 4))
    expanded_gt = torch.where(pos_mask[..., None], gt_map, 0.0)
    variances = torch.tensor(hp.variances, dtype=torch.float32, device=anchors.device)
    deltas = get_deltas_from_bboxes(anchors[None], expanded_gt) / variances
    return deltas, labels


def calculate_rpn_actual_outputs(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    hp: HyperParams,
    generator: Optional[torch.Generator] = None,
    *,
    rand_bits: Optional[torch.Tensor] = None,
    use_kernel: bool | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense RPN regression and objectness targets for a batch.

    Args:
      anchors: (N, 4) normalized [y1, x1, y2, x2] anchor grid.
      gt_boxes: (B, M, 4) normalized GT boxes, zero-padded rows.
      gt_labels: (B, M) int labels, -1 on padding rows.
      generator: draws the (B, 2, N) selection words when ``rand_bits`` is
        not given.
      rand_bits: the words themselves (``tpurpn.target.target_rand_bits``'s
        to replay a ``tpurpn`` run).
      use_kernel: None (default) runs the CUDA kernel on CUDA tensors and the
        plain path on CPU tensors; False always runs the plain path.

    Returns (bbox_deltas (B, fm, fm, A*4) f32, deltas / variances at the
    positives and zero elsewhere; bbox_labels (B, fm, fm, A) f32).
    """
    B, N = gt_boxes.shape[0], anchors.shape[0]
    fm, A = hp.feature_map_shape, hp.anchor_count
    if N != fm * fm * A:
        raise ValueError(f"{N} anchors do not fill a {fm}x{fm}x{A} grid")
    if rand_bits is None:
        if generator is None:
            raise ValueError("pass rand_bits or a generator to draw them from")
        rand_bits = target_rand_bits(generator, B, N, anchors.device)
    if use_kernel is None:
        use_kernel = anchors.device.type != "cpu"
    if use_kernel:
        from .kernels.targets import fused_rpn_targets

        deltas, labels = fused_rpn_targets(anchors, gt_boxes, gt_labels, rand_bits, hp)
    else:
        deltas, labels = rpn_targets_plain(anchors, gt_boxes, gt_labels, rand_bits, hp)
    return deltas.reshape(B, fm, fm, A * 4), labels.reshape(B, fm, fm, A)
