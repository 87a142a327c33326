"""Box geometry: delta encode/decode, IoU, NMS (port of ``tpurpn/boxes.py``).

Rebuild of the reference's ``utils/bbox_utils`` (SURVEY.md §2 row 5). Boxes are
``[y1, x1, y2, x2]`` in normalized image coordinates throughout.

Every function keeps the JAX package's arithmetic op for op. The NMS is the
same exact, blockwise greedy NMS as ``tpurpn.boxes._nms_keep_sorted_batched``
(identical selection to ``tf.image.non_max_suppression``); given the same f32
candidates it selects the same boxes bit for bit. It is also the plain
version of the proposal kernel (``tpurpn_torch.kernels.proposal``) and of the
NMS kernel (``tpurpn_torch.kernels.nms``), which ``batched_non_max_suppression``
runs on CUDA tensors, as ``tpurpn`` runs its Pallas kernel on a TPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-8


# ---------------------------------------------------------------------------
# Delta encode / decode
# ---------------------------------------------------------------------------


def _box_ctr_size(boxes: torch.Tensor):
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    cy = boxes[..., 0] + 0.5 * h
    cx = boxes[..., 1] + 0.5 * w
    return cy, cx, h, w


def get_deltas_from_bboxes(bboxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """Encode gt boxes as (dy, dx, dh, dw) deltas relative to anchor boxes.

    dy = (gt_cy - a_cy) / a_h, dh = log(gt_h / a_h) (and likewise for x/w),
    with the reference's zero-size guards: zero-size anchors are clamped to
    1e-3 and zero-size gt rows (padding) encode to all-zero deltas.
    Shapes broadcast: (..., 4) x (..., 4) -> (..., 4).
    """
    a_cy, a_cx, a_h, a_w = _box_ctr_size(bboxes)
    g_cy, g_cx, g_h, g_w = _box_ctr_size(gt_boxes)

    a_h = torch.where(a_h == 0, 1e-3, a_h)
    a_w = torch.where(a_w == 0, 1e-3, a_w)
    gt_h_safe = torch.where(g_h <= 0, 1.0, g_h)
    gt_w_safe = torch.where(g_w <= 0, 1.0, g_w)

    dy = torch.where(g_h == 0, 0.0, (g_cy - a_cy) / a_h)
    dx = torch.where(g_w == 0, 0.0, (g_cx - a_cx) / a_w)
    dh = torch.where(g_h == 0, 0.0, torch.log(gt_h_safe / a_h))
    dw = torch.where(g_w == 0, 0.0, torch.log(gt_w_safe / a_w))
    return torch.stack([dy, dx, dh, dw], dim=-1)


def get_bboxes_from_deltas(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Decode (dy, dx, dh, dw) deltas against anchors -> [y1, x1, y2, x2]."""
    a_cy, a_cx, a_h, a_w = _box_ctr_size(anchors)
    h = torch.exp(deltas[..., 2]) * a_h
    w = torch.exp(deltas[..., 3]) * a_w
    cy = deltas[..., 0] * a_h + a_cy
    cx = deltas[..., 1] * a_w + a_cx
    return torch.stack(
        [cy - 0.5 * h, cx - 0.5 * w, cy + 0.5 * h, cx + 0.5 * w], dim=-1
    )


def apply_deltas(anchors: torch.Tensor, deltas: torch.Tensor, weights, scale_clamp: float
                 ) -> torch.Tensor:
    """detectron2's ``Box2BoxTransform.apply_deltas`` on [y1, x1, y2, x2]
    boxes: deltas (..., 4) in (dx, dy, dw, dh) order, divided by ``weights``
    (wx, wy, ww, wh); dw and dh clamped above at ``scale_clamp``; centres
    and sizes as detectron2 computes them, in f32."""
    wx, wy, ww, wh = weights
    h = anchors[..., 2] - anchors[..., 0]
    w = anchors[..., 3] - anchors[..., 1]
    cy = anchors[..., 0] + 0.5 * h
    cx = anchors[..., 1] + 0.5 * w
    dw = torch.clamp(deltas[..., 2] / ww, max=scale_clamp)
    dh = torch.clamp(deltas[..., 3] / wh, max=scale_clamp)
    pcx = deltas[..., 0] / wx * w + cx
    pcy = deltas[..., 1] / wy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcy - 0.5 * ph, pcx - 0.5 * pw, pcy + 0.5 * ph, pcx + 0.5 * pw], dim=-1)


def clip_bboxes(boxes: torch.Tensor) -> torch.Tensor:
    """Clip normalized boxes to the [0, 1] image window."""
    return torch.clamp(boxes, 0.0, 1.0)


def _hw_scale(boxes: torch.Tensor, height, width) -> torch.Tensor:
    h = torch.as_tensor(height, dtype=torch.float32, device=boxes.device)
    w = torch.as_tensor(width, dtype=torch.float32, device=boxes.device)
    return torch.stack([h, w] * 2)


def normalize_bboxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Pixel [y1,x1,y2,x2] -> normalized (reference: bbox_utils.normalize_bboxes)."""
    return boxes / _hw_scale(boxes, height, width)


def denormalize_bboxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Normalized [y1,x1,y2,x2] -> pixel (reference: bbox_utils.denormalize_bboxes)."""
    return boxes * _hw_scale(boxes, height, width)


# ---------------------------------------------------------------------------
# IoU
# ---------------------------------------------------------------------------


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0.0
    )


def generate_iou_map(bboxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """Batched dense IoU: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    y1 = torch.maximum(bboxes[..., :, None, 0], gt_boxes[..., None, :, 0])
    x1 = torch.maximum(bboxes[..., :, None, 1], gt_boxes[..., None, :, 1])
    y2 = torch.minimum(bboxes[..., :, None, 2], gt_boxes[..., None, :, 2])
    x2 = torch.minimum(bboxes[..., :, None, 3], gt_boxes[..., None, :, 3])
    inter = torch.clamp(y2 - y1, min=0.0) * torch.clamp(x2 - x1, min=0.0)
    union = (
        bbox_area(bboxes)[..., :, None] + bbox_area(gt_boxes)[..., None, :] - inter
    )
    return inter / torch.clamp(union, min=_EPS)


# ---------------------------------------------------------------------------
# NMS — exact greedy, blockwise
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _nms_keep_sorted_batched(
    boxes_sorted: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    block: int,
    max_output: int,
    levels: torch.Tensor | None = None,
) -> torch.Tensor:
    """Greedy-NMS keep masks over batched score-sorted boxes: (B,n,4) -> (B,n).

    A box is kept iff its IoU with every higher-scoring kept box is
    <= iou_threshold; an image stops keeping once it has max_output boxes
    (checked per block, so the last block may overshoot, as in ``tpurpn``).
    Blocks are screened against each image's kept-box buffer, and suppression
    inside a block is resolved by fixpoint iteration of
    m[j] = alive[j] & !any_{i<j}(m[i] & iou[i,j] > thr), whose unique fixpoint
    is the greedy keep set. With ``levels`` ((B, n) ids) a box suppresses
    only boxes of its own level.
    """
    B, n, _ = boxes_sorted.shape
    assert n % block == 0, "caller pads to a multiple of block"
    dev = boxes_sorted.device
    kmax = _round_up(max_output + block, block)
    # compare in the boxes' dtype, as jnp's weakly typed python float does
    thr = torch.tensor(iou_threshold, dtype=boxes_sorted.dtype, device=dev)
    ar = torch.arange(block, device=dev)
    tri = ar[:, None] < ar[None, :]  # earlier box i can suppress later box j
    buf_slot = torch.arange(kmax, device=dev)[None, :]

    keep = torch.zeros((B, n), dtype=torch.bool, device=dev)
    buf = torch.zeros((B, kmax, 4), dtype=boxes_sorted.dtype, device=dev)
    if levels is not None:
        buf_lev = torch.zeros((B, kmax), dtype=torch.int64, device=dev)
    kept_count = torch.zeros((B,), dtype=torch.int64, device=dev)
    for start in range(0, n, block):
        active_img = kept_count < max_output  # frozen images keep nothing more
        if not bool(active_img.any()):
            break
        blk = boxes_sorted[:, start : start + block]
        valid_blk = valid[:, start : start + block]

        iou_buf = generate_iou_map(blk, buf)  # (B, block, kmax)
        buf_active = buf_slot < kept_count[:, None]
        over_buf = (iou_buf > thr) & buf_active[:, None, :]
        over_tri = (generate_iou_map(blk, blk) > thr) & tri
        if levels is not None:
            lev = levels[:, start : start + block].long()
            over_buf &= lev[:, :, None] == buf_lev[:, None, :]
            over_tri &= lev[:, :, None] == lev[:, None, :]
        suppressed = over_buf.any(dim=2)
        alive = valid_blk & ~suppressed & active_img[:, None]

        m = alive
        while True:
            m_new = alive & ~(over_tri & m[:, :, None]).any(dim=1)
            if torch.equal(m_new, m):
                break
            m = m_new

        # append each image's kept boxes to its buffer, in order
        pos = kept_count[:, None] + torch.cumsum(m, dim=1) - 1
        bi, ji = torch.nonzero(m & (pos < kmax), as_tuple=True)
        buf[bi, pos[bi, ji]] = blk[bi, ji]
        if levels is not None:
            buf_lev[bi, pos[bi, ji]] = lev[bi, ji]
        keep[:, start : start + block] = m
        kept_count = kept_count + m.sum(dim=1)
    return keep


def batched_non_max_suppression(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_output_size: int,
    iou_threshold: float = 0.7,
    score_threshold: float = float("-inf"),
    block: int = 128,
    presorted: bool = False,
    use_kernel: bool | None = None,
    levels: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy NMS with ``tf.image.non_max_suppression`` semantics.

    Args:
      boxes: (B, N, 4) [y1, x1, y2, x2].
      scores: (B, N).
      max_output_size: output size k.
      iou_threshold: boxes with IoU > threshold vs a kept higher-scoring box
        are suppressed.
      score_threshold: boxes scoring <= this are dropped up front.
      block: tile size of the blockwise greedy pass.
      presorted: boxes/scores are already in descending score order.
      use_kernel: None (default) computes the keep mask with the CUDA kernel
        (``kernels.nms.nms_keep``) on CUDA tensors and in plain PyTorch on
        CPU tensors; False always takes the plain path. Both select the same
        boxes.
      levels: (B, N) level ids, in the boxes' order: a box suppresses only
        boxes of its own level (the plain path only).

    Returns:
      (indices (B, k) int32 in descending score order, -1 past num_valid;
      num_valid (B,) int32).
    """
    B, n = scores.shape
    n_pad = _round_up(max(n, block), block)

    if presorted:
        order = None
        boxes_sorted, scores_sorted, levels_sorted = boxes, scores, levels
    else:
        # stable sort by descending score: ties go to the lower index, as in
        # jnp.argsort(-scores) and TF's sort
        order = torch.sort(-scores, dim=-1, stable=True).indices
        boxes_sorted = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        scores_sorted = torch.gather(scores, 1, order)
        levels_sorted = None if levels is None else torch.gather(levels, 1, order)
    if n_pad > n:
        boxes_sorted = torch.nn.functional.pad(boxes_sorted, (0, 0, 0, n_pad - n))
        scores_sorted = torch.nn.functional.pad(
            scores_sorted, (0, n_pad - n), value=float("-inf")
        )
        if levels_sorted is not None:
            levels_sorted = torch.nn.functional.pad(levels_sorted, (0, n_pad - n))
    valid = scores_sorted > score_threshold

    if use_kernel is None:
        use_kernel = boxes.device.type != "cpu"
    if use_kernel and levels is not None:
        raise ValueError("the NMS kernel takes no levels: use_kernel=False, or "
                         "kernels.proposal.fused_proposals(..., levels=)")
    if use_kernel:
        from .kernels.nms import nms_keep

        keep, _ = nms_keep(
            boxes_sorted, valid, float(iou_threshold), max_output_size, block
        )
    else:
        keep = _nms_keep_sorted_batched(
            boxes_sorted, valid, float(iou_threshold), block, max_output_size,
            levels_sorted,
        )

    # first `max_output_size` kept boxes per image, in score order: the
    # smallest keys of (kept first, then by position); all keys are distinct
    positions = torch.arange(n_pad, device=boxes.device).expand(B, n_pad)
    sort_key = torch.where(keep, positions, n_pad + positions)
    k_eff = min(max_output_size, n_pad)
    first_kept = torch.sort(sort_key, dim=1).values[:, :k_eff]
    first_kept = torch.where(first_kept >= n_pad, first_kept - n_pad, first_kept)
    is_valid_out = torch.gather(keep, 1, first_kept)
    if k_eff < max_output_size:
        pad = max_output_size - k_eff
        first_kept = torch.nn.functional.pad(first_kept, (0, pad), value=n_pad - 1)
        is_valid_out = torch.nn.functional.pad(is_valid_out, (0, pad), value=False)
    safe_kept = torch.clamp(first_kept, max=n - 1)
    unsorted_indices = (
        safe_kept if order is None else torch.gather(order, 1, safe_kept)
    )
    orig_indices = torch.where(is_valid_out, unsorted_indices, -1).to(torch.int32)
    num_valid = is_valid_out.sum(dim=-1).to(torch.int32)
    return orig_indices, num_valid


def non_max_suppression(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_output_size: int,
    iou_threshold: float = 0.7,
    score_threshold: float = float("-inf"),
    block: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-image greedy NMS: (N, 4), (N,) -> ((k,) indices, num_valid)."""
    idx, nv = batched_non_max_suppression(
        boxes[None],
        scores[None],
        max_output_size=max_output_size,
        iou_threshold=iou_threshold,
        score_threshold=score_threshold,
        block=block,
    )
    return idx[0], nv[0]
