"""Proposal generation: decode head outputs -> top-k -> NMS (port of
``tpurpn/predict.py``).

Rebuild of the reference's predictor hot loop (rpn_predictor.py, SURVEY.md
§3.2): reshape head outputs to (B, N, 4) / (B, N), scale deltas by the
variances, decode against the anchor grid, keep the pre_nms_topn
highest-scoring boxes, then greedy NMS down to test_nms_topn. Proposals come
back as fixed-size (B, topn, 4) plus a validity count per image.

``generate_proposals`` is the plain pipeline; ``make_predict_fn`` selects
through ``kernels.proposal.fused_proposals``, which launches the CUDA
kernel on the card (the counterpart of ``tpurpn``'s
``decode_outputs_packed`` + ``generate_proposals_packed``).

With a feature pyramid (``hp.multi_level``: ViTDet, MViTv2) serving follows
detectron2's test path: ``level_stem`` (resized as ``hp.canvas_of`` says,
normalised, zero-padded to the canvas: ViTDet's square, or MViTv2's next
multiple of 32), the anchors of that canvas (made once a canvas), the
model, decode by ``boxes.apply_deltas``, then ``select_levels``: the top
``pre_nms_topn`` objectness logits of each level, clipped to the resized
image, boxes of zero width or height dropped, NMS within a level, the first
``test_nms_topn`` kept by logit; ``roi_scores`` are their sigmoids.
"""

from __future__ import annotations

import functools
import operator
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import cache, inference
from .anchors import generate_anchors, generate_level_anchors, level_sizes
from .boxes import apply_deltas, get_bboxes_from_deltas
from .config import HyperParams, resized_shape  # noqa: F401  (resized_shape: the level path's)
from .kernels.proposal import fused_proposals, fused_proposals_plain, top_candidates
from .model import RPN, default_device
from .profiling import span


@functools.lru_cache(maxsize=None)
def _variances(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """``values`` as an f32 tensor on ``device``, made once, outside
    inference mode: a host-to-device copy in every call would wait for the
    card, and a CUDA graph cannot capture one."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32, device=device)


def decode_outputs(
    anchors: torch.Tensor,
    rpn_reg: torch.Tensor,
    rpn_cls_logits: torch.Tensor,
    hp: HyperParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head outputs -> (boxes (B, N, 4), scores (B, N)): deltas times the
    variances, decoded against the anchors; sigmoid objectness."""
    B = rpn_reg.shape[0]
    deltas = rpn_reg.reshape(B, -1, 4) * _variances(hp.variances, rpn_reg.device)
    scores = torch.sigmoid(rpn_cls_logits.reshape(B, -1))
    boxes = get_bboxes_from_deltas(anchors[None], deltas)
    return boxes, scores


def generate_proposals(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    hp: HyperParams,
    topn: int | None = None,
    nms_block: int = 128,
) -> Dict[str, torch.Tensor]:
    """Top-k + NMS proposal selection in plain PyTorch.

    Returns {roi_boxes (B, topn, 4), roi_scores (B, topn) (0 past
    num_valid), num_valid (B,) int32}.
    """
    if topn is None:
        topn = hp.test_nms_topn
    pre = min(hp.pre_nms_topn, boxes.shape[1])
    return fused_proposals_plain(
        boxes, scores, pre, hp.nms_iou_threshold, topn, block=nms_block
    )


def level_stem(frames: torch.Tensor, hp: HyperParams, mean: torch.Tensor, std: torch.Tensor
               ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, 3) RGB frames (uint8 or 0-255 floats) -> ((B, CH, CW, 3)
    canvas in the compute dtype, the resized (h, w)): a bilinear resize with
    half-pixel centres in f32 (antialiased when it shrinks), (x - mean) / std,
    zeros below and right of the image. The resized shape and the canvas
    are ``hp.canvas_of``'s. ``mean`` and ``std`` are (3,) f32 on the frames'
    device."""
    _, H, W, _ = frames.shape
    (nh, nw), (ch, cw) = hp.canvas_of(H, W)
    x = F.interpolate(frames.permute(0, 3, 1, 2).float(), size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=nh < H or nw < W)
    x = ((x.permute(0, 2, 3, 1) - mean) / std).to(getattr(torch, hp.compute_dtype))
    return F.pad(x, (0, 0, 0, cw - nw, 0, ch - nh)), (nh, nw)


def select_levels(boxes: torch.Tensor, logits: torch.Tensor, hp: HyperParams,
                  image_hw: Tuple[int, int], levels: torch.Tensor, topn: int,
                  canvas: Tuple[int, int] | None = None) -> Dict[str, torch.Tensor]:
    """detectron2's ``find_top_rpn_proposals`` at test time on every anchor's
    decoded box (B, N, 4) and logit (B, N): each level's ``pre_nms_topn``
    best logits (ties to the lower index), concatenated P2 first; clipped to
    the image; a box left without width or height, or not finite, drops out;
    NMS within a level (``levels``: the (K,) int32 level of each
    concatenated candidate); the first ``topn`` kept by logit, ties to the
    lower concatenated index. ``roi_scores`` are the kept logits' sigmoids,
    zero past ``num_valid``. ``canvas`` (H, W) is the anchors' (default:
    ``hp.canvas``). ``select_levels.candidates`` counts the candidates that
    enter NMS."""
    B = boxes.shape[0]
    canvas = canvas or hp.canvas
    idx, start = [], 0
    for n in level_sizes(hp, canvas):
        idx.append(top_candidates(logits[:, start:start + n], min(hp.pre_nms_topn, n)) + start)
        start += n
    idx = torch.cat(idx, 1)
    cand = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    score = torch.gather(logits, 1, idx)
    h, w = image_hw[0] / canvas[0], image_hw[1] / canvas[1]
    cand = torch.stack([cand[..., 0].clamp(0.0, h), cand[..., 1].clamp(0.0, w),
                        cand[..., 2].clamp(0.0, h), cand[..., 3].clamp(0.0, w)], -1)
    ok = ((cand[..., 2] > cand[..., 0]) & (cand[..., 3] > cand[..., 1])
          & torch.isfinite(cand).all(-1) & torch.isfinite(score))
    score = torch.where(ok, score, float("-inf"))
    select_levels.candidates += B * idx.shape[1]
    out = fused_proposals(cand, score, idx.shape[1], hp.nms_iou_threshold, topn, levels=levels)
    valid = torch.arange(topn, device=boxes.device) < out["num_valid"][:, None]
    out["roi_scores"] = torch.where(valid, torch.sigmoid(out["roi_scores"]), 0.0)
    return out


select_levels.candidates = 0


class _ServeGraph:
    """The fast serving call on the card, captured in a CUDA graph once its
    input's shape repeats, then replayed.

    The key is the input's shape, dtype and device and ``cache.graph_key``
    of every parameter and buffer of the model (identity, storage, version;
    ``cache.clear``). They are held between calls, so that no id in the
    key is reused, with every module's ``_modules``, ``_parameters`` and
    ``_buffers``: a call reads what those dicts hold and walks the model
    again where that differs (an assignment, a new submodule,
    ``Module._apply``'s writes into them). Reading the dicts costs a third
    of a walk. The first call with a key runs eager: it makes the derived
    weights, loads the kernels and lets cuDNN choose, as
    ``train._StepGraph``'s eager step does. The second consecutive call
    with it uploads into a static input, captures and replays; later ones
    upload and replay. A new key drops the graph and runs eager, so a
    caller whose shapes vary never captures what it cannot reuse; a model
    with inference tensors (no version, their derived weights made at each
    call) runs eager at every call. A failing capture raises. Results are
    clones of the graph's outputs, so they outlive the next call.

    ``counts`` (the predict fn) counts ``eager_calls``, ``captures`` and
    ``replays``. The kernel wrappers' ``launches`` count launches on the
    host, as under ``_StepGraph``: the capture's, and none at a replay."""

    def __init__(self, model: RPN, device: torch.device, body, counts):
        self.model, self.device, self.body, self.counts = model, device, body, counts
        self.key = self.graph = self.held = None
        self.dicts = []

    def _tensors(self):
        held = [v for d in self.dicts for v in d.values()]
        if (self.held is None or len(held) != len(self.held)
                or not all(map(operator.is_, held, self.held))):
            modules = list(self.model.modules())
            self.dicts = [d for m in modules for d in (m._modules, m._parameters, m._buffers)]
            self.held = [v for d in self.dicts for v in d.values()]
            self.tensors = [t for m in modules
                            for t in (*m._parameters.values(), *m._buffers.values())
                            if t is not None]
        return self.tensors

    def _key(self, images: torch.Tensor):
        weights = cache.graph_key(self._tensors())
        return None if weights is None else (images.shape, images.dtype, images.device, weights)

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        key = self._key(images)
        if key is None or key != self.key:
            self.key = self.graph = self.static = self.out = None
            self.counts.eager_calls += 1
            with span("rpn.upload"):
                images = images.to(self.device)
            out = self.body(images)
            self.key = key
            return out
        if self.graph is None:
            self._capture(images)
        else:
            with span("rpn.upload"):
                self.static.copy_(images)
            self.counts.replays += 1
        with span("rpn.replay"):
            self.graph.replay()
            return {k: v.clone() for k, v in self.out.items()}

    def _capture(self, images: torch.Tensor) -> None:
        with torch.inference_mode(False), torch.no_grad():
            self.static = torch.empty(images.shape, dtype=images.dtype, device=self.device)
            with span("rpn.upload"):
                self.static.copy_(images)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.out = self.body(self.static)
        self.graph = graph
        self.counts.captures += 1


def make_predict_fn(
    model: RPN,
    hp: HyperParams,
    topn: int | None = None,
    fast: bool = False,
    from_uint8: bool = False,
    device=None,
    mesh=None,
) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """Build the inference step: NHWC images -> proposals, on ``device``
    (default: cuda; ``model`` must live there).

    The forward, decode, top-k and NMS all stay on the device; selection goes
    through ``kernels.proposal.fused_proposals`` (the CUDA kernel on the
    card, its plain version on the CPU).

    ``fast=True`` (folded-BN mobilenet_v2 only) swaps the backbone
    mid-stage for the fused inverted-residual kernel (``tpurpn_torch.
    inference``); outputs agree with the plain forward at bf16 tolerance.
    On the card, without a mesh, such a call is replayed as one CUDA graph
    from the second call on with the same input shape and weights
    (``_ServeGraph``): the same kernels on the same inputs, the same bits.
    ``predict_fn.eager_calls``, ``.captures`` and ``.replays`` count the
    calls of each kind; every other predict fn runs eager.

    ``from_uint8=True`` takes raw uint8 frames: uint8 -> [0,1] in the compute
    dtype and a bilinear resize to ``hp.img_size`` (``data.preprocess_batch``)
    run before the forward. With ``fast=True``, frames that
    ``inference.s2d_stem_supported`` accepts (even ``img_size``, frames no
    larger) go through ``inference.fast_uint8_forward`` instead: the resize
    emits the 2x2 space-to-depth layout and Conv1 runs folded into a 2x2
    conv, as in ``tpurpn``.

    With ``mesh`` (``train.make_data_mesh``) every rank passes its rows of the
    batch (``train.shard_batch``), serves them, and gets the whole batch's
    proposals, gathered from every rank in rank order. ``fast=True`` with a
    mesh raises, as in ``tpurpn``.

    A pyramid model (``hp.multi_level``) takes RGB frames of any size (uint8,
    or 0-255 floats without ``from_uint8``) through ``level_stem`` and
    selects with ``select_levels``; ``fast=True`` raises.
    """
    if fast and mesh is not None:
        raise ValueError("fast=True is the single-device serving path: use fast=False with "
                         "a mesh, or one single-device predict fn per device")
    device = default_device(device)
    out_topn = hp.test_nms_topn if topn is None else topn
    dtype = getattr(torch, hp.compute_dtype)
    if fast:
        inference._check_folded(model, "fast=True")
    if hp.multi_level:
        mean = torch.tensor(hp.pixel_mean, dtype=torch.float32, device=device)
        std = torch.tensor(hp.pixel_std, dtype=torch.float32, device=device)
        grids: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

        def level_grid(canvas: Tuple[int, int]):
            """(the anchors, each candidate's level) on ``canvas``, made once
            a canvas."""
            if canvas not in grids:
                grids[canvas] = (generate_level_anchors(hp, device, canvas), torch.cat(
                    [torch.full((min(hp.pre_nms_topn, n),), lv, dtype=torch.int32)
                     for lv, n in enumerate(level_sizes(hp, canvas))]).to(device))
            return grids[canvas]
    else:
        anchors = generate_anchors(hp, device)
        pre = min(hp.pre_nms_topn, hp.total_anchors)

    def forward(images: torch.Tensor):
        if from_uint8:
            # a hard error: a float frame would be silently renormalized by
            # /255 into a near-black image
            if images.dtype != torch.uint8:
                raise TypeError(
                    f"from_uint8=True expects raw uint8 frames; got {images.dtype}"
                )
            if fast and inference.s2d_stem_supported(hp, images.shape):
                return inference.fast_uint8_forward(model, images)
            from .data import preprocess_batch

            with span("rpn.stem"):
                images, _ = preprocess_batch(
                    images, torch.zeros((images.shape[0], 1, 4), device=device),
                    hp.img_size, dtype=dtype,
                )
        if fast:
            return inference.fast_mobilenet_forward(model, images)
        return model(images)

    def level_proposals(images: torch.Tensor):
        if from_uint8 and images.dtype != torch.uint8:
            raise TypeError(f"from_uint8=True expects raw uint8 frames; got {images.dtype}")
        with span("rpn.stem"):
            image, hw = level_stem(images, hp, mean, std)
        canvas = tuple(image.shape[1:3])
        level_anchors, levels = level_grid(canvas)
        rpn_reg, logits = model(image)
        with span("rpn.decode"):
            boxes = apply_deltas(level_anchors[None], rpn_reg, hp.box_weights, hp.scale_clamp)
        with span("rpn.select"):
            # where the canvas is hp's own, the six-argument call that a
            # stand-in for select_levels (the benchmark's planted faults) takes
            return select_levels(boxes, logits, hp, hw, levels, out_topn,
                                 *(() if hp.canvas else (canvas,)))

    def proposals(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        if hp.multi_level:
            return level_proposals(images)
        rpn_reg, rpn_cls = forward(images)
        with span("rpn.decode"):
            boxes, scores = decode_outputs(anchors, rpn_reg, rpn_cls, hp)
        with span("rpn.select"):
            return fused_proposals(boxes, scores, pre, hp.nms_iou_threshold, out_topn)

    @torch.no_grad()
    def predict_fn(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with span("rpn.predict"):
            if graph is not None:
                return graph(images)
            predict_fn.eager_calls += 1
            with span("rpn.upload"):
                images = images.to(device)
            out = proposals(images)
            if mesh is None:
                return out
            group = mesh.get_group()
            gathered = {}
            for k, v in out.items():
                parts = [torch.empty_like(v) for _ in range(mesh.size())]
                dist.all_gather(parts, v.contiguous(), group=group)
                gathered[k] = torch.cat(parts)
            return gathered

    predict_fn.eager_calls = predict_fn.captures = predict_fn.replays = 0
    graph = (_ServeGraph(model, device, proposals, predict_fn)
             if fast and mesh is None and device.type == "cuda" else None)
    return predict_fn
