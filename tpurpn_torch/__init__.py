"""tpurpn_torch — the Region Proposal Network of ``tpurpn`` in PyTorch and CUDA.

A port of the JAX package ``tpurpn`` (which stays the reference) to PyTorch
on an NVIDIA H100. It mirrors ``tpurpn``'s module and function names and its
public layouts — NHWC images, (B, fm, fm, 4A) / (B, fm, fm, A) head outputs,
[y1, x1, y2, x2] boxes — and runs on ``cuda`` unless the caller passes
``device="cpu"``. Each TPU kernel of ``tpurpn`` on the ported path is a
hand-written CUDA kernel here (``tpurpn_torch.kernels``) with a plain
PyTorch version beside it; the CPU runs the plain versions.

Ported so far: the MobileNetV2 serving path (config, anchors, boxes,
backbone, model, weight conversion, fused IR stage, fused proposal
selection, preprocess, ``make_predict_fn``); the single-GPU training step
for both backbones (VGG16, target assignment with the fused target kernel,
losses, ``SyntheticVOC``, ``make_train_step`` with exact gradient
accumulation, ``make_eval_loss_fn``); and the standalone NMS kernel behind
``batched_non_max_suppression``; proposal recall (``eval``), Keras ``.h5``
weights and checkpoints (``io_utils``), the datasets and the native batch
generator (``data``, ``native``), drawing, profiling, and the single-device
trainer and predictor CLIs (``cli``; ``rpn_trainer_torch.py``,
``rpn_predictor_torch.py``); data-parallel training, evaluation and serving
over a ``torch.distributed`` mesh (``train.make_data_mesh``), the
device-resident chained steps (``make_scan_train_steps``, a CUDA graph of
the step on the card) and the space-to-depth uint8 serving stem
(``inference.fast_uint8_forward``). Beyond ``tpurpn``: the serving prefix's
kernels (``kernels.prefix``) and ViTDet-B's RPN (``get_hyper_params(
"vitdet_b")``: a plain ViT, a simple feature pyramid, five anchor levels and
NMS within a level), MViTv2-B's (``get_hyper_params("mvitv2_b")``: pooling
attention, hybrid window and global blocks, a top-down FPN, on a canvas that
follows the frames) and Swin-B's (``get_hyper_params("swin_b")``:
shifted-window attention with a learned relative-position bias, patch
merging, the same FPN and canvas), which the port serves and does not
train.
"""

from .config import HyperParams, feature_map_shape_for, get_hyper_params
from .anchors import generate_anchors, generate_base_anchors
from .boxes import (
    batched_non_max_suppression,
    clip_bboxes,
    denormalize_bboxes,
    generate_iou_map,
    get_bboxes_from_deltas,
    get_deltas_from_bboxes,
    non_max_suppression,
    normalize_bboxes,
)
from .eval import proposal_recall
from .model import fold_batch_norm, get_model, init_model
from .predict import make_predict_fn
from .target import calculate_rpn_actual_outputs, target_rand_bits
from .train import (
    TrainState,
    create_train_state,
    default_optimizer,
    make_eval_loss_fn,
    make_scan_train_steps,
    make_train_step,
    get_step_size,
    rpn_generator,
)

__version__ = "0.7.0"

__all__ = [
    "HyperParams",
    "get_hyper_params",
    "feature_map_shape_for",
    "generate_anchors",
    "generate_base_anchors",
    "get_deltas_from_bboxes",
    "get_bboxes_from_deltas",
    "generate_iou_map",
    "non_max_suppression",
    "batched_non_max_suppression",
    "normalize_bboxes",
    "denormalize_bboxes",
    "clip_bboxes",
    "get_model",
    "init_model",
    "fold_batch_norm",
    "make_predict_fn",
    "calculate_rpn_actual_outputs",
    "target_rand_bits",
    "TrainState",
    "create_train_state",
    "default_optimizer",
    "make_train_step",
    "make_scan_train_steps",
    "make_eval_loss_fn",
    "rpn_generator",
    "get_step_size",
    "proposal_recall",
    "__version__",
]
