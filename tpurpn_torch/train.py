"""Training on one GPU: the RPN train step (port of ``tpurpn/train.py``).

Rebuild of the reference's training logic (rpn_trainer.py +
utils/train_utils, SURVEY.md §3.1). One step does, on the device:

  uint8 batch -> preprocess (resize, flip) -> target assignment (the CUDA
  kernel ``kernels.targets.fused_rpn_targets``) -> forward in train mode ->
  masked smooth-L1 + BCE losses -> backward -> SGD with momentum.

State lives in torch objects, updated in place: ``TrainState`` holds the
model (parameters and BatchNorm running statistics), the optimizer and the
step count. Randomness comes from an explicit ``torch.Generator``: per step
the flip mask, then the (B, 2, N) selection words. torch cannot reproduce
``tpurpn``'s ``fold_in(key, step)`` draws, so a step also takes ``flip`` and
``rand_bits`` explicitly; parity tests replay ``tpurpn``'s that way.

Not ported here: the mesh (data-parallel) and scanned variants.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import torch

from .anchors import generate_anchors
from .config import HyperParams
from .data import preprocess_batch
from .losses import cls_valid_count, reg_loss, reg_pos_count, rpn_cls_loss
from .model import RPN, get_model, init_model
from .target import calculate_rpn_actual_outputs, target_rand_bits


@dataclasses.dataclass
class TrainState:
    """The model (parameters + BatchNorm statistics), its optimizer and the
    number of steps taken."""

    model: RPN
    optimizer: torch.optim.Optimizer
    step: int = 0


def default_optimizer(
    params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-3
) -> torch.optim.Optimizer:
    """SGD with momentum 0.9, no dampening: ``optax.sgd(lr, momentum=0.9)``
    (trace = g + 0.9 trace; p -= lr trace)."""
    return torch.optim.SGD(params, lr=learning_rate, momentum=0.9)


def create_train_state(
    hp: HyperParams,
    generator: Optional[torch.Generator] = None,
    optimizer: Optional[Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]] = None,
    model: Optional[RPN] = None,
    device=None,
) -> TrainState:
    """A fresh state: ``model`` (default: ``get_model(hp)`` initialized from
    ``generator`` on ``device``, default cuda) and ``optimizer(params)``
    (default: ``default_optimizer``)."""
    if model is None:
        model = init_model(get_model(hp), generator, device)
    make_opt = optimizer or default_optimizer
    return TrainState(model=model, optimizer=make_opt(model.parameters()))


def _model_device(model: RPN) -> torch.device:
    return next(model.parameters()).device


class _Anchors:
    """The anchor grid of ``hp`` on each device it is asked for."""

    def __init__(self, hp: HyperParams):
        self.hp = hp
        self._by_device: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self._by_device:
            self._by_device[device] = generate_anchors(self.hp, device)
        return self._by_device[device]


def _draw_flip(generator: Optional[torch.Generator], batch: int) -> torch.Tensor:
    if generator is None:
        raise ValueError("augment=True needs a generator or an explicit flip mask")
    return torch.rand((batch,), generator=generator, device=generator.device) < 0.5


def _targets(hp, anchors, images_u8, gt_boxes, gt_labels, generator, flip, rand_bits,
             augment, use_kernel):
    """Preprocess and target assignment: parameter-free, shared by the step
    variants and the eval loss."""
    B = images_u8.shape[0]
    if augment and flip is None:
        flip = _draw_flip(generator, B)
    images, boxes = preprocess_batch(
        images_u8, gt_boxes, hp.img_size, augment=augment, flip=flip
    )
    if rand_bits is None:
        if generator is None:
            raise ValueError("pass rand_bits or a generator to draw them from")
        rand_bits = target_rand_bits(generator, B, anchors.shape[0], anchors.device)
    deltas, labels = calculate_rpn_actual_outputs(
        anchors, boxes, gt_labels, hp, rand_bits=rand_bits.to(anchors.device),
        use_kernel=use_kernel,
    )
    return images, deltas, labels


def make_train_step(
    hp: HyperParams,
    augment: bool = True,
    grad_accum: int = 1,
    use_kernel: bool | None = None,
):
    """Build the train step.

    step(state, images_u8 (B,H,W,3), gt_boxes (B,M,4), gt_labels (B,M),
         generator=None, *, flip=None, rand_bits=None) -> (state, metrics)

    The inputs move to the model's device. ``generator`` draws what is not
    given: the (B,) flip mask (with ``augment``), then the (B, 2, N) int32
    selection words. ``use_kernel`` is ``calculate_rpn_actual_outputs``'
    (None: the CUDA target kernel on the card). The state is updated in place
    and returned; metrics (``loss``, ``reg_loss``, ``cls_loss``, ``num_pos``)
    are 0-dim tensors on the device, read without a host sync.

    ``grad_accum=n > 1`` splits the batch into n microbatches for the
    forward and backward, bounding activation memory at batch/n. The
    accumulation is exact: targets are computed once on the full batch, each
    microbatch loss is normalized by the global counts, and the gradients
    are summed, so the update equals the full-batch one up to float
    reduction order. BatchNorm sees microbatches, as in ``tpurpn``.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    anchors = _Anchors(hp)

    def step(state: TrainState, images_u8, gt_boxes, gt_labels, generator=None, *,
             flip=None, rand_bits=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model, opt = state.model, state.optimizer
        dev = _model_device(model)
        B = images_u8.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} not divisible by grad_accum {grad_accum}")
        images, deltas, labels = _targets(
            hp, anchors.on(dev), images_u8.to(dev), gt_boxes.to(dev), gt_labels.to(dev),
            generator, flip, rand_bits, augment, use_kernel,
        )
        was_training = model.training
        model.train()
        opt.zero_grad(set_to_none=True)
        if grad_accum == 1:
            rpn_reg, rpn_cls = model(images)
            l_reg = reg_loss(deltas, rpn_reg)
            l_cls = rpn_cls_loss(labels, rpn_cls)
            loss = l_reg + l_cls
            loss.backward()
            l_reg, l_cls, loss = l_reg.detach(), l_cls.detach(), loss.detach()
        else:
            # the full-batch loss's denominators
            pos_norm = torch.clamp(reg_pos_count(deltas), min=1.0)
            valid_norm = torch.clamp(cls_valid_count(labels), min=1.0)
            mb = B // grad_accum
            l_reg = l_cls = loss = torch.zeros((), device=dev)
            for i in range(grad_accum):
                sl = slice(i * mb, (i + 1) * mb)
                rpn_reg, rpn_cls = model(images[sl])
                m_reg = reg_loss(deltas[sl], rpn_reg, normalizer=pos_norm)
                m_cls = rpn_cls_loss(labels[sl], rpn_cls, normalizer=valid_norm)
                (m_reg + m_cls).backward()  # .grad sums over the microbatches
                l_reg = l_reg + m_reg.detach()
                l_cls = l_cls + m_cls.detach()
                loss = loss + (m_reg + m_cls).detach()
        opt.step()
        model.train(was_training)
        state.step += 1
        metrics = {"loss": loss, "reg_loss": l_reg, "cls_loss": l_cls,
                   "num_pos": (labels == 1.0).sum()}
        return state, metrics

    return step


def make_eval_loss_fn(hp: HyperParams):
    """Validation loss without gradients: the quantity the reference's
    ModelCheckpoint(save_best_only=True) monitors.

    eval_loss(state, images_u8, gt_boxes, gt_labels, generator=None, *,
              rand_bits=None) -> 0-dim loss tensor

    No augmentation; BatchNorm uses its running statistics.
    """
    anchors = _Anchors(hp)

    @torch.no_grad()
    def eval_loss(state: TrainState, images_u8, gt_boxes, gt_labels, generator=None, *,
                  rand_bits=None) -> torch.Tensor:
        model = state.model
        dev = _model_device(model)
        images, deltas, labels = _targets(
            hp, anchors.on(dev), images_u8.to(dev), gt_boxes.to(dev), gt_labels.to(dev),
            generator, None, rand_bits, False, None,
        )
        was_training = model.training
        model.eval()
        rpn_reg, rpn_cls = model(images)
        model.train(was_training)
        return reg_loss(deltas, rpn_reg) + rpn_cls_loss(labels, rpn_cls)

    return eval_loss


def get_step_size(total_items: int, batch_size: int) -> int:
    """Mirror of the reference's ``train_utils.get_step_size`` (ceil division)."""
    return -(-total_items // batch_size)


def rpn_generator(dataset, anchors: torch.Tensor, hp: HyperParams,
                  generator: torch.Generator, *, batch_size: int = 8,
                  augment: bool = True) -> Iterator:
    """API-parity port of the reference's ``train_utils.rpn_generator``:
    an endless generator of ``(images, (bbox_deltas, bbox_labels))`` batches
    on ``anchors``' device, the structure the reference feeds to Keras
    ``model.fit``. ``make_train_step`` does this work inside the step."""
    dev = anchors.device
    for raw_imgs, gt_boxes, gt_labels in dataset.batches(batch_size, repeat=True):
        images, deltas, labels = _targets(
            hp, anchors, torch.from_numpy(raw_imgs).to(dev),
            torch.from_numpy(gt_boxes).to(dev), torch.from_numpy(gt_labels).to(dev),
            generator, None, None, augment, None,
        )
        yield images, (deltas, labels)

