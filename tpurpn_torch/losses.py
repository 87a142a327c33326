"""RPN losses: masked smooth-L1 (Huber) regression and masked BCE
objectness (port of ``tpurpn/losses.py``).

Rebuild of the reference's ``utils/train_utils.reg_loss`` / ``rpn_cls_loss``
(SURVEY.md §2 row 6), masking as the reference does:

* reg: Huber(delta=1) averaged over the 4 delta components of an anchor,
  summed over anchors whose target row is nonzero (the sampled positives),
  divided by max(1, #positives);
* cls: binary cross-entropy averaged over the entries with label != -1.

The cls loss takes logits; ``rpn_cls_loss_probs`` is the reference's
probability form. ``max(x, 0)`` and ``min(|e|, delta)`` are written with
``torch.maximum`` / ``torch.minimum`` so a tie splits the gradient in half,
as JAX's does (``clamp`` and ``relu`` give all of it to one side), and
``|x|`` has JAX's gradient of +1 at 0 (torch's ``abs`` has 0 there).
"""

from __future__ import annotations

import torch


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: +1 at x == 0."""
    return torch.where(x >= 0, x, -x)


def huber(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber: 0.5 e^2 for |e| <= delta else delta (|e| - 0.5 delta)."""
    abs_e = _abs(error)
    # a fill, not a host copy: the step runs inside a CUDA graph capture
    quad = torch.minimum(abs_e, torch.full((), delta, dtype=abs_e.dtype, device=abs_e.device))
    return 0.5 * quad * quad + delta * (abs_e - quad)


def reg_pos_count(y_true: torch.Tensor) -> torch.Tensor:
    """Number of positive anchors (nonzero target rows), reg_loss's
    denominator; gradient accumulation normalizes by the global count."""
    t = y_true.reshape(y_true.shape[0], -1, 4)
    return (t != 0.0).any(dim=-1).float().sum()


def reg_loss(y_true: torch.Tensor, y_pred: torch.Tensor, normalizer=None) -> torch.Tensor:
    """Masked smooth-L1 box-regression loss over (B, fm, fm, A*4) targets
    (zero outside the positives) and predictions. ``normalizer`` overrides
    the default max(1, #positives)."""
    B = y_true.shape[0]
    t = y_true.reshape(B, -1, 4)
    p = y_pred.reshape(B, -1, 4)
    per_anchor = huber(t - p).mean(dim=-1)  # Keras Huber: mean over the last axis
    pos = (t != 0.0).any(dim=-1).float()
    total = (per_anchor * pos).sum()
    if normalizer is None:
        normalizer = torch.clamp(pos.sum(), min=1.0)
    return total / normalizer


def cls_valid_count(y_true: torch.Tensor) -> torch.Tensor:
    """Number of counted (label != -1) anchors, rpn_cls_loss's denominator."""
    return (y_true != -1.0).float().sum()


def rpn_cls_loss(y_true: torch.Tensor, logits: torch.Tensor, normalizer=None) -> torch.Tensor:
    """Masked binary cross-entropy from logits over (B, fm, fm, A) labels in
    {1, 0, -1}; -1 entries are ignored. ``normalizer`` overrides the default
    max(1, #counted)."""
    valid = (y_true != -1.0).float()
    target = torch.clamp(y_true, 0.0, 1.0)
    x = logits
    # stable sigmoid BCE: max(x, 0) - x z + log(1 + exp(-|x|))
    bce = torch.maximum(x, torch.zeros_like(x)) - x * target + torch.log1p(torch.exp(-_abs(x)))
    if normalizer is None:
        normalizer = torch.clamp(valid.sum(), min=1.0)
    return (bce * valid).sum() / normalizer


def rpn_cls_loss_probs(y_true: torch.Tensor, probs: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """The reference's cls loss from sigmoid probabilities: Keras
    BinaryCrossentropy (probabilities clipped at eps) over label != -1."""
    valid = (y_true != -1.0).float()
    target = torch.clamp(y_true, 0.0, 1.0)
    p = torch.clamp(probs, eps, 1.0 - eps)
    bce = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
    return (bce * valid).sum() / torch.clamp(valid.sum(), min=1.0)
