"""MobileNetV2 feature backbone to block_13_expand_relu (port of
``tpurpn/backbones/mobilenet_v2.py``).

Equivalent of the reference's ``keras.applications.MobileNetV2(include_top=
False)`` tapped at the stride-16 ``block_13_expand_relu`` activation
(reference: models/rpn_mobilenet_v2.py, SURVEY.md §2 row 4): spatial 32x32 at
500x500 input, 576 channels. Module names are the Keras layer names, so a
state-dict key reads ``block_7.block_7_expand.weight`` where the flax tree
reads ``backbone/block_7/block_7_expand/kernel``.

Layout: the public input and output are NHWC, as in ``tpurpn``. Inside, the
tensors are NCHW views with channels-last strides (``permute`` of an NHWC
tensor), the layout cuDNN runs these convs in.

Numerics: bf16 compute with f32 parameters (each conv reads their bf16 copy,
``cache.compute_copy``: a cast at each use while autograd records, else one
copy per parameter version), BatchNorm in f32 with eps 1e-3 and Keras/flax
momentum 0.99 (torch ``momentum=0.01``), output cast back to bf16 — flax's
BatchNorm arithmetic.

TF "SAME" at stride 2 pads asymmetrically: (0, 1) at even input sizes (500,
250) and (1, 1) at odd ones (125, 63). ``nn.Conv2d(padding=1)`` would pad
(1, 1) everywhere, so stride-2 convs pad explicitly with ``same_pad``.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..cache import compute_copy

# (num_blocks, expansion, channels, first_stride) per stage, Keras numbering
_STAGES = (
    (1, 1, 16, 1),  # expanded_conv
    (2, 6, 24, 2),  # block_1, block_2
    (3, 6, 32, 2),  # block_3..5
    (4, 6, 64, 2),  # block_6..9
    (3, 6, 96, 1),  # block_10..12
)


def relu6(x: torch.Tensor) -> torch.Tensor:
    if x.requires_grad:
        # jnp.minimum(jnp.maximum(x, 0), 6): a tie at 0 or 6 splits the
        # gradient in half, where clamp's passes all of it
        return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))
    # one op, where the pair costs serving 27 %: chip_smoke.py on an H100 at
    # batch 128 timed the folded prefix at 24.4 ms with clamp and 35.5 ms
    # with minimum(maximum())
    return torch.clamp(x, 0.0, 6.0)


def same_pad(size: int, k: int, s: int):
    """TF SAME padding of one spatial dim: (before, after), extra pixel after."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """Conv2d with TF SAME padding and the flax dtype policy: the f32
    weight and bias enter as their copies in the input's compute dtype
    (``cache.compute_copy``)."""

    def __init__(self, in_ch, out_ch, k, stride=1, groups=1, bias=False):
        super().__init__(in_ch, out_ch, k, stride=stride, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        if k == 1:
            pad = 0
        elif s == 1:
            pad = (k - 1) // 2  # stride-1 SAME with odd k is symmetric
        else:
            (t, b), (l, r) = (same_pad(x.shape[2], k, s), same_pad(x.shape[3], k, s))
            x = F.pad(x, (l, r, t, b)).contiguous(memory_format=torch.channels_last)
            pad = 0
        bias = None if self.bias is None else compute_copy(self.bias, x.dtype)
        return F.conv2d(
            x, compute_copy(self.weight, x.dtype), bias, self.stride, pad, 1, self.groups
        )


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the batch of every rank of ``group``: flax's
    statistics under a data-parallel mesh. The forward all-reduces each
    channel's count, sum and sum of squares (taken from one local
    ``var_mean``) and normalizes in one pass with the global mean and biased
    variance, flax's max(0, E[x^2] - E[x]^2). The backward all-reduces the
    local sums of dy and dy * xhat (one reduction) and forms
    dx = w * invstd * (dy - mean(dy) - xhat * mean(dy * xhat)) with the
    global means; the weight and bias gradients stay local sums, which the
    step's gradient all-reduce adds up."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        dims = (0, 2, 3)
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        n = x.numel() // x.shape[1]
        sums = torch.stack([torch.full_like(mean, n), mean * n, (var + mean * mean) * n])
        dist.all_reduce(sums, group=group)
        count = sums[0]
        mean = sums[1] / count
        var = torch.clamp(sums[2] / count - mean * mean, min=0.0)
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.eps, ctx.group = eps, group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, count = ctx.saved_tensors
        # local sums of dy * xhat and dy, in one fused reduction
        _, sum_dy_xhat, sum_dy = torch.ops.aten.native_batch_norm_backward(
            dy, x, weight, None, None, mean, invstd, True, ctx.eps, [False, True, True])
        sums = torch.stack([sum_dy_xhat, sum_dy])
        dist.all_reduce(sums, group=ctx.group)
        scale = weight * invstd
        c = -scale * invstd * sums[0] / count  # per channel: dx = scale dy + c x + d
        d = -scale * sums[1] / count - c * mean
        dx = torch.addcmul(torch.addcmul(d[:, None, None], x, c[:, None, None]),
                           dy, scale[:, None, None])
        return dx, sum_dy_xhat, sum_dy, None, None


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with Keras eps/momentum, computed in f32 and cast back to
    the input dtype (flax's ``_normalize`` promotes to the f32 statistics).

    Eval mode normalizes with the running statistics. Train mode is flax's
    ``BatchNorm(use_running_average=False)``: the batch mean and the *biased*
    batch variance, in f32, normalize x (one fused op forward and one
    backward), and the running statistics move to m * old + (1 - m) * batch
    with m = ``bn_momentum``. torch's own train mode would store the
    unbiased variance, so the statistics are updated here.

    With ``group`` set (``global_batch_statistics``) to a process group of
    more than one rank, the batch is every rank's: the statistics, and so
    the gradient, are the global batch's (``_GlobalBatchNorm``), as
    ``tpurpn``'s BatchNorm computes them under a mesh. A group of one rank
    holds the whole batch and takes the local path.
    """

    def __init__(self, ch, bn_momentum: float = 0.99):
        super().__init__(ch, eps=1e-3, momentum=1.0 - bn_momentum)
        self.bn_momentum = bn_momentum
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x.float()).to(x.dtype)
        xf = x.float()
        if self.group is not None and dist.get_world_size(self.group) > 1:
            y, mean, var = _GlobalBatchNorm.apply(xf, self.weight, self.bias, self.eps,
                                                  self.group)
            mean, var = mean.detach(), var.detach()
        else:
            y = F.batch_norm(xf, None, None, self.weight, self.bias, training=True,
                             eps=self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            m = self.bn_momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return y.to(x.dtype)


@contextlib.contextmanager
def global_batch_statistics(model: nn.Module, group):
    """Within the block, every ``BatchNorm`` of ``model`` takes train-mode
    statistics over the batches of all ranks of ``group``."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m in bns:
            m.group = None


class _InvertedResidual(nn.Module):
    """One MobileNetV2 bottleneck: [1x1 expand] -> 3x3 dw -> 1x1 project.

    With ``fold_bn=True`` the BatchNorms are folded into conv biases
    (inference-only variant; see model.fold_batch_norm).
    """

    def __init__(self, in_ch, expansion, out_ch, stride, block_name,
                 fold_bn=False, bn_momentum=0.99):
        super().__init__()
        nm = self.block_name = block_name
        self.expansion, self.stride = expansion, stride
        self.residual = stride == 1 and in_ch == out_ch
        self.fold_bn = fold_bn
        mid = in_ch * expansion

        def bn(name, ch):
            if not fold_bn:
                self.add_module(name, BatchNorm(ch, bn_momentum))

        if expansion != 1:
            self.add_module(f"{nm}_expand", Conv(in_ch, mid, 1, bias=fold_bn))
            bn(f"{nm}_expand_BN", mid)
        self.add_module(
            f"{nm}_depthwise", Conv(mid, mid, 3, stride, groups=mid, bias=fold_bn)
        )
        bn(f"{nm}_depthwise_BN", mid)
        self.add_module(f"{nm}_project", Conv(mid, out_ch, 1, bias=fold_bn))
        bn(f"{nm}_project_BN", out_ch)

    def _conv_bn(self, h, name):
        h = self.get_submodule(name)(h)
        return h if self.fold_bn else self.get_submodule(f"{name}_BN")(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nm = self.block_name
        h = x
        if self.expansion != 1:
            h = relu6(self._conv_bn(h, f"{nm}_expand"))
        h = relu6(self._conv_bn(h, f"{nm}_depthwise"))
        h = self._conv_bn(h, f"{nm}_project")
        return h + x if self.residual else h


class MobileNetV2Backbone(nn.Module):
    """NHWC images -> block_13_expand_relu features (B, ceil(H/16), ceil(W/16), 576).

    ``fold_bn=True`` builds the inference-only BN-folded variant (convs carry
    biases, no BatchNorm modules). ``stop_after_block`` returns that block's
    output instead (the prefix of the fused serving path; ``forward`` also
    takes it per call so one module serves both). ``skip_stem=True`` (per
    call) takes the Conv1 activations (B, ceil(H/2), ceil(W/2), 32) in place
    of images.
    """

    def __init__(self, dtype=torch.bfloat16, fold_bn=False, bn_momentum=0.99,
                 stop_after_block=None):
        super().__init__()
        self.dtype = dtype
        self.fold_bn = fold_bn
        self.stop_after_block = stop_after_block
        self.Conv1 = Conv(3, 32, 3, 2, bias=fold_bn)
        if not fold_bn:
            self.bn_Conv1 = BatchNorm(32, bn_momentum)
        in_ch, block_id = 32, 0
        for num_blocks, expansion, channels, first_stride in _STAGES:
            for i in range(num_blocks):
                name = "expanded_conv" if block_id == 0 else f"block_{block_id}"
                self.add_module(name, _InvertedResidual(
                    in_ch, expansion, channels, first_stride if i == 0 else 1,
                    name, fold_bn, bn_momentum,
                ))
                in_ch, block_id = channels, block_id + 1
        self.block_13_expand = Conv(96, 576, 1, bias=fold_bn)
        if not fold_bn:
            self.block_13_expand_BN = BatchNorm(576, bn_momentum)
        self.num_blocks = block_id

    def block_names(self):
        return ["expanded_conv"] + [f"block_{i}" for i in range(1, self.num_blocks)]

    def forward(self, x: torch.Tensor, stop_after_block: int | None = None,
                skip_stem: bool = False):
        if stop_after_block is None:
            stop_after_block = self.stop_after_block
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> channels-last NCHW
        if not skip_stem:
            x = self.Conv1(x)
            if not self.fold_bn:
                x = self.bn_Conv1(x)
            x = relu6(x)
        for block_id, name in enumerate(self.block_names()):
            x = self.get_submodule(name)(x)
            if stop_after_block is not None and block_id == stop_after_block:
                return x.permute(0, 2, 3, 1)
        x = self.block_13_expand(x)
        if not self.fold_bn:
            x = self.block_13_expand_BN(x)
        return relu6(x).permute(0, 2, 3, 1)
