"""VGG16 feature backbone to block5_conv3, stride 16 (port of
``tpurpn/backbones/vgg16.py``).

Equivalent of the reference's ``keras.applications.VGG16(include_top=False)``
tapped at ``block5_conv3`` (reference: models/rpn_vgg16.py, SURVEY.md §3.3):
SAME 3x3 convs with bias and ReLU, and VALID 2x2 max-pools at the *start*
of blocks 2-5, so 500 -> 250 -> 125 -> 62 -> 31. Module names are the Keras
layer names (``block{i}_conv{j}``), as in the flax tree. Public input and
output are NHWC; inside, channels-last NCHW views. bf16 compute with f32
parameters, through the MobileNetV2 module's ``Conv``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .mobilenet_v2 import Conv

# (block, channels per conv): VGG16 through block5_conv3
_CFG = (
    (1, (64, 64)),
    (2, (128, 128)),
    (3, (256, 256, 256)),
    (4, (512, 512, 512)),
    (5, (512, 512, 512)),
)


class VGG16Backbone(nn.Module):
    """NHWC images -> block5_conv3 features (B, H//16, W//16, 512)."""

    out_channels = 512

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        in_ch = 3
        for block, channels in _CFG:
            for j, ch in enumerate(channels, start=1):
                self.add_module(f"block{block}_conv{j}", Conv(in_ch, ch, 3, bias=True))
                in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> channels-last NCHW
        for block, channels in _CFG:
            if block > 1:
                x = F.max_pool2d(x, 2, 2)  # VALID: floors odd sizes, 125 -> 62
            for j in range(1, len(channels) + 1):
                x = torch.relu(self.get_submodule(f"block{block}_conv{j}")(x))
        return x.permute(0, 2, 3, 1)
