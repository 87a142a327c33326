"""mvit.backbone_ms: device ms a batch of the operations launched in the
port's ``rpn.backbone`` span (MViTv2: patch embedding, 24 blocks, the
stages' norms), the pooling and attention cores' spans inside it included,
from the program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.backbone", "rpn.attn.pool", "rpn.attn.window", "rpn.attn.global"))
