"""vitdet.backbone_ms: device ms a batch of the operations launched in the
port's ``rpn.backbone`` span (the ViT: patch embedding, absolute positions
and its blocks), the attention cores' spans inside it included, from the
program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.backbone", "rpn.attn.window", "rpn.attn.global"))
