"""swin.backbone_ms: device ms a batch of the operations launched in the
port's ``rpn.backbone`` span (Swin-B: patch embedding and its norm, 24
blocks, three patch mergings, the stages' norms), the cores' and the
layout's spans inside it included, from the program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.backbone", "rpn.attn.window", "rpn.attn.shifted",
                           "rpn.attn.layout"))
