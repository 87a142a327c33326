"""swin.attn_ms: device ms a batch of the operations launched in the port's
``rpn.attn.window`` and ``rpn.attn.shifted`` spans (the 24 window attention
cores: the bias and, in a shifted block, the mask, the scores, softmax and
products; the pad, roll and window cut outside), from the program
stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.attn.window", "rpn.attn.shifted"))
