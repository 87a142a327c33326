"""mvit.attn_ms: device ms a batch of the operations launched in the port's
``rpn.attn.window`` and ``rpn.attn.global`` spans (the 24 pooled attention
cores: tables, the relative-position bias's build, scores, softmax and
products; the window partition outside), from the program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.attn.window", "rpn.attn.global"))
