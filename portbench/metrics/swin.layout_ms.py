"""swin.layout_ms: device ms a batch of the operations launched in the
port's ``rpn.attn.layout`` spans (each block's pad, roll and window cut
before its core, and its merge back, roll back and crop after), from the
program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.attn.layout",))
