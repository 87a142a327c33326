"""vitdet.global_attn_ms: device ms a batch of the operations launched in
the port's ``rpn.attn.global`` spans (the global blocks' attention cores,
q, k and v to the per-head output, relative positions included), from the
program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.attn.global",))
