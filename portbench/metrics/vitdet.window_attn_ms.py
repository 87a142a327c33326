"""vitdet.window_attn_ms: device ms a batch of the operations launched in
the port's ``rpn.attn.window`` spans (the window blocks' attention cores on
the partitioned windows, relative positions included; partitioning, qkv and
proj outside), from the program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.attn.window",))
