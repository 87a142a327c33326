"""mvit.pool_ms: device ms a batch of the operations launched in the port's
``rpn.attn.pool`` spans (each block's depthwise pooling convs of q, k and v
and their LayerNorms), from the program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.attn.pool",))
