"""vitdet.pyramid_ms: device ms a batch of the operations launched in the
port's ``rpn.pyramid`` span (the simple feature pyramid, P2-P6), from the
program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.pyramid",))
