"""mvit.fpn_ms: device ms a batch of the operations launched in the port's
``rpn.pyramid`` span (the top-down FPN: laterals, upsampling, sums, output
convs and P6), from the program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.pyramid",))
