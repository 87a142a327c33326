"""train.forward_ms: device ms a step of the operations launched in the
port's ``rpn.step.forward`` span (the model in train mode and the losses),
from the program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.step.forward",))
