"""train.update_ms: device ms a step of the operations launched in the
port's ``rpn.step.update`` span (SGD's ``opt.step()``), from the program
stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.step.update",))
