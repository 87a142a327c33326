"""serve.stem_ms: device ms a batch of the operations launched in the
port's ``rpn.stem`` span (the s2d stem: uint8 to [0,1], the resize's two
matmuls, the folded Conv1), from the program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.stem",))
