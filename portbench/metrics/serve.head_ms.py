"""serve.head_ms: device ms a batch of the operations launched in the
port's ``rpn.head`` (the RPN head's 3x3 and 1x1 convolutions) and
``rpn.decode`` (deltas against the anchors, sigmoid) spans, from the
program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.head", "rpn.decode"))
