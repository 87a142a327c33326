"""serve.prefix_ms: device ms a batch of the operations launched in the
port's ``rpn.prefix`` span (MobileNetV2 Conv1 or expanded_conv through
block_6, cuDNN convolutions and their elementwise passes), from the
program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.prefix",))
