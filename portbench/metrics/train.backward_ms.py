"""train.backward_ms: device ms a step of the operations launched in the
port's ``rpn.step.backward`` span (``backward()``, whose kernels autograd's
thread launches), from the program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.step.backward",))
