"""serve.select_ms: device ms a batch of the operations launched in the
port's ``rpn.select`` span (the stable top-k sort and proposal_kernel),
from the program stretch."""

from portbench.program import device_ms


def read(rec):
    return device_ms(rec, ("rpn.select",))
