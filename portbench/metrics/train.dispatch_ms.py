"""train.dispatch_ms: host ms a step in the port's ``rpn.step`` span (the
draws and the update), from the program stretch."""

from portbench.program import host_ms


def read(rec):
    return host_ms(rec, "rpn.step")
