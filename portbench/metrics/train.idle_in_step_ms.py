"""train.idle_in_step_ms: device idle ms a step whose gap began while the
host was inside the port's ``rpn.step`` span, from the program stretch."""

from portbench.program import idle_in


def read(rec):
    return idle_in(rec, "rpn.step")
