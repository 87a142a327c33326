"""serve.idle_in_predict_ms: device idle ms a batch whose gap began while
the host was inside the port's ``rpn.predict`` span, from the program
stretch."""

from portbench.program import idle_in


def read(rec):
    return idle_in(rec, "rpn.predict")
