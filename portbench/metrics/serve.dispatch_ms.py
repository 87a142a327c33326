"""serve.dispatch_ms: host ms a batch in the port's ``rpn.predict`` span
less its ``rpn.upload`` span: the host's enqueue of the batch's work, from
the program stretch."""

from portbench.program import host_ms


def read(rec):
    return host_ms(rec, "rpn.predict", less=("rpn.upload",))
