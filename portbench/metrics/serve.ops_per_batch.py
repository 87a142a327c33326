"""serve.ops_per_batch: device operations (kernels, copies, fills) a batch
launched inside the port's ``rpn.predict`` span, from the program
stretch."""

from portbench.program import ops_in


def read(rec):
    return ops_in(rec, "rpn.predict")
