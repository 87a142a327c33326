"""serve.upload_host_ms: host ms a batch in the port's ``rpn.upload`` span,
the pageable ``images.to(device)`` that holds the host thread, from the
program stretch."""

from portbench.program import host_ms


def read(rec):
    return host_ms(rec, "rpn.upload")
