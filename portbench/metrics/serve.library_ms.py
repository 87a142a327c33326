"""serve.library_ms: device milliseconds a batch of every operation that is
not one of the port's hand-written kernels, copies and fills excluded:
cuDNN, cuBLAS, elementwise and sort kernels of the prefix, the s2d stem,
the head and the decode."""

from portbench.harness import PORT_KERNELS, op_ms_per_iter


def _library(name):
    return not any(k in name for k in PORT_KERNELS) and not name.startswith(("Memcpy", "Memset"))


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["ops"]:
        return None
    return op_ms_per_iter(tr, _library) or None
