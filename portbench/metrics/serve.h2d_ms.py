"""serve.h2d_ms: device milliseconds a batch of host-to-device copies (the
predict function's upload of the uint8 frames), in the traced stretch."""

from portbench.harness import op_ms_per_iter


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["ops"]:
        return None
    ms = op_ms_per_iter(tr, lambda n: "HtoD" in n)
    return ms or None
