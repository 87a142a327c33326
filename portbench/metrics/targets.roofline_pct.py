"""targets.roofline_pct: target assignment's bound (portbench.counts.
targets_bound) over the device time a step of matching_kernel and
targets_kernel, in %."""

from portbench.harness import op_ms_per_iter


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("complete"):
        return None
    ms = op_ms_per_iter(tr, lambda n: "matching_kernel" in n or "targets_kernel" in n)
    return 100.0 * rec["bounds_ms"]["targets"] / ms if ms else None
