"""ir_stage.roofline_pct: the IR stage's bound (portbench.counts.
ir_stage_bound at the run's batch and tap size) over the device time a
batch of its two kernels, ir_block_kernel and ir_expand_kernel, in %."""

from portbench.harness import op_ms_per_iter


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("complete"):
        return None
    ms = op_ms_per_iter(tr, lambda n: "ir_block_kernel" in n or "ir_expand_kernel" in n)
    return 100.0 * rec["bounds_ms"]["ir_stage"] / ms if ms else None
