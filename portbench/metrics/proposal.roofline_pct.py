"""proposal.roofline_pct: the proposal selection's bound (portbench.counts.
proposal_bound, its greedy walk counted on the reference's candidates of
sampled frames, per image times the batch) over the device time a batch of
proposal_kernel, in %."""

from portbench.harness import op_ms_per_iter


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("complete"):
        return None
    ms = op_ms_per_iter(tr, lambda n: "proposal_kernel" in n)
    return 100.0 * rec["bounds_ms"]["proposal"] / ms if ms else None
