"""vitdet.global_attn.roofline_pct: the global attention cores' bound
(portbench.counts_levels.global_attn_bound: q k^T and attention x v at the
bf16 peak against q, k and v read, the output written and the tables read
once) over their device time a batch (vitdet.global_attn_ms), in %. It
counts the same work whatever computes it."""

from portbench.program import device_ms


def read(rec):
    ms = device_ms(rec, ("rpn.attn.global",))
    bound = rec.get("bounds_ms", {}).get("global_attn")
    return 100.0 * bound / ms if ms and bound else None
