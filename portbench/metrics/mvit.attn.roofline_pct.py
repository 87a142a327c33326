"""mvit.attn.roofline_pct: the 24 pooled attention cores' bound
(portbench.counts_mvit.attn_bound: q k^T, attention x v and q . R at the
bf16 peak against q, k and v read and the output written once, whichever
is larger) over their device time a batch (mvit.attn_ms), in %. It counts
the same work whatever computes it."""

from portbench.program import device_ms


def read(rec):
    ms = device_ms(rec, ("rpn.attn.window", "rpn.attn.global"))
    bound = rec.get("bounds_ms", {}).get("mvit_attn")
    return 100.0 * bound / ms if ms and bound else None
