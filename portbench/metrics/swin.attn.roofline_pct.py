"""swin.attn.roofline_pct: the 24 window attention cores' bound
(portbench.counts_swin.attn_bound: q k^T and attention x v at the bf16 peak
against q, k and v read and the output written once over the padded grids,
whichever is larger) over their device time a batch (swin.attn_ms), in %.
It counts the same work whatever computes it."""

from portbench.program import device_ms


def read(rec):
    ms = device_ms(rec, ("rpn.attn.window", "rpn.attn.shifted"))
    bound = rec.get("bounds_ms", {}).get("swin_attn")
    return 100.0 * bound / ms if ms and bound else None
