"""train.mfu: 3 x forward FLOPs (portbench.counts.forward_flops) times the
window's images, over the window's seconds, the cards and 989 TFLOP/s
each, in %."""

from portbench.counts import PEAK_BF16


def read(rec):
    return (100.0 * 3 * rec["flops_per_image"] * rec["images"]
            / (rec["window_s"] * rec["chips"] * PEAK_BF16))
