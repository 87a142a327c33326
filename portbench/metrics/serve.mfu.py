"""serve.mfu: model FLOPs (portbench.counts.forward_flops) times the
window's images, over the window's seconds and one card's 989 TFLOP/s
(bf16, the configuration's compute dtype), in %."""

from portbench.counts import PEAK_BF16


def read(rec):
    return 100.0 * rec["flops_per_image"] * rec["images"] / rec["window_s"] / PEAK_BF16
