"""`mfu`: the configuration's FLOPs a pair, counted over the plain
reference with `torch.utils.flop_counter.FlopCounterMode` (convolutions,
grouped ones by their weight's shape, matrix products, attention; not
the pose, resampling or elementwise work), times the pairs of the traced
window, over the window and the TF32 dense peak (both configurations are
float32), in %."""

from benchmark.harness.peaks import PEAK_TF32_FLOPS

SPANS = {}
NEEDS_FLOPS = True


def read(t):
    if not t.flops_per_pair or t.window_s <= 0:
        return None
    return 100.0 * t.flops_per_pair * t.pairs / t.window_s / PEAK_TF32_FLOPS
