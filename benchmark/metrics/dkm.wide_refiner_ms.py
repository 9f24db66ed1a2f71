"""`dkm.wide_refiner_ms`: device ms a pair launched inside the port's
spans `gim.dkm.refiner.16`, `gim.dkm.refiner.8` and `gim.dkm.refiner.4`
(`models/dkm/model.DKMDecoder`, both passes): the ConvRefiners 1377, 1137
and 569 channels wide, whose hidden blocks are too wide for the fused
refiner_block kernel and run as cuDNN's depthwise and 1x1 convolutions.
Nothing where the port places no such span."""

from benchmark.harness.program import TARGET

SPANS = {f"gim.dkm.refiner.{s}": TARGET for s in ("16", "8", "4")}


def read(t):
    s = sum(t.span_device_s.get(name, 0.0) for name in SPANS)
    return s * 1e3 / t.pairs if s > 0 and t.pairs else None
