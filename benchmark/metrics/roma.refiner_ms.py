"""`roma.refiner_ms`: device ms a pair launched inside the port's spans
`gim.roma.refiner.<s>` (`models/roma/model.RoMaDecoder`, both passes):
the five ConvRefiners, 1377, 1137 and 569 channels wide with local
correlation at scales 16, 8 and 4, then 144 and 24 wide at scales 2 and
1, whose hidden blocks run on kernel K2. Nothing where the port places
no such span."""

from benchmark.harness.program import TARGET

SPANS = {f"gim.roma.refiner.{s}": TARGET for s in ("16", "8", "4", "2", "1")}


def read(t):
    s = sum(t.span_device_s.get(name, 0.0) for name in SPANS)
    return s * 1e3 / t.pairs if s > 0 and t.pairs else None
