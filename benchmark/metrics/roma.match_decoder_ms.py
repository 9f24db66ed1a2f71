"""`roma.match_decoder_ms`: device ms a pair launched inside the port's
span `gim.roma.match_decoder` (`models/roma/model.RoMaDecoder`, the
coarse pass at scale 16): the GP's 2304 x 2304 solves, the 5-block
transformer decoder classifying each coarse pixel over 64 x 64 anchors
(its attentions on kernel K3) and `cls_to_flow_refine`. Nothing where
the port places no such span."""

from benchmark.harness.program import TARGET

SPANS = {"gim.roma.match_decoder": TARGET}


def read(t):
    s = t.span_device_s.get("gim.roma.match_decoder", 0.0)
    return s * 1e3 / t.pairs if s > 0 and t.pairs else None
