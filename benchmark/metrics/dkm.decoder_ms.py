"""`dkm.decoder_ms`: device ms a pair launched inside the span
`dkm.decoder` around `models/dkm/model.DKMDecoder` (the GP, the DFN and
the ConvRefiners, K2 inside), both passes."""

SPANS = {"dkm.decoder": "model:decoder"}


def read(t):
    s = t.span_device_s.get("dkm.decoder", 0.0)
    return s * 1e3 / t.pairs if s > 0 and t.pairs else None
