"""`dkm.encoder_ms`: device ms a pair launched inside the span
`dkm.encoder` around the ResNet-50 pyramid (`models/dkm/encoder.py` on
`models/resnet.py`), both passes."""

SPANS = {"dkm.encoder": "model:encoder"}


def read(t):
    s = t.span_device_s.get("dkm.encoder", 0.0)
    return s * 1e3 / t.pairs if s > 0 and t.pairs else None
