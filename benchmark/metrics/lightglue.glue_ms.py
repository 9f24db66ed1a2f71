"""`lightglue.glue_ms`: device ms a pair launched inside the span
`lightglue.glue` around the 9 layers of `models/lightglue.py`, the
assignment and the mutual filter of `ops/matching`."""

SPANS = {"lightglue.glue": "model:lightglue"}


def read(t):
    s = t.span_device_s.get("lightglue.glue", 0.0)
    return s * 1e3 / t.pairs if s > 0 and t.pairs else None
