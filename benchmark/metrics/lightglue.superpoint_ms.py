"""`lightglue.superpoint_ms`: device ms a pair launched inside the span
`lightglue.superpoint` around SuperPoint's dense heads, NMS, borders,
top-k and descriptor sampling (`models/superpoint.py`, `ops/detect.py`),
both images."""

SPANS = {"lightglue.superpoint": "gim_tpu_torch.api:extract"}


def read(t):
    s = t.span_device_s.get("lightglue.superpoint", 0.0)
    return s * 1e3 / t.pairs if s > 0 and t.pairs else None
