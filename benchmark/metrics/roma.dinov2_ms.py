"""`roma.dinov2_ms`: device ms a pair launched inside the port's span
`gim.roma.dinov2` (`models/roma/model.RoMaMatcher.pyramids`): the frozen
DINOv2 ViT-L/14 trunk over both images' 48 x 48 patches and class token,
its 24 attentions on kernel K3. Nothing where the port places no such
span."""

from benchmark.harness.program import TARGET

SPANS = {"gim.roma.dinov2": TARGET}


def read(t):
    s = t.span_device_s.get("gim.roma.dinov2", 0.0)
    return s * 1e3 / t.pairs if s > 0 and t.pairs else None
