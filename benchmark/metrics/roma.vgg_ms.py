"""`roma.vgg_ms`: device ms a pair launched inside the port's span
`gim.roma.vgg` (`models/roma/model.VGG19.forward`): the VGG19-BN fine
pyramid of both images as one batch, at 672 x 672 in the coarse pass and
1344 x 1344 in the upsample pass. Nothing where the port places no such
span."""

from benchmark.harness.program import TARGET

SPANS = {"gim.roma.vgg": TARGET}


def read(t):
    s = t.span_device_s.get("gim.roma.vgg", 0.0)
    return s * 1e3 / t.pairs if s > 0 and t.pairs else None
