"""`lightglue.attention_ms`: device ms a pair launched inside the port's
span `gim.lightglue.attention` (`ops/kernels/flash.flash_sdpa_masked`):
LightGlue's self and cross attention on K3's masked float32 variant, 36
launches a call, each with its K / V split pass. Nothing where the port
places no such span."""

from benchmark.harness.program import TARGET

SPANS = {"gim.lightglue.attention": TARGET}


def read(t):
    s = t.span_device_s.get("gim.lightglue.attention", 0.0)
    return s * 1e3 / t.pairs if s > 0 and t.pairs else None
