"""`dkm.sample_ms`: device ms a pair launched inside the span `dkm.sample`
around the balanced sampling of `models/dkm/model.sample_matches`."""

SPANS = {"dkm.sample": "gim_tpu_torch.api:sample_matches"}


def read(t):
    s = t.span_device_s.get("dkm.sample", 0.0)
    return s * 1e3 / t.pairs if s > 0 and t.pairs else None
