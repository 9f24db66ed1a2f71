"""`flash_attention_roofline`: the least time the attentions' work could
take on the card (`floor_s`), over the device time launched inside the
span around `models/dinov2.flash_sdpa` (kernel K3: DINOv2's 24
attentions and the RoMa decoder's 5, which `Attention.forward` looks up
there at call time), in %. Read at the span and counted from the shapes
of its calls, so it reads the same work whatever implements it."""

from benchmark.harness.peaks import PEAK_BYTES, PEAK_TF32_FLOPS

SPANS = {"flash_attention": "gim_tpu_torch.models.dinov2:flash_sdpa"}


def floor_s(B: int, H: int, N: int, D: int, elt: int = 4) -> dict:
    """The least time of softmax(q k^T / sqrt(D)) v on (B, H, N, D) in
    float32: each term in seconds and the floor, the larger of them.

    - products: q k^T and p v, 4 B H N^2 D, counted once at the TF32
      dense peak (the fastest rate at which the card multiplies float32;
      the kernel's three TF32 products a product are its way of keeping
      float32, not the algorithm's work);
    - bytes: q, k and v read once and the output written once."""
    terms = {"products": 4.0 * B * H * N * N * D / PEAK_TF32_FLOPS,
             "bytes": 4.0 * elt * B * H * N * D / PEAK_BYTES}
    terms["floor"] = max(terms.values())
    return terms


def read(t):
    calls = t.span_shapes.get("flash_attention", [])
    spent = t.span_device_s.get("flash_attention", 0.0)
    if not calls or spent <= 0:
        return None
    floor = sum(floor_s(*shapes[0])["floor"] for shapes in calls)
    return 100.0 * floor / spent
