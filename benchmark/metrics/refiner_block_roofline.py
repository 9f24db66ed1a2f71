"""`refiner_block_roofline`: the least time the ConvRefiner hidden blocks'
work could take on the card (`harness/peaks.refiner_block_floor_s`:
the depthwise on the FP32 lanes, the 1x1 counted once at the TF32 peak,
each byte once; the largest term), over the device time launched inside
the span around `fused_dw_block` (kernel K2), in %. Read at the span and
counted from the shapes of its calls, so it reads the same work whatever
implements the block."""

from benchmark.harness.peaks import refiner_block_floor_s

SPANS = {"refiner_block":
         "gim_tpu_torch.models.dkm.blocks:fused_dw_block"}


def read(t):
    calls = t.span_shapes.get("refiner_block", [])
    spent = t.span_device_s.get("refiner_block", 0.0)
    if not calls or spent <= 0:
        return None
    floor = 0.0
    for shapes in calls:
        (B, C, H, W), (C_out, _) = shapes[0], shapes[3]
        floor += refiner_block_floor_s(B, C, C_out, H, W)["floor"]
    return 100.0 * floor / spent
