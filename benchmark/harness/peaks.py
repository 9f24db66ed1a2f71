"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates,
700 W) and the work of the kernels whose rooflines the benchmark reads,
counted from shapes.

A roofline counts the work the algorithm needs, each input byte read once
and each output byte written once, whatever a kernel does to compute it:
so it reads the same whichever implementation runs.
"""

from __future__ import annotations

PEAK_TF32_FLOPS = 495e12      # tensor cores, TF32 inputs: the fastest
                              # rate at which the card multiplies float32
PEAK_F32_FLOPS = 66.9e12      # FP32 lanes: 132 SMs x 128 x 2 at 1.98 GHz
PEAK_BYTES = 3.35e12          # HBM3


def refiner_block_floor_s(B: int, C: int, C_out: int, H: int, W: int,
                          elt: int = 4, taps: int = 25) -> dict:
    """The least time of one ConvRefiner hidden block, depthwise 5x5 with
    folded BatchNorm, ReLU, 1x1 C -> C_out, on (B, C, H, W) in float32:
    each term in seconds and the floor, the largest of them.

    - depthwise: 2 x taps multiply-adds a channel and pixel on the FP32
      lanes;
    - 1x1: 2 C C_out a pixel, counted once, at the TF32 dense peak;
    - bytes: x read once, the output written once, the folded parameters
      (taps and bias of the depthwise, w1 and b1) read once."""
    px = B * H * W
    terms = {
        "depthwise": 2.0 * taps * C * px / PEAK_F32_FLOPS,
        "pointwise": 2.0 * C * C_out * px / PEAK_TF32_FLOPS,
        "bytes": elt * (px * (C + C_out)
                        + (taps + 1) * C + C * C_out + C_out) / PEAK_BYTES,
    }
    terms["floor"] = max(terms.values())
    return terms
