"""Bilinear grid sampling.

Port of `gim_tpu/ops/sampling.py:39-96` (`grid_sample`), which the JAX
package writes as four row gathers because the TPU has no sampler. Its
rule is torch's (`F.grid_sample`, bilinear, padding "zeros" or "border"),
so here it is that call, in the JAX package's layout. Sampling runs in
float32 whatever the image's dtype: `F.grid_sample` wants the grid in the
image's dtype, and a bf16 grid cannot address a 1344-pixel image to the
pixel. The JAX function promotes a bf16 image to float32 the same way
(its bilinear weights are float32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(image: torch.Tensor, grid: torch.Tensor, *,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample `image` (..., C, H, W) at `grid` (..., P, 2), xy in
    [-1, 1], align_corners=False (the reference convention). The leading
    dims of both are equal. Returns (..., C, P) in float32."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    C, H, W = image.shape[-3:]
    lead = image.shape[:-3]
    P = grid.shape[-2]
    img = image.reshape(-1, C, H, W).float()
    g = grid.reshape(-1, 1, P, 2).float()
    out = F.grid_sample(img, g, mode="bilinear", padding_mode=padding_mode,
                        align_corners=False)                  # (N, C, 1, P)
    return out.reshape(*lead, C, P)
