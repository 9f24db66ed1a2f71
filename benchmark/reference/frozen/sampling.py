"""Bilinear grid sampling and SuperPoint's descriptor sampling: frozen
copy of the port's `ops/sampling.py` forward (`F.grid_sample` in the JAX
package's layout), without its deterministic backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def safe_l2_normalize(x: torch.Tensor, dim: int = -1,
                      eps: float = 1e-12) -> torch.Tensor:
    """`x * rsqrt(sum(x^2) + eps)` along `dim`, the JAX package's form
    (finite at an exact zero vector), not `F.normalize`'s
    `x / max(||x||, eps)`."""
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


def bilinear_sample(image: torch.Tensor, grid: torch.Tensor, *,
                    align_corners: bool = False,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """`F.grid_sample`, bilinear; image (N, C, H, W), grid (N, Hg, Wg, 2)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    return F.grid_sample(image, grid, mode="bilinear",
                         padding_mode=padding_mode,
                         align_corners=align_corners)


def grid_sample(image: torch.Tensor, grid: torch.Tensor, *,
                align_corners: bool = False,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample `image` (..., C, H, W) at `grid` (..., P, 2), xy in
    [-1, 1] (align_corners=False is the reference convention). The
    leading dims of both are equal. Returns (..., C, P) in float32."""
    C, H, W = image.shape[-3:]
    lead = image.shape[:-3]
    P = grid.shape[-2]
    img = image.reshape(-1, C, H, W).float()
    g = grid.reshape(-1, 1, P, 2).float()
    out = bilinear_sample(img, g, padding_mode=padding_mode,
                          align_corners=align_corners)       # (N, C, 1, P)
    return out.reshape(*lead, C, P)


def sample_descriptors(kpts: torch.Tensor, descriptors: torch.Tensor,
                       s: int = 8, legacy: bool = False) -> torch.Tensor:
    """SuperPoint's descriptors at keypoints (`gim_tpu/ops/sampling.py:
    99-127`). kpts: (B, K, 2) xy in full-resolution pixels; descriptors:
    (B, C, Hc, Wc) at stride `s`. Returns (B, K, C), L2-normalized.

    legacy=True is the reference's normalization that its weights were
    trained with (ref superpoint.py:117-134): (kpts - s/2 + 0.5) divided
    by s * size - s/2 - 0.5, align_corners=True. legacy=False is the
    fixed half-pixel grid (ref superpoint.py:139-150), align_corners=False.
    The divisors are Python numbers: a tensor made from them on the card
    would be a host-to-device copy that waits for the stream."""
    C, Hc, Wc = descriptors.shape[-3:]
    if legacy:
        x = kpts - s / 2 + 0.5
        div = (Wc * s - s / 2 - 0.5, Hc * s - s / 2 - 0.5)
    else:
        x, div = kpts, (Wc * s, Hc * s)
    g = torch.stack([x[..., 0] / div[0], x[..., 1] / div[1]], -1) * 2 - 1
    out = grid_sample(descriptors, g, align_corners=legacy)
    return safe_l2_normalize(out.transpose(-1, -2), dim=-1)
