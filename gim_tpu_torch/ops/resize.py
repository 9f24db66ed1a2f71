"""Resizes as explicit operators: `jax.image.resize` rules that PyTorch's
resizes do not share, and a bilinear resize whose backward is exact.

- "bicubic": `jax.image.resize` uses the Keys cubic kernel with a = -0.5
  and renormalises the weights that fall inside the image, where
  `F.interpolate(mode="bicubic")` uses a = -0.75 and clamps at the border.
  `bicubic_matrix` builds JAX's (out, in) weights (jax/_src/image/scale.py
  `compute_weight_mat`, float32, antialiased when downsampling) so a
  resize is two small matrix products.
- "nearest": JAX takes input index floor((i + 0.5) in / out), in float32
  (half-pixel centres); torch's "nearest" takes floor(i in / out).
  `nearest_indices` gives JAX's indices.
- "bilinear": `bilinear_taps` is `F.interpolate`'s linear operator along
  one axis, for either `align_corners`. `BilinearResize` is the
  half-pixel resize whose backward is two products with it, the same
  bits in every run, where CUDA's `upsample_bilinear2d_backward` adds
  with atomics and has no deterministic kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    far = ((np.float32(-0.5) * x + np.float32(2.5)) * x
           - np.float32(4.0)) * x + np.float32(2.0)
    out = np.where(x >= 1.0, far, out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def bicubic_matrix(in_size: int, out_size: int) -> torch.Tensor:
    """(out_size, in_size) float32 weights of `jax.image.resize(...,
    "bicubic")` along one axis: out = W @ in."""
    inv_scale = np.float32(in_size / out_size)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :]
                - np.arange(in_size, dtype=np.float32)[:, None])
         / np.float32(kernel_scale)).astype(np.float32)
    w = _keys_cubic(x)                                   # (in, out)
    total = w.sum(0, keepdims=True, dtype=np.float32)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(ok, w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, np.float32(0.0))
    return torch.from_numpy(np.ascontiguousarray(w.T))


def nearest_indices(in_size: int, out_size: int) -> torch.Tensor:
    """Input index of each output index for `jax.image.resize(...,
    "nearest")` (int64)."""
    off = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
           * np.float32(in_size)) / np.float32(out_size)
    return torch.from_numpy(np.floor(off.astype(np.float32)).astype(np.int64))


def bilinear_taps(n_in: int, n_out: int, align_corners: bool,
                  device=None) -> torch.Tensor:
    """(n_out, n_in) float64 matrix of `F.interpolate`'s linear taps along
    one axis, out = A @ in. Output i reads source i (n_in - 1) / (n_out - 1)
    with `align_corners`, else (i + 0.5) n_in / n_out - 0.5 clamped at 0,
    blended between its floor and the next index (the last index repeats
    at the edge). Built on `device`."""
    i = torch.arange(n_out, device=device, dtype=torch.float64)
    if align_corners:
        src = i * (n_in - 1) / max(n_out - 1, 1)
    else:
        src = ((i + 0.5) * (n_in / n_out) - 0.5).clamp_min(0.0)
    i0 = src.floor().long().clamp_max(n_in - 1)
    i1 = (i0 + 1).clamp_max(n_in - 1)
    l1 = src - i0
    cols = torch.arange(n_in, device=device)
    return ((cols == i0[:, None]) * (1.0 - l1[:, None])
            + (cols == i1[:, None]) * l1[:, None])


class BilinearResize(torch.autograd.Function):
    """`F.interpolate(x, size, mode="bilinear", align_corners=False)` on
    NCHW whose backward gives the same bits in every run: the adjoint of
    the separable taps as two matrix products, A_h^T g A_w. The taps are
    built on the gradient's device at each call: a cached copy there would
    pin a block of the allocator's segments for good."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.in_hw = tuple(x.shape[-2:])
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False, antialias=False)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (hi, wi), (ho, wo) = ctx.in_hw, g.shape[-2:]
        ah = bilinear_taps(hi, ho, False, g.device).to(g.dtype)
        aw = bilinear_taps(wi, wo, False, g.device).to(g.dtype)
        return torch.matmul(ah.t(), torch.matmul(g, aw)), None


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to `size`, half-pixel centres, no
    antialias (torch's `F.interpolate` default, also when downsampling),
    through `BilinearResize`."""
    return BilinearResize.apply(x, tuple(size))
