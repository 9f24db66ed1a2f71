"""`jax.image.resize` rules that PyTorch's resizes do not share.

- "bicubic": `jax.image.resize` uses the Keys cubic kernel with a = -0.5
  and renormalises the weights that fall inside the image, where
  `F.interpolate(mode="bicubic")` uses a = -0.75 and clamps at the border.
  `bicubic_matrix` builds JAX's (out, in) weights (jax/_src/image/scale.py
  `compute_weight_mat`, float32, antialiased when downsampling) so a
  resize is two small matrix products.
- "nearest": JAX takes input index floor((i + 0.5) in / out), in float32
  (half-pixel centres); torch's "nearest" takes floor(i in / out).
  `nearest_indices` gives JAX's indices.
"""

from __future__ import annotations

import numpy as np
import torch


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
