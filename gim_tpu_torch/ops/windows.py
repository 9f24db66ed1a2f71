"""Patch/window extraction for LoFTR fine preprocessing.

Port of `gim_tpu/ops/windows.py:17-53` (reference semantics: F.unfold with
kernel W, stride `stride`, padding W//2 at each selected coarse cell, ref
networks/loftr/submodules/fine_preprocess.py:40-48). Windows are gathered
only at the selected matches instead of unfolding the whole fine map.
"""

from __future__ import annotations

import torch


def extract_windows_batch(feat: torch.Tensor, centers_ij: torch.Tensor, *,
                          window: int, stride: int) -> torch.Tensor:
    """Gather W*W windows from `feat` (B, H, W, C) around coarse cells.

    centers_ij: (B, M) flattened indices into the (H//stride, W//stride)
    coarse grid; each selects the window centred at fine-map location
    i*stride. Returns (B, M, window*window, C).

    One gather over the (B, H*W, C) rows with clamped indices; taps that
    fall outside the map are zeroed by a mask, which gives F.unfold's
    zero-padding without a padded copy of the map.
    """
    B, H, W, C = feat.shape
    M = centers_ij.shape[1]
    r = window // 2
    Wc = W // stride
    centers_ij = centers_ij.long()
    ci = (centers_ij // Wc) * stride
    cj = (centers_ij % Wc) * stride

    off = torch.arange(-r, r + 1, device=feat.device)
    yy = ci[:, :, None, None] + off[None, None, :, None]      # (B, M, w, 1)
    xx = cj[:, :, None, None] + off[None, None, None, :]      # (B, M, 1, w)
    yy, xx = torch.broadcast_tensors(yy, xx)
    valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(B, -1)
    flat = feat.reshape(B, H * W, C)
    out = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
    out = out * valid.reshape(B, -1, 1).to(out.dtype)
    return out.reshape(B, M, window * window, C)
