"""Keypoint detection: max-pool NMS and static-shape top-k extraction.

Port of `gim_tpu/ops/detect.py` (reference semantics: SuperPoint's
`simple_nms`, ref networks/lightglue/superpoint.py:61-81, and its sparse
output extraction, :243-325). The reference's dynamic selection is a
capped top-k plus validity masks, as in the JAX package.

Ranking uses a stable descending sort, so among equal scores the lower
flat index comes first, as `jax.lax.top_k` orders them (`torch.topk`
does not promise an order). Equal scores do occur: NMS keeps every pixel
of a flat maximum plateau.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1) x (2r+1) stride-1 max pool over (B, H, W), SAME padding
    with -inf (`gim_tpu/ops/detect.py:17-24`)."""
    return F.max_pool2d(x, 2 * radius + 1, stride=1, padding=radius)


def simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Max-pool NMS with two suppression rounds (`detect.py:27-38`).
    scores: (B, H, W)."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool_2d(scores, radius)
    for _ in range(2):
        supp_mask = max_pool_2d(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool_2d(supp_scores, radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def remove_borders(scores: torch.Tensor, border: int,
                   image_hw: torch.Tensor | None = None) -> torch.Tensor:
    """Scores within `border` px of the image's edges set to -1
    (`detect.py:41-58`). image_hw: (B, 2) true (h, w) of content on a
    padded canvas; default the map's own size."""
    H, W = scores.shape[-2:]
    ys = torch.arange(H, device=scores.device)[:, None]
    xs = torch.arange(W, device=scores.device)[None, :]
    if image_hw is None:
        h, w = H, W
    else:
        hw = image_hw.to(torch.int32)
        h = hw[:, 0, None, None]
        w = hw[:, 1, None, None]
    inside = ((ys >= border) & (ys < h - border)
              & (xs >= border) & (xs < w - border))
    return torch.where(inside, scores, -1.0)


def topk_keypoints(scores: torch.Tensor, k: int, threshold: float = 0.0,
                   pad_noise: torch.Tensor | None = None,
                   bounds_hw: torch.Tensor | None = None):
    """Up to k keypoints per image of a (B, H, W) score map after NMS
    (`detect.py:61-91`). Returns kpts (B, k, 2) xy at integer pixels,
    scores (B, k) (0 below threshold) and valid (B, k).

    Slots at or below `threshold` take the position `pad_noise * lim`
    where pad_noise, (B, k, 2) uniforms in [0, 1), is given (the
    reference's force_num_keypoints pad), with lim the smaller side of
    `bounds_hw` (B, 2), else of the map; without pad_noise they sit at
    (0, 0)."""
    B, H, W = scores.shape
    vals, idx = torch.sort(scores.reshape(B, H * W), dim=1, descending=True,
                           stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    ys = torch.div(idx, W, rounding_mode="floor").float()
    xs = (idx % W).float()
    kpts = torch.stack([xs, ys], dim=-1)
    valid = vals > threshold
    kscores = torch.where(valid, vals, 0.0)
    if pad_noise is not None:
        if bounds_hw is None:
            lim = torch.full((B, 1, 1), float(min(H, W)),
                             device=scores.device)
        else:
            lim = bounds_hw.amin(-1).float()[:, None, None]
        fill = pad_noise * lim
    else:
        fill = torch.zeros_like(kpts)
    return torch.where(valid[..., None], kpts, fill), kscores, valid
