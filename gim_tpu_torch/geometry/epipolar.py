"""Epipolar geometry primitives, batched (port of
`gim_tpu/geometry/epipolar.py`).

The math of the reference's tools/metrics.py:32-74 (symmetric epipolar
distance, E = [t]x R), batched over leading dims.
"""

from __future__ import annotations

import torch

from gim_tpu_torch.utils.precision import highp


def cross_product_matrix(t: torch.Tensor) -> torch.Tensor:
    """[t]x skew-symmetric matrix. t: (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(t[..., 0])
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    return torch.stack([
        torch.stack([zeros, -tz, ty], dim=-1),
        torch.stack([tz, zeros, -tx], dim=-1),
        torch.stack([-ty, tx, zeros], dim=-1),
    ], dim=-2)


def essential_from_pose(T_0to1: torch.Tensor) -> torch.Tensor:
    """E = [t]x @ R from a (..., 4, 4) relative transform."""
    return cross_product_matrix(T_0to1[..., :3, 3]) @ T_0to1[..., :3, :3]


def normalize_points(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pinhole-normalize pixel points. pts: (..., N, 2), K: (..., 3, 3)."""
    c = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)[..., None, :]
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)[..., None, :]
    return (pts - c) / f


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


@highp
def symmetric_epipolar_distance(pts0: torch.Tensor, pts1: torch.Tensor,
                                E: torch.Tensor, K0: torch.Tensor,
                                K1: torch.Tensor) -> torch.Tensor:
    """Squared symmetric epipolar distance in normalized coords.
    pts: (..., N, 2) pixels; E: (..., 3, 3)."""
    p0 = to_homogeneous(normalize_points(pts0, K0))
    p1 = to_homogeneous(normalize_points(pts1, K1))
    Ep0 = p0 @ E.transpose(-1, -2)                # (..., N, 3)
    p1Ep0 = (p1 * Ep0).sum(-1)
    Etp1 = p1 @ E
    return p1Ep0 ** 2 * (1.0 / (Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2)
                         + 1.0 / (Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2))


@highp
def sampson_distance(p0h: torch.Tensor, p1h: torch.Tensor,
                     F: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) error. p0h/p1h: (..., N, 3)
    homogeneous; F: (..., 3, 3). Returns squared distance (..., N)."""
    Fp0 = p0h @ F.transpose(-1, -2)
    Ftp1 = p1h @ F
    num = (p1h * Fp0).sum(-1) ** 2
    den = (Fp0[..., 0] ** 2 + Fp0[..., 1] ** 2
           + Ftp1[..., 0] ** 2 + Ftp1[..., 1] ** 2)
    return num / den.clamp_min(1e-12)
