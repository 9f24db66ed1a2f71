"""Batched RANSAC for essential / fundamental / homography estimation (port
of `gim_tpu/geometry/ransac.py`).

The on-device replacement for the reference's host-side OpenCV calls
(cv2.findEssentialMat + cv2.recoverPose in the eval hot path,
cv2.findFundamentalMat in demo and video pipelines). A fixed bank of
hypotheses is solved and scored in parallel: 5-point Nister samples for
'essential' (up to 10 candidates each, `geometry/fivepoint.py`), 8-point
DLT for 'fundamental', 4-point DLT for 'homography'. Scoring is the
sigma-marginalized MAGSAC-like gain over chunks of 2048 models; one LO
resampling round at a quarter of the bank draws from the best model's
loose inliers; three IRLS refits are kept only where they do not lower
the gain. Shapes are static: invalid points carry a mask.

Where the JAX package vmaps one pair, every function here takes a leading
pair axis B. Its uniforms come from threefry keys; the port cannot
reproduce that stream, so `ransac` takes them as `noise` (the two banks,
(B, H, M) and (B, max(H // 4, 32), M)) or draws them from one
`torch.Generator` per pair (`draw_noise`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from gim_tpu_torch.geometry.epipolar import sampson_distance, to_homogeneous
from gim_tpu_torch.geometry.fivepoint import essential_candidates
from gim_tpu_torch.utils.device import device_constant
from gim_tpu_torch.utils.precision import highp

CHUNK = 2048          # models scored at once per pair


class RansacResult(NamedTuple):
    model: torch.Tensor        # (B, 3, 3) F / E / H
    inliers: torch.Tensor      # (B, M) bool
    num_inliers: torch.Tensor  # (B,) int32
    success: torch.Tensor      # (B,) bool


def lo_hypotheses(num_hypotheses: int) -> int:
    """Hypotheses of the LO resampling round."""
    return max(num_hypotheses // 4, 32)


def draw_noise(generators: Sequence[torch.Generator], num_hypotheses: int,
               M: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """RANSAC's two uniform banks, one generator per pair: (B, H, M) for
    the first round, then (B, H_lo, M) for the LO round, drawn in that
    order from each pair's generator on `device`."""
    first, lo = [], []
    for g in generators:
        first.append(torch.rand((num_hypotheses, M), generator=g,
                                device=device))
        lo.append(torch.rand((lo_hypotheses(num_hypotheses), M),
                             generator=g, device=device))
    return torch.stack(first), torch.stack(lo)


# ---------------------------------------------------------------------------
# Small closed forms (no LAPACK call, so no host sync on the card)
# ---------------------------------------------------------------------------

def _det3(A: torch.Tensor) -> torch.Tensor:
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def _inv(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse without the error check that reads the device."""
    return torch.linalg.inv_ex(A).inverse


def _svd(A: torch.Tensor, full_matrices: bool = True):
    """SVD whose non-finite inputs give NaN outputs, as the JAX package's
    does (torch's raises on them)."""
    finite = torch.isfinite(A).all(-1).all(-1)
    u, s, vt = torch.linalg.svd(
        torch.where(finite[..., None, None], A, 0.0),
        full_matrices=full_matrices)
    f = finite[..., None, None]
    nan = float("nan")
    return (torch.where(f, u, nan), torch.where(f[..., 0], s, nan),
            torch.where(f, vt, nan))


# ---------------------------------------------------------------------------
# Hartley normalization
# ---------------------------------------------------------------------------

def hartley_transform(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Isotropic normalizing transform T (B, 3, 3): centroid -> 0,
    RMS -> sqrt(2). Statistics over valid points only. pts: (B, M, 2)."""
    w = valid.to(pts.dtype)
    n = w.sum(-1).clamp_min(1.0)                      # (B,)
    mean = (pts * w[..., None]).sum(-2) / n[:, None]  # (B, 2)
    d = torch.linalg.vector_norm(pts - mean[:, None], dim=-1)
    rms = (((d ** 2) * w).sum(-1) / n).sqrt()
    s = 2.0 ** 0.5 / rms.clamp_min(1e-12)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * mean[:, 0]], -1),
        torch.stack([zero, s, -s * mean[:, 1]], -1),
        torch.stack([zero, zero, one], -1)], -2)


def _apply_T(pts: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    return pts * T[:, None, 0:1, 0] + T[:, None, :2, 2]


# ---------------------------------------------------------------------------
# Minimal solvers (in the conditioned frame)
# ---------------------------------------------------------------------------

def _epipolar_rows(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Rows of the DLT system p1^T F p0 = 0. (..., N, 2) -> (..., N, 9)."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    one = torch.ones_like(x0)
    return torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                        x0, y0, one], dim=-1)


def _nullspace9(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Right-singular vector of the smallest singular value of the
    weighted DLT system. rows: (..., M, 9); w: (..., M) >= 0.

    SVD of the sqrt(w)-scaled rows, not eigh of A^T A (which squares the
    condition number); systems of fewer than 9 rows are zero-padded so
    the thin SVD still exposes the nullspace."""
    a = rows * w.sqrt()[..., None]
    if a.shape[-2] < 9:
        a = torch.nn.functional.pad(a, (0, 0, 0, 9 - a.shape[-2]))
    return _svd(a, full_matrices=False)[2][..., -1, :]


def project_fundamental(F: torch.Tensor) -> torch.Tensor:
    """Nearest rank-2 matrix (the smallest singular value zeroed)."""
    u, s, vt = _svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return (u * s[..., None, :]) @ vt


def project_essential(F: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values -> (1, 1, 0)."""
    u, _, vt = _svd(F)
    return (u[..., :, :2]) @ vt[..., :2, :]


@highp
def solve_epipolar_raw(p0: torch.Tensor, p1: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT solve of p1^T F p0 = 0 (no rank projection).
    p0/p1: (..., M, 2); w: (..., M). Returns (..., 3, 3)."""
    return _nullspace9(_epipolar_rows(p0, p1), w).unflatten(-1, (3, 3))


def _homography_rows(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """DLT rows for p1 ~ H p0. (..., N, 2) -> (..., N, 2, 9)."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    one = torch.ones_like(x0)
    zero = torch.zeros_like(x0)
    r1 = torch.stack([x0, y0, one, zero, zero, zero,
                      -x1 * x0, -x1 * y0, -x1], dim=-1)
    r2 = torch.stack([zero, zero, zero, x0, y0, one,
                      -y1 * x0, -y1 * y0, -y1], dim=-1)
    return torch.stack([r1, r2], dim=-2)


@highp
def solve_homography_raw(p0: torch.Tensor, p1: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    rows = _homography_rows(p0, p1).flatten(-3, -2)   # (..., 2M, 9)
    h = _nullspace9(rows, w.repeat_interleave(2, dim=-1))
    return h.unflatten(-1, (3, 3))


def _dehomog(q: torch.Tensor) -> torch.Tensor:
    z = q[..., 2:]
    return q[..., :2] / torch.where(z.abs() < 1e-12, 1e-12, z)


@highp
def homography_transfer_error(p0: torch.Tensor, p1: torch.Tensor,
                              H: torch.Tensor) -> torch.Tensor:
    """Squared symmetric transfer error. p0/p1: (..., M, 2); H: (..., 3, 3)."""
    q1 = _dehomog(to_homogeneous(p0) @ H.transpose(-1, -2))
    q0 = _dehomog(to_homogeneous(p1) @ _inv(H).transpose(-1, -2))
    return ((q1 - p1) ** 2).sum(-1) + ((q0 - p0) ** 2).sum(-1)


# ---------------------------------------------------------------------------
# Hypothesis sampling
# ---------------------------------------------------------------------------

def _sample_minimal(noise: torch.Tensor, valid: torch.Tensor,
                    sample_size: int,
                    conf: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, sample_size) indices of valid points, drawn without
    replacement per hypothesis by the Gumbel-top-k trick from the uniform
    bank `noise` (B, H, M).

    With `conf` (B, M), PROSAC-style progressive sampling: points ranked
    by confidence (a stable sort, as jnp.argsort is), hypothesis h draws
    from the top-n_h prefix, n_h growing from ~2x the sample size to all
    valid points across the bank (Chum & Matas, CVPR 2005).

    top-k ties only among the masked -1.0 slots, that is when fewer than
    `sample_size` points are allowed: such a pair has too few valid
    points and fails whatever the order."""
    B, H, M = noise.shape
    if conf is None:
        masked = torch.where(valid[:, None, :], noise, -1.0)
        return masked.topk(sample_size, dim=-1).indices

    rank_key = torch.where(valid, conf, -torch.inf)
    order = torch.argsort(-rank_key, dim=-1, stable=True)   # best first
    nvalid = valid.sum(-1)                                  # (B,)
    n_min = torch.clamp(nvalid, max=max(2 * sample_size, 10))
    frac = (torch.arange(H, dtype=torch.float32, device=noise.device)
            + 1.0) / H
    n_h = n_min[:, None] + (nvalid - n_min)[:, None] * frac ** 2   # (B, H)
    pos = torch.arange(M, dtype=torch.float32, device=noise.device)
    allowed = pos < n_h[..., None]
    sidx = torch.where(allowed, noise, -1.0).topk(sample_size,
                                                  dim=-1).indices
    return order.gather(1, sidx.flatten(1)).view(B, H, sample_size)


# ---------------------------------------------------------------------------
# Core RANSAC
# ---------------------------------------------------------------------------

# sigma ladder of the MAGSAC-like marginalized score: truncated-quadratic
# gains at several inlier scales, summed (Barath et al., CVPR 2019, as a
# fixed ladder instead of the gamma integral)
_SIGMA_LADDER = (0.25, 1.0, 4.0)


def _magsac_gain(errs2: torch.Tensor, thr2: torch.Tensor,
                 valid_f: torch.Tensor) -> torch.Tensor:
    """errs2: (..., M) squared residuals -> (...,) marginalized score."""
    g = 0.0
    for s in _SIGMA_LADDER:
        g = g + ((1.0 - errs2 / (thr2 * s)).clamp_min(0.0) * valid_f).sum(-1)
    return g


def _rows(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts (B, M, 2) at idx (B, H, k) -> (B, H, k, 2)."""
    B, H, k = idx.shape
    flat = idx.reshape(B, H * k, 1).expand(B, H * k, pts.shape[-1])
    return pts.gather(1, flat).view(B, H, k, pts.shape[-1])


@highp
def ransac(p0: torch.Tensor, p1: torch.Tensor, valid: torch.Tensor,
           threshold, *, model_kind: str = "essential",
           num_hypotheses: int = 1024, refine_rounds: int = 3,
           conf: torch.Tensor | None = None,
           noise: tuple[torch.Tensor, torch.Tensor] | None = None,
           generators: Sequence[torch.Generator] | None = None
           ) -> RansacResult:
    """Parallel-hypothesis RANSAC on B correspondence sets.

    p0/p1: (B, M, 2) points (normalized camera coords for 'essential',
    pixels for 'fundamental'/'homography'); valid: (B, M) mask;
    threshold: inlier threshold in input units (distance, not squared),
    a float or (B,); conf: optional (B, M) match confidences enabling
    PROSAC-progressive sampling. The uniforms: `noise`, the two banks
    ((B, H, M), (B, lo_hypotheses(H), M)), or else drawn from
    `generators`, one per pair (`draw_noise`).
    """
    if model_kind not in ("essential", "fundamental", "homography"):
        raise ValueError(f"unknown model_kind {model_kind!r}")
    B, M, _ = p0.shape
    dev = p0.device
    essential = model_kind == "essential"
    homog = model_kind == "homography"
    sample_size = 5 if essential else (4 if homog else 8)
    if not torch.is_tensor(threshold):
        threshold = torch.full((B,), float(threshold), device=dev)
    thr2 = threshold.float().expand(B) ** 2
    if noise is None:
        if generators is None or len(generators) != B:
            raise ValueError("ransac needs `noise` or one generator per pair")
        noise = draw_noise(generators, num_hypotheses, M, dev)
    noise1, noise2 = noise
    if (tuple(noise1.shape) != (B, num_hypotheses, M)
            or tuple(noise2.shape) != (B, lo_hypotheses(num_hypotheses), M)):
        raise ValueError(f"noise banks {tuple(noise1.shape)}, "
                         f"{tuple(noise2.shape)} do not fit B={B}, "
                         f"H={num_hypotheses}, M={M}")

    # condition the problem (Hartley): solve normalized, score original.
    # (The 5-point path solves directly in camera-normalized coords: a
    # similarity re-conditioning would not keep the essential manifold.)
    T0 = hartley_transform(p0, valid)
    T1 = hartley_transform(p1, valid)
    q0 = _apply_T(p0, T0)
    q1 = _apply_T(p1, T1)

    def denorm(Fhat):
        """Fhat (B, n, 3, 3) in the conditioned frame -> input frame."""
        if homog:
            H = _inv(T1)[:, None] @ Fhat @ T0[:, None]
            h22 = H[..., 2:3, 2:3]
            return H / torch.where(h22.abs() < 1e-12, 1e-12, h22)
        F = T1.transpose(-1, -2)[:, None] @ Fhat @ T0[:, None]
        return project_essential(F) if essential else project_fundamental(F)

    p0h = to_homogeneous(p0)[:, None]                 # (B, 1, M, 3)
    p1h = to_homogeneous(p1)[:, None]

    def residuals(model):
        """model (B, n, 3, 3) -> (B, n, M)."""
        if homog:
            return homography_transfer_error(p0[:, None], p1[:, None], model)
        return sampson_distance(p0h, p1h, model)

    valid_f = valid.float()[:, None, :]               # (B, 1, M)
    thr2_b = thr2[:, None, None]

    def hypothesize_and_score(bank, sample_conf):
        """Minimal sets from `bank`, solved and scored in chunks of CHUNK
        models. Returns (best_gain (B,), best_model (B, 3, 3)); the first
        maximum wins, as the JAX package's per-chunk argmax does."""
        idx = _sample_minimal(bank, valid, sample_size, sample_conf)
        if essential:
            cand, cand_valid = essential_candidates(_rows(p0, idx),
                                                    _rows(p1, idx))
            models = cand.flatten(1, 2)               # (B, H*10, 3, 3)
            mvalid = cand_valid.flatten(1)
        else:
            s0, s1 = _rows(q0, idx), _rows(q1, idx)   # (B, H, k, 2)
            ones = torch.ones(idx.shape, device=dev)
            solve = solve_homography_raw if homog else solve_epipolar_raw
            models = denorm(solve(s0, s1, ones))
            mvalid = torch.ones(models.shape[:2], dtype=torch.bool,
                                device=dev)
        gains = []
        for c0 in range(0, models.shape[1], CHUNK):
            errs = residuals(models[:, c0:c0 + CHUNK])
            gains.append(_magsac_gain(errs, thr2_b, valid_f))
            del errs
        gain = torch.where(mvalid, torch.cat(gains, 1), -torch.inf)
        i = gain.argmax(1)                            # (B,)
        best = models.gather(1, i[:, None, None, None].expand(B, 1, 3, 3))
        return gain.gather(1, i[:, None])[:, 0], best[:, 0]

    best_gain, best_model = hypothesize_and_score(noise1, conf)

    # LO resampling round: fresh minimal samples preferentially from the
    # best model's (loose) inlier set (Chum, Matas & Kittler, 2003)
    e_best = residuals(best_model[:, None])[:, 0]     # (B, M)
    loose_in = ((e_best < 4.0 * thr2[:, None]) & valid).float()
    gain2, model2 = hypothesize_and_score(noise2, loose_in)
    better = gain2 > best_gain
    best_model = torch.where(better[:, None, None], model2, best_model)
    best_gain = torch.where(better, gain2, best_gain)

    # local optimization: IRLS refits on the inliers, each kept only if
    # it does not lower the marginalized gain
    solve = solve_homography_raw if homog else solve_epipolar_raw
    for _ in range(refine_rounds):
        e = residuals(best_model[:, None])[:, 0]
        w = torch.where((e < thr2[:, None]) & valid,
                        1.0 / torch.maximum(e, 1e-10 * thr2[:, None]), 0.0)
        w = w.clamp_max(1e6)
        w = w / w.amax(-1, keepdim=True).clamp_min(1e-12)
        enough = (w > 0).sum(-1) >= sample_size
        new = denorm(solve(q0, q1, w)[:, None])       # (B, 1, 3, 3)
        new_gain = _magsac_gain(residuals(new), thr2_b, valid_f)[:, 0]
        accept = enough & (new_gain >= best_gain)
        best_model = torch.where(accept[:, None, None], new[:, 0], best_model)
        best_gain = torch.where(accept, new_gain, best_gain)

    final_err = residuals(best_model[:, None])[:, 0]
    inliers = (final_err < thr2[:, None]) & valid
    n = inliers.sum(-1).int()
    success = (valid.sum(-1) >= sample_size) & (n >= sample_size)
    return RansacResult(best_model, inliers, n, success)


# ---------------------------------------------------------------------------
# Essential decomposition + cheirality (cv2.recoverPose equivalent)
# ---------------------------------------------------------------------------

@highp
def triangulate_depths(p0: torch.Tensor, p1: torch.Tensor, R: torch.Tensor,
                       t: torch.Tensor):
    """Two-view depths by least squares on z0*R x0 + t = z1*x1.

    p0/p1: (..., M, 2) normalized coords; R (..., 3, 3), t (..., 3).
    Returns (z0, z1) each (..., M): closed-form 2x2 normal equations."""
    x0 = to_homogeneous(p0)
    x1 = to_homogeneous(p1)
    Rx0 = x0 @ R.transpose(-1, -2)
    t = t[..., None, :]
    # minimize || z0 * Rx0 - z1 * x1 + t ||^2 over (z0, z1)
    a = (Rx0 * Rx0).sum(-1)
    b = -(Rx0 * x1).sum(-1)
    c = (x1 * x1).sum(-1)
    rhs0 = -(Rx0 * t).sum(-1)
    rhs1 = (x1 * t).sum(-1)
    det = a * c - b * b
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    return (c * rhs0 - b * rhs1) / det, (a * rhs1 - b * rhs0) / det


_W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
              np.float32)


@highp
def decompose_essential(E: torch.Tensor):
    """E (..., 3, 3) -> (R1, R2, t): the two rotations and the
    translation direction. Singular vectors' signs are not fixed; the
    determinant corrections make both factors proper rotations, as the
    JAX package's do."""
    u, _, vt = _svd(E)
    u = u * torch.sign(_det3(u))[..., None, None]
    vt = vt * torch.sign(_det3(vt))[..., None, None]
    W = device_constant("ransac.W", _W, u.device)
    return u @ W @ vt, u @ W.T @ vt, u[..., :, 2]


@highp
def recover_pose(E: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
                 weights: torch.Tensor, max_depth: float = 1e9):
    """The (R, t) with the most points in front of both cameras
    (cv2.recoverPose semantics). E (B, 3, 3); p0/p1: (B, M, 2)
    normalized; weights: (B, M) float mask (inliers).
    Returns (R (B, 3, 3), t (B, 3), num_good (B,), good_mask (B, M))."""
    R1, R2, t = decompose_essential(E)
    Rs = torch.stack([R1, R1, R2, R2], 1)             # (B, 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], 1)               # (B, 4, 3)
    z0, z1 = triangulate_depths(p0[:, None], p1[:, None], Rs, ts)
    ok = (z0 > 0) & (z1 > 0) & (z0 < max_depth) & (z1 < max_depth)
    counts = (ok * weights[:, None]).sum(-1)          # (B, 4)
    best = counts.argmax(1)                           # first maximum
    B = E.shape[0]
    ar = torch.arange(B, device=E.device)
    return Rs[ar, best], ts[ar, best], counts[ar, best], ok[ar, best]
