"""The reference's ZEB rows, and their judge.

A row holds, for one pair, the symmetric epipolar error of each valid
match under the ground-truth pose and the rotation and translation
errors of the pose that RANSAC found. The reference solves the pose from
the port's matches (judged on their own by the configuration's
reference) with the frozen copy of the port's RANSAC (PROSAC sampling,
5-point, MAGSAC scoring, LO and IRLS refits, recoverPose) at the
configuration's precision, float32 with TF32 off, and the same uniforms,
drawn from one device generator per pair seeded from the pair's
identifier as `eval/zeb` seeds it.

RANSAC's search on random-weight matches has near-ties, so a pose is
only reproduced by the same float32 arithmetic: a run in float64, or in
TF32, ends tens of degrees away. The frozen copy runs the port's float32
operations in the port's order, so a sound port reads about 0 against
it; the TF32 control does not.

Read (all "lower is better"):

- `epi_gap`: the largest |row - reference| / (reference + 1e-4) of the
  epipolar errors of a batch's valid matches (squared distances in
  normalized coordinates, read against the 5e-4 threshold), the
  reference's in float64;
- `row_gap`: the largest gap between the cosines of a row's rotation or
  translation error and of the errors, in float64, of the reference's
  pose (cosines, since an angle near 0 read through float32's arccos
  carries 0.02 degrees of rounding; both infinite, a failed pose, reads
  0; one infinite reads infinity);
- `gain_deficit`: the largest (G_ref - G_port) / G_ref over the batch, G
  the MAGSAC gain in float64 of a pose on the port's matches (a failed
  pose scores 0);
- `rows_missing`: the pairs of the batch without a row (the harness).

The control computes its rows and pose in float32 with TF32 on.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from benchmark.reference.frozen.epipolar import (cross_product_matrix,
                                                 essential_from_pose,
                                                 normalize_points,
                                                 sampson_distance,
                                                 symmetric_epipolar_distance,
                                                 to_homogeneous)
from benchmark.reference.frozen.pose import estimate_pose
from benchmark.reference.frozen.precision import tf32_everywhere
from benchmark.reference.frozen.ransac import _magsac_gain

EPI_FLOOR = 1e-4
RANSAC_ZOO = {"MAGSAC": (2048, True), "RANSAC": (2048, False)}
THRESH_PX = 0.5


def seed_of(identifier: str) -> int:
    """The pair's generator seed: its identifier's 8-byte blake2s digest
    as one little-endian integer (`eval/zeb.identifier_key`, `seed_of`)."""
    d = hashlib.blake2s(identifier.encode(), digest_size=8).digest()
    k = np.frombuffer(d, dtype=np.uint32)
    return int(k[0]) | (int(k[1]) << 32)


def _put(x, device, dtype):
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x)).to(
        device, dtype)


def pose_errors(T, R, t):
    """Rotation and translation errors in degrees of poses (R, t) against
    T, as products (`relative_pose_error`'s definitions)."""
    R_gt, t_gt = T[..., :3, :3], T[..., :3, 3]
    cos_r = ((R_gt.transpose(-1, -2) @ R).diagonal(dim1=-2, dim2=-1)
             .sum(-1) - 1.0) / 2.0
    r_err = torch.rad2deg(torch.arccos(cos_r.clamp(-1.0, 1.0)))
    dot = (t[..., None, :] @ t_gt[..., :, None])[..., 0, 0]
    cos_t = dot / (torch.linalg.vector_norm(t, dim=-1)
                   * torch.linalg.vector_norm(t_gt, dim=-1)).clamp_min(1e-12)
    t_err = torch.rad2deg(torch.arccos(cos_t.clamp(-1.0, 1.0)))
    return torch.minimum(t_err, 180.0 - t_err), r_err


def solve(b: dict, m: dict, device, dtype=torch.float32,
          preset: str = "MAGSAC") -> dict:
    """A batch's rows and poses from matches `m` (kpts0, kpts1, conf,
    valid), computed in `dtype`."""
    n_hyp, use_conf = RANSAC_ZOO[preset]
    k0, k1 = _put(m["kpts0"], device, dtype), _put(m["kpts1"], device, dtype)
    valid = _put(m["valid"], device, torch.bool)
    conf = _put(m["conf"], device, dtype) if use_conf else None
    K0, K1 = _put(b["K0"], device, dtype), _put(b["K1"], device, dtype)
    T = _put(b["T_0to1"], device, dtype)
    with torch.no_grad():
        epi = symmetric_epipolar_distance(k0, k1, essential_from_pose(T),
                                          K0, K1)
        gens = [torch.Generator(device).manual_seed(seed_of(i))
                for i in b["identifier"]]
        pose = estimate_pose(k0, k1, valid, K0, K1, THRESH_PX, n_hyp,
                             conf=conf, generators=gens)
        t_err, r_err = pose_errors(T, pose["R"], pose["t"])
    ok = pose["success"]
    r_err = torch.where(ok, r_err, math.inf)
    t_err = torch.where(ok, t_err, math.inf)
    v = valid.cpu().numpy()
    rows = [{"identifier": b["identifier"][i],
             "epi_errs": epi[i].cpu().numpy()[v[i]],
             "R_errs": float(r_err[i]), "t_errs": float(t_err[i])}
            for i in range(k0.shape[0])]
    return {"rows": rows, "pose": {"R": pose["R"], "t": pose["t"],
                                   "success": ok}}


def control(b: dict, m: dict, device) -> dict:
    """The control's rows and poses: `solve` in float32 with TF32 on."""
    with tf32_everywhere():
        return solve(b, m, device, torch.float32)


def gains(b: dict, m: dict, pose: dict, device) -> torch.Tensor:
    """(B,) MAGSAC gain in float64 of each pose on the matches `m`, 0
    where the pose failed."""
    dt = torch.float64
    k0, k1 = _put(m["kpts0"], device, dt), _put(m["kpts1"], device, dt)
    valid = _put(m["valid"], device, torch.bool)
    K0, K1 = _put(b["K0"], device, dt), _put(b["K1"], device, dt)
    R, t = _put(pose["R"], device, dt), _put(pose["t"], device, dt)
    E = cross_product_matrix(t) @ R
    p0 = to_homogeneous(normalize_points(k0, K0))
    p1 = to_homogeneous(normalize_points(k1, K1))
    f_mean = (K0[:, 0, 0] + K1[:, 1, 1]) / 2.0
    thr2 = (THRESH_PX / f_mean)[:, None, None] ** 2
    err = sampson_distance(p0[:, None], p1[:, None], E[:, None])
    g = _magsac_gain(err, thr2, valid.to(dt)[:, None])[:, 0]
    return torch.where(_put(pose["success"], device, torch.bool), g, 0.0)


def _cos_gap(a: float, b: float) -> float:
    """|cos a - cos b| of two angles in degrees (both infinite: 0)."""
    if math.isinf(a) or math.isinf(b):
        return 0.0 if math.isinf(a) and math.isinf(b) else math.inf
    return abs(math.cos(math.radians(a)) - math.cos(math.radians(b)))


def judge(b: dict, got: dict, zeb: list[dict], device) -> dict:
    """`zeb`: the port's rows of batch `b`; `got`: its matches and, under
    `pose`, the pose its RANSAC found."""
    dt = torch.float64
    T = _put(b["T_0to1"], device, dt)
    with torch.no_grad():
        epi = symmetric_epipolar_distance(
            _put(got["kpts0"], device, dt), _put(got["kpts1"], device, dt),
            essential_from_pose(T), _put(b["K0"], device, dt),
            _put(b["K1"], device, dt)).cpu().numpy()
    ref = solve(b, got, device)["pose"]
    t_err, r_err = pose_errors(T, _put(ref["R"], device, dt),
                               _put(ref["t"], device, dt))
    r_err = torch.where(ref["success"], r_err, math.inf).tolist()
    t_err = torch.where(ref["success"], t_err, math.inf).tolist()
    g_port = gains(b, got, got["pose"], device).tolist()
    g_ref = gains(b, got, ref, device).tolist()
    valid = np.asarray(torch.as_tensor(got["valid"]).cpu())
    by_id = {r["identifier"]: r for r in zeb}
    epi_gap = row = deficit = 0.0
    for i, ident in enumerate(b["identifier"]):
        g = by_id.get(ident)
        if g is None:
            continue
        want = epi[i][valid[i]]
        if len(g["epi_errs"]) != len(want):
            epi_gap = math.inf
        elif len(want):
            gap = (np.abs(np.asarray(g["epi_errs"], np.float64) - want)
                   / (np.abs(want) + EPI_FLOOR))
            epi_gap = max(epi_gap, float(gap.max()))
        row = max(row, _cos_gap(g["R_errs"], r_err[i]),
                  _cos_gap(g["t_errs"], t_err[i]))
        if g_ref[i] > 0:
            deficit = max(deficit, (g_ref[i] - g_port[i]) / g_ref[i])
    return {"epi_gap": epi_gap, "row_gap": row, "gain_deficit": deficit}
