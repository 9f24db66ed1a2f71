"""Pose estimation and error metrics (port of `gim_tpu/geometry/pose.py`).

Ports of the reference's tools/metrics.py:11-29 (relative_pose_error),
:77-103 (estimate_pose, here batched over pairs on the device), :171-214
(error_auc / aggregate_metrics) and analysis.py:34-53 (trapezoid AUC);
the host-side aggregation is numpy, copied as it is.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from benchmark.reference.frozen.epipolar import normalize_points
from benchmark.reference.frozen.ransac import ransac, recover_pose
from benchmark.reference.frozen.precision import highp


@highp
def estimate_pose(kpts0: torch.Tensor, kpts1: torch.Tensor,
                  valid: torch.Tensor, K0: torch.Tensor, K1: torch.Tensor,
                  thresh: float = 0.5, num_hypotheses: int = 1024,
                  conf: torch.Tensor | None = None,
                  noise: tuple[torch.Tensor, torch.Tensor] | None = None,
                  generators: Sequence[torch.Generator] | None = None):
    """5-point Nister essential RANSAC + recoverPose cheirality over B
    pairs (the reference's tools/metrics.py:77-103).

    kpts: (B, M, 2) pixels with (B, M) validity; K: (B, 3, 3); conf:
    optional match confidences (PROSAC-ordered sampling); noise /
    generators: RANSAC's uniforms (`geometry/ransac.ransac`). Returns a
    dict of R (B, 3, 3), t (B, 3), inliers (B, M), num_inliers (B,),
    success (B,). The threshold is `thresh` pixels over the mean focal
    (f0x + f1y) / 2."""
    p0 = normalize_points(kpts0, K0)
    p1 = normalize_points(kpts1, K1)
    f_mean = (K0[:, 0, 0] + K1[:, 1, 1]) / 2.0
    res = ransac(p0, p1, valid, thresh / f_mean, model_kind="essential",
                 num_hypotheses=num_hypotheses, conf=conf, noise=noise,
                 generators=generators)
    R, t, n_good, good = recover_pose(res.model, p0, p1, res.inliers.float())
    enough = valid.sum(-1) >= 5
    success = res.success & enough & (n_good > 0)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    R = torch.where(success[:, None, None], R, eye)
    t = torch.where(success[:, None], t, 0.0)
    return {"R": R, "t": t, "inliers": res.inliers & good,
            "num_inliers": res.num_inliers, "success": success}


def relative_pose_error(T_0to1: torch.Tensor, R: torch.Tensor,
                        t: torch.Tensor, ignore_gt_t_thr: float = 0.0):
    """Angular translation / rotation errors + scaled translation L2
    (the reference's tools/metrics.py:11-29). Batched over leading dims."""
    t_gt = T_0to1[..., :3, 3]
    R_gt = T_0to1[..., :3, :3]
    nt = torch.linalg.vector_norm(t, dim=-1)
    ngt = torch.linalg.vector_norm(t_gt, dim=-1)
    cos_t = ((t * t_gt).sum(-1) / (nt * ngt).clamp_min(1e-12)).clamp(-1.0,
                                                                    1.0)
    t_err = torch.rad2deg(torch.arccos(cos_t))
    t_err = torch.minimum(t_err, 180.0 - t_err)    # E-sign ambiguity
    t_err = torch.where(ngt < ignore_gt_t_thr, 0.0, t_err)

    r = ngt / nt.clamp_min(1e-12)
    t_err2 = torch.linalg.vector_norm(t * r[..., None] - t_gt, dim=-1)

    cos_r = ((R * R_gt).sum((-1, -2)) - 1.0) / 2.0
    r_err = torch.rad2deg(torch.arccos(cos_r.clamp(-1.0, 1.0)).abs())
    return t_err, r_err, t_err2


# ---------------------------------------------------------------------------
# Host-side aggregation (numpy; tiny)
# ---------------------------------------------------------------------------

def error_auc_ratio(errs, thresholds=(5, 10, 20)):
    """Pass-ratio "AUC" used by the in-run aggregate
    (ref tools/metrics.py:171-176)."""
    errs = np.asarray(errs, dtype=np.float64)
    return {f"AUC@{t}": float(np.sum(errs < t) / max(len(errs), 1))
            for t in thresholds}


def error_auc_trapezoid(r_errs, t_errs, thresholds=(5.0,)):
    """Offline trapezoid AUC over max(R_err, t_err), NaN/inf -> 180
    (ref analysis.py:34-53)."""
    r = np.asarray(r_errs, dtype=np.float64).copy()
    t = np.asarray(t_errs, dtype=np.float64).copy()
    r[~np.isfinite(r)] = 180.0
    t[~np.isfinite(t)] = 180.0
    errors = np.max(np.stack([r, t]), axis=0)
    errors = [0.0] + sorted(errors.tolist())
    recall = list(np.linspace(0, 1, len(errors)))
    out = {}
    for thr in thresholds:
        last = np.searchsorted(errors, thr)
        y = recall[:last] + [recall[last - 1]]
        x = errors[:last] + [thr]
        out[f"auc@{thr}"] = float(np.trapezoid(y, x) / thr)
    return out


def epidist_prec(errors, thresholds, ret_dict=False):
    """Mean matching precision at epipolar thresholds
    (ref tools/metrics.py:179-190)."""
    precs = []
    for thr in thresholds:
        per_pair = [np.mean(np.asarray(e) < thr) if len(e) > 0 else 0
                    for e in errors]
        precs.append(np.mean(per_pair) if len(per_pair) > 0 else 0)
    if ret_dict:
        return {f"Prec@{t:.0e}": p for t, p in zip(thresholds, precs)}
    return precs


def aggregate_metrics(metrics: dict, epi_err_thr: float = 5e-4,
                      test: bool = False) -> dict:
    """Dataset-level aggregation with identifier dedup
    (ref tools/metrics.py:193-214)."""
    seen = {}
    for i, iden in enumerate(metrics["identifiers"]):
        seen.setdefault(iden, i)
    unq = list(seen.values())

    pose_errors = np.max(np.stack([np.asarray(metrics["R_errs"]),
                                   np.asarray(metrics["t_errs"])]), axis=0)[unq]
    aucs = error_auc_ratio(pose_errors, (5, 10, 20))
    errs = [metrics["epi_errs"][i] for i in unq]
    precs = epidist_prec(errs, [epi_err_thr], True)
    out = {**aucs, **precs}
    if test:
        out["Num"] = len(unq)
    return out
