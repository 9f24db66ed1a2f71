"""Triangulation from known poses (port of `gim_tpu/hloc/triangulation.py`;
ref hloc/triangulation.py:35-239).

Given a reference reconstruction with known camera poses, import our
features/matches into a COLMAP database, geometrically verify each pair
against the KNOWN two-view geometry (epipolar distance on the device, the
replacement for pycolmap.verify_matches' host RANSAC), then triangulate
3D points: feature tracks are built by union-find on the host and every
track's multi-view DLT is solved as one batched SVD on the device (the
JAX package's fallback, which it takes with or without pycolmap: its
bridge to pycolmap's triangulation is not wired).

The reference model can be a pycolmap.Reconstruction or a COLMAP
text-format directory (cameras.txt / images.txt), so the path works in
environments without pycolmap. The text I/O, the database import and the
union-find are host code, copied.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from os.path import join

import numpy as np
import torch

from gim_tpu_torch.utils.device import resolve_device
from gim_tpu_torch.utils.precision import highp


# ---------------------------------------------------------------------------
# COLMAP text model reading (cameras.txt / images.txt)
# ---------------------------------------------------------------------------

@dataclass
class Camera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def K(self) -> np.ndarray:
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
            f, cx, cy = p[0], p[1], p[2]
            return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
        if self.model in ("PINHOLE", "OPENCV"):
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
            return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        raise ValueError(f"unsupported camera model {self.model}")


@dataclass
class Image:
    image_id: int
    qvec: np.ndarray     # (4,) w x y z
    tvec: np.ndarray     # (3,)
    camera_id: int
    name: str

    def R(self) -> np.ndarray:
        return qvec_to_rotmat(self.qvec)


@dataclass
class TextModel:
    cameras: dict = field(default_factory=dict)
    images: dict = field(default_factory=dict)   # by image_id


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def read_text_model(model_dir: str) -> TextModel:
    m = TextModel()
    with open(join(model_dir, "cameras.txt")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            x = line.split()
            m.cameras[int(x[0])] = Camera(
                int(x[0]), x[1], int(x[2]), int(x[3]),
                np.array(list(map(float, x[4:]))))
    with open(join(model_dir, "images.txt")) as f:
        lines = [l for l in f if not l.startswith("#") and l.strip()]
    # images.txt alternates pose line / 2D-points line, but the points
    # line may be empty (stripped above) — detect pose lines by shape:
    # IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME, where NAME is the
    # only non-numeric token (points lines are all floats).
    for line in lines:
        x = line.split()
        try:
            float(x[-1])
            continue                       # 2D-points line
        except ValueError:
            pass
        img = Image(int(x[0]), np.array(list(map(float, x[1:5]))),
                    np.array(list(map(float, x[5:8]))), int(x[8]), x[9])
        m.images[img.image_id] = img
    return m


def write_points3d_text(path: str, xyz: np.ndarray, rgb=None, errs=None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
        for i, p in enumerate(xyz):
            c = (rgb[i] if rgb is not None else (128, 128, 128))
            e = errs[i] if errs is not None else 0.0
            f.write(f"{i + 1} {p[0]} {p[1]} {p[2]} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])} {e}\n")


# ---------------------------------------------------------------------------
# DB from model + known-pose geometric verification
# ---------------------------------------------------------------------------

# COLMAP camera model ids (src/colmap/sensor/models.h)
CAMERA_MODEL_IDS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2,
                    "RADIAL": 3, "OPENCV": 4}


def create_db_from_model(model: TextModel, db_path: str) -> dict[str, int]:
    """ref hloc/triangulation.py:35-55 — empty db carrying the reference
    model's cameras/images so COLMAP ids line up."""
    from gim_tpu_torch.hloc.database import ColmapDB

    if os.path.exists(db_path):
        os.remove(db_path)
    db = ColmapDB(db_path)
    for cid, cam in model.cameras.items():
        db.add_camera(CAMERA_MODEL_IDS[cam.model], cam.width, cam.height,
                      cam.params, camera_id=cid, prior_focal=True)
    for iid, img in model.images.items():
        db.add_image(img.name, img.camera_id, image_id=iid)
    db.commit()
    db.close()
    return {img.name: iid for iid, img in model.images.items()}


def relative_pose(img0: Image, img1: Image):
    """T_0to1 from two world-to-camera poses."""
    R0, t0 = img0.R(), img0.tvec
    R1, t1 = img1.R(), img1.tvec
    R = R1 @ R0.T
    t = t1 - R @ t0
    return R, t


def verify_matches_known_poses(model: TextModel, name_to_id: dict,
                               kpts: dict, pairs: list, matches: dict,
                               max_error: float = 4.0,
                               device="cuda") -> dict:
    """Epipolar verification on `device` against the KNOWN two-view
    geometry (ref triangulation.py:114-178 geometric_verification,
    max_error 4.0). Returns {pair: inlier mask}."""
    from gim_tpu_torch.geometry.epipolar import (
        cross_product_matrix, symmetric_epipolar_distance)

    dev = resolve_device(device)
    id_to_img = {i: img for i, img in model.images.items()}
    out = {}
    for (n0, n1) in pairs:
        key = (n0, n1)
        m = matches.get(key)
        if m is None or len(m) == 0:
            out[key] = np.zeros(0, bool)
            continue
        img0 = id_to_img[name_to_id[n0]]
        img1 = id_to_img[name_to_id[n1]]
        cam0 = model.cameras[img0.camera_id]
        cam1 = model.cameras[img1.camera_id]
        R, t = relative_pose(img0, img1)
        # [t]x in float32, as the JAX package builds it
        E = cross_product_matrix(torch.from_numpy(
            t.astype(np.float32))).numpy().astype(np.float64) @ R
        p0 = kpts[n0][m[:, 0]]
        p1 = kpts[n1][m[:, 1]]

        def put(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)[None]

        d = symmetric_epipolar_distance(put(p0), put(p1), put(E),
                                        put(cam0.K()), put(cam1.K()))
        d = d[0].cpu().numpy()
        # squared normalized-coord distance -> pixel-ish threshold via
        # mean focal (same normalization the eval metrics use)
        f = (cam0.K()[0, 0] + cam1.K()[1, 1]) / 2
        out[key] = d < (max_error / f) ** 2
    return out


# ---------------------------------------------------------------------------
# triangulation fallback: tracks (host union-find) + batched DLT on the device
# ---------------------------------------------------------------------------

class _UF:
    def __init__(self):
        self.p = {}

    def find(self, x):
        self.p.setdefault(x, x)
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


def build_tracks(pairs: list, matches: dict, inliers: dict,
                 min_track_len: int = 2) -> list[list]:
    """Union-find over verified matches -> tracks of (name, kpt_idx)."""
    uf = _UF()
    for key in pairs:
        m = matches.get(key)
        if m is None:
            continue
        inl = inliers.get(key)
        for r, (i, j) in enumerate(m):
            if inl is not None and len(inl) and not inl[r]:
                continue
            uf.union((key[0], int(i)), (key[1], int(j)))
    groups: dict = {}
    for node in list(uf.p):
        groups.setdefault(uf.find(node), []).append(node)
    # drop tracks observing one image twice (merged ambiguities)
    tracks = []
    for g in groups.values():
        names = [n for n, _ in g]
        if len(g) >= min_track_len and len(set(names)) == len(names):
            tracks.append(sorted(g))
    return tracks


def triangulate_tracks(model: TextModel, name_to_id: dict, kpts: dict,
                       tracks: list, max_obs: int = 8,
                       max_reproj_px: float = 4.0, device="cuda",
                       dtype: torch.dtype = torch.float32):
    """Batched multi-view DLT: every track becomes a (2*max_obs, 4)
    homogeneous system solved by one batched SVD on `device` (in `dtype`,
    float32 as in the JAX package); points failing the reprojection /
    cheirality check are masked.

    Returns (xyz (T, 3), valid (T,), mean reprojection error (T,))."""
    id_to_img = {i: img for i, img in model.images.items()}
    T = len(tracks)
    if T == 0:
        return (np.zeros((0, 3)), np.zeros(0, bool), np.zeros(0))
    A = np.zeros((T, 2 * max_obs, 4), np.float32)
    P_all = np.zeros((T, max_obs, 3, 4), np.float32)
    uv_all = np.zeros((T, max_obs, 2), np.float32)
    w_obs = np.zeros((T, max_obs), np.float32)
    for ti, track in enumerate(tracks):
        for oi, (name, ki) in enumerate(track[:max_obs]):
            img = id_to_img[name_to_id[name]]
            cam = model.cameras[img.camera_id]
            P = cam.K() @ np.concatenate(
                [img.R(), img.tvec[:, None]], axis=1)
            u, v = kpts[name][ki]
            A[ti, 2 * oi] = u * P[2] - P[0]
            A[ti, 2 * oi + 1] = v * P[2] - P[1]
            P_all[ti, oi] = P
            uv_all[ti, oi] = (u, v)
            w_obs[ti, oi] = 1.0
    dev = resolve_device(device)
    xyz, ok, err = _solve_tracks(*(torch.from_numpy(a).to(dev, dtype)
                                   for a in (A, P_all, uv_all, w_obs)),
                                 max_reproj_px)
    return xyz.cpu().numpy(), ok.cpu().numpy(), err.cpu().numpy()


@highp
def _solve_tracks(A, P_all, uv_all, w_obs, max_reproj_px: float):
    _, _, vt = torch.linalg.svd(A, full_matrices=False)
    X = vt[:, -1, :]                                   # (T, 4)
    X = X / torch.where(X[:, 3:].abs() < 1e-12, 1e-12, X[:, 3:])
    proj = torch.einsum("toij,tj->toi", P_all, X)      # (T, O, 3)
    z = proj[..., 2]
    uv = proj[..., :2] / torch.where(z[..., None].abs() < 1e-12, 1e-12,
                                     z[..., None])
    err = torch.linalg.vector_norm(uv - uv_all, dim=-1)
    n = w_obs.sum(-1).clamp_min(1.0)
    mean_err = (err * w_obs).sum(-1) / n
    cheir = ((z > 0) | (w_obs == 0)).all(-1)
    ok = cheir & (mean_err < max_reproj_px) & torch.isfinite(X).all(-1)
    return X[:, :3], ok, mean_err


def main(sfm_dir: str, reference_model_dir: str, image_dir: str,
         pairs: list, kpts: dict, matches: dict,
         max_error: float = 4.0, device="cuda"):
    """End-to-end triangulation with known poses (ref
    triangulation.py:200-236): db from model, import features/matches,
    verify against known geometry, triangulate (the batched DLT on
    `device`). Returns (xyz, valid, errs)."""
    from gim_tpu_torch.hloc.database import ColmapDB

    os.makedirs(sfm_dir, exist_ok=True)
    model = read_text_model(reference_model_dir)
    db_path = join(sfm_dir, "database.db")
    name_to_id = create_db_from_model(model, db_path)

    db = ColmapDB(db_path)
    for name, iid in name_to_id.items():
        db.add_keypoints(iid, kpts[name] + 0.5)       # COLMAP origin
    inliers = verify_matches_known_poses(model, name_to_id, kpts, pairs,
                                         matches, max_error, device)
    for key in pairs:
        m = matches.get(key)
        if m is None or len(m) == 0:
            continue
        inl = inliers[key]
        db.add_matches(name_to_id[key[0]], name_to_id[key[1]], m)
        db.add_two_view_geometry(name_to_id[key[0]], name_to_id[key[1]],
                                 m[inl])
    db.commit()
    db.close()

    # the JAX function imports pycolmap where present, then falls back all
    # the same (its text-model -> pycolmap bridge is not wired): both
    # packages always triangulate here
    tracks = build_tracks(pairs, matches, inliers)
    xyz, ok, errs = triangulate_tracks(model, name_to_id, kpts, tracks,
                                       device=device)
    write_points3d_text(join(sfm_dir, "points3D.txt"),
                        xyz[ok], errs=errs[ok])
    return xyz, ok, errs
