"""Native incremental SfM mapper, the pycolmap-free fallback (port of
`gim_tpu/hloc/mapper.py`).

Fills the role of the reference's `pycolmap.incremental_mapping` call
(ref hloc/reconstruction.py:61-100): read the COLMAP database that
`hloc/reconstruction.build_database` wrote, register images
incrementally, and emit a COLMAP text model. Where COLMAP is sequential
host C++, the solvers are batched device computations:

- two-view init: the 5-point essential RANSAC (`geometry/ransac.py`) via
  `geometry/pose.estimate_pose`;
- registration: PnP RANSAC as a bank of 6-point DLT hypotheses solved in
  one batched (H, 12, 12) eigendecomposition, then five damped
  Gauss-Newton steps on se(3);
- triangulation: batched multi-view DLT on the host in float64, as in the
  JAX package;
- bundle adjustment: resection-intersection, alternating batched
  per-camera 6x6 and per-point 3x3 damped Gauss-Newton solves assembled
  by segment sums over the observation list.

The mapper itself is a host loop around these device calls. One
difference from the JAX package changes results: PnP's nullspace vectors
get the sign that makes the rotation block's determinant non-negative
(`pnp_ransac_device`). JAX keeps the sign its eigensolver returns, so
about half of its hypotheses are reflections that score near zero, and
which ones depends on the solver; here every hypothesis is a proper
rotation and can score. The other differences do not change the math:
- JAX's draws come from threefry keys. Here the init's RANSAC draws from
  a generator seeded `seed` on the device, and every PnP bank's (H, 6)
  row indices from one generator seeded `seed + 1`, drawn in turn
  (`pnp_ransac_device` takes the indices as an argument);
- the segment sums add each destination's rows in their order in the
  observation list (`ops/sampling.OrderedSegments`), not with atomics,
  so two runs give the same model bit for bit;
- no power-of-two padding of points, observations and cameras: it exists
  in JAX so that XLA compiles once per bucket, and padded rows carry
  weight 0;
- the small solves take `torch.linalg.solve_ex`, which does not read
  the device to check the result (a singular system gives non-finite
  values, as in JAX).
"""

from __future__ import annotations

import os
import sqlite3
from os.path import join

import numpy as np
import torch

from gim_tpu_torch.geometry.epipolar import cross_product_matrix
from gim_tpu_torch.hloc.database import MAX_IMAGE_ID
from gim_tpu_torch.ops.sampling import OrderedSegments
from gim_tpu_torch.utils.device import resolve_device
from gim_tpu_torch.utils.precision import highp
from gim_tpu_torch.utils.profiling import StageTimer


# ---------------------------------------------------------------------------
# database reading (inverse of hloc/database.py writers)
# ---------------------------------------------------------------------------

def read_database(db_path: str):
    """Return (cameras, images, kpts, pairs) from a COLMAP sqlite db.

    cameras: {camera_id: dict(model, width, height, params)}
    images:  {name: dict(image_id, camera_id)}
    kpts:    {name: (N, 2) float32 pixel coords (COLMAP +0.5 removed)}
    pairs:   {(name0, name1): (M, 2) uint32 verified match indices}
             (from two_view_geometries; falls back to raw matches rows)
    """
    con = sqlite3.connect(db_path)
    cameras = {}
    for cid, model, w, h, params in con.execute(
            "SELECT camera_id, model, width, height, params FROM cameras"):
        cameras[cid] = {"model": model, "width": w, "height": h,
                        "params": np.frombuffer(params, np.float64).copy()}
    images, id_to_name = {}, {}
    for iid, name, cid in con.execute(
            "SELECT image_id, name, camera_id FROM images"):
        images[name] = {"image_id": iid, "camera_id": cid}
        id_to_name[iid] = name
    kpts = {}
    for iid, rows, cols, data in con.execute(
            "SELECT image_id, rows, cols, data FROM keypoints"):
        arr = np.frombuffer(data, np.float32).reshape(rows, cols)
        kpts[id_to_name[iid]] = arr[:, :2] - 0.5
    pairs = {}
    table_rows = list(con.execute(
        "SELECT pair_id, rows, data FROM two_view_geometries"))
    if not table_rows:
        table_rows = list(con.execute(
            "SELECT pair_id, rows, data FROM matches"))
    for pair_id, rows, data in table_rows:
        if rows == 0 or data is None:
            continue
        i1, i2 = divmod(pair_id, MAX_IMAGE_ID)
        m = np.frombuffer(data, np.uint32).reshape(rows, 2)
        pairs[(id_to_name[i1], id_to_name[i2])] = m.copy()
    con.close()
    return cameras, images, kpts, pairs


def camera_K(cam: dict) -> np.ndarray:
    """Intrinsics from the COLMAP camera models build_database emits
    (SIMPLE_PINHOLE=0, PINHOLE=1, SIMPLE_RADIAL=2; distortion ignored —
    the db writer sets k=0)."""
    p = cam["params"]
    if cam["model"] == 1:                       # PINHOLE fx fy cx cy
        fx, fy, cx, cy = p[:4]
    else:                                       # f cx cy [k]
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


# ---------------------------------------------------------------------------
# SO(3) helpers
# ---------------------------------------------------------------------------

def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Batched Rodrigues: (..., 3) axis-angle -> (..., 3, 3)."""
    th = torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp_min(1e-12)
    K = cross_product_matrix(w / th)
    th = th[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + torch.sin(th) * K + (1 - torch.cos(th)) * (K @ K)


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """(3,3) -> COLMAP qvec (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# PnP RANSAC (batched 6-point DLT hypothesis bank)
# ---------------------------------------------------------------------------

def _pnp_rows(X: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """DLT rows for P=[R|t] on K-normalized points. X: (..., n, 3),
    uv: (..., n, 2) -> (..., 2n, 12)."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)      # (..., n, 4)
    z = torch.zeros_like(Xh)
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    r0 = torch.cat([Xh, z, -u * Xh], -1)                      # (..., n, 12)
    r1 = torch.cat([z, Xh, -v * Xh], -1)
    return torch.cat([r0, r1], -2)


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(x.abs() < eps, eps, x)


def _residual_jacobian(y: torch.Tensor, uv: torch.Tensor, w: torch.Tensor,
                       z_min: float):
    """Reprojection residuals of camera-frame points y (O, 3) against
    normalized observations uv (O, 2), weighted by w, and the projection's
    Jacobian d(uv)/dy (O, 2, 3). Returns (pr, r, Jx)."""
    z = y[:, 2].clamp_min(z_min)
    pr = y[:, :2] / z[:, None]
    r = (pr - uv) * w[:, None]
    iz = 1.0 / z
    zero = torch.zeros_like(iz)
    Jx = torch.stack([torch.stack([iz, zero, -pr[:, 0] * iz], -1),
                      torch.stack([zero, iz, -pr[:, 1] * iz], -1)], 1)
    return pr, r, Jx


def _solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """H^-1 g for batched small systems, without a host read."""
    return torch.linalg.solve_ex(H, g[..., None]).result[..., 0]


@highp
def pnp_ransac_device(X: torch.Tensor, uv: torch.Tensor, w: torch.Tensor,
                      idx: torch.Tensor, thresh: float, steps: int = 5):
    """Batched PnP RANSAC on K-normalized observations.

    X: (N, 3), uv: (N, 2), w: (N,) 1/0 validity; idx: (H, 6) row indices
    of the hypotheses' minimal sets (drawn over the valid rows, with
    replacement: duplicate-index hypotheses give a rank-deficient A whose
    nullspace model scores poorly, as in `geometry/ransac.py`). Returns
    (R (3,3), t (3,), inliers (N,), num_inliers ()).

    The JAX function (`_pnp_ransac_device`) takes each nullspace vector
    with the sign its eigensolver returns, which no solver fixes; where
    the rotation block's determinant is negative, the Procrustes step
    gives a reflected rotation that scores near zero, so which hypotheses
    count depends on the solver (LAPACK here, cuSOLVER on the card). The
    port flips those vectors: every hypothesis is a proper rotation, and
    the bank is the same on every device. The five Gauss-Newton steps
    keep the JAX package's Jacobian (the rotation's columns taken about
    the camera-frame point y, translation included) and so do not
    converge in five steps: the result depends on the starting
    hypothesis."""
    H = idx.shape[0]
    fidx = idx.reshape(-1)
    A = _pnp_rows(X[fidx].reshape(H, 6, 3), uv[fidx].reshape(H, 6, 2))
    AtA = torch.einsum("hri,hrj->hij", A, A)
    # smallest eigenvector of the 12x12 normal matrix = DLT nullspace, its
    # sign fixed so that the rotation block has det >= 0 (see below)
    _, vecs = torch.linalg.eigh(AtA)
    P = vecs[..., 0].reshape(H, 3, 4)
    P = P * torch.where(torch.linalg.det(P[:, :, :3]) < 0, -1.0,
                        1.0).to(P.dtype)[:, None, None]

    # orthonormalize: P = s * [R|t] up to sign. Procrustes via SVD(3x3).
    U, S, Vt = torch.linalg.svd(P[:, :, :3])
    detUV = torch.linalg.det(U @ Vt)
    one = torch.ones_like(detUV)
    D = torch.stack([one, one, detUV], -1)
    R = U @ (D[..., None] * Vt)                                 # (H, 3, 3)
    s = S.mean(-1) * torch.sign(detUV)                          # signed scale
    t = P[:, :, 3] / _safe(s, 1e-12)[:, None]

    # score every hypothesis against all observations
    y = torch.einsum("hij,nj->hni", R, X) + t[:, None]          # (H, N, 3)
    z = y[..., 2]
    pr = y[..., :2] / _safe(z[..., None], 1e-9)
    err = torch.linalg.vector_norm(pr - uv[None], dim=-1)
    inl = (err < thresh) & (z > 1e-6) & (w[None] > 0)
    best = torch.argmax(inl.sum(-1))                # the first maximum
    Rb, tb = R[best], t[best]
    inl_b = inl[best].to(X.dtype)

    # GN refinement on se3 over the inliers (damped)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(steps):
        y = X @ Rb.T + tb                                       # (N, 3)
        _, r, Jx = _residual_jacobian(y, uv, inl_b, 1e-9)
        Jw = -torch.einsum("nij,njk->nik", Jx, cross_product_matrix(y))
        J = torch.cat([Jw, Jx], -1) * inl_b[:, None, None]
        Hm = torch.einsum("nri,nrj->ij", J, J) + 1e-8 * eye6
        d = _solve(Hm, -torch.einsum("nri,nr->i", J, r))
        Rb, tb = so3_exp(d[:3]) @ Rb, tb + d[3:]
    y = X @ Rb.T + tb
    z = y[:, 2]
    pr = y[:, :2] / _safe(z[:, None], 1e-9)
    err = torch.linalg.vector_norm(pr - uv, dim=-1)
    inl_b = (err < thresh) & (z > 1e-6) & (w > 0)
    return Rb, tb, inl_b, inl_b.sum()


def pnp_ransac(X: np.ndarray, uv_norm: np.ndarray,
               generator: torch.Generator | None, thresh: float,
               num_hypotheses: int = 512, device="cuda"):
    """Host wrapper: the (H, 6) minimal-set rows drawn uniformly from
    `generator` on `device`, the device RANSAC in float32. Returns (R, t)
    in float64, the inlier mask and its count."""
    dev = resolve_device(device)
    n = len(X)
    idx = torch.randint(n, (num_hypotheses, 6), generator=generator,
                        device=dev)
    R, t, inl, ninl = pnp_ransac_device(
        torch.from_numpy(np.asarray(X)).to(dev, torch.float32),
        torch.from_numpy(np.asarray(uv_norm)).to(dev, torch.float32),
        torch.ones(n, dtype=torch.float32, device=dev), idx, thresh)
    return (R.cpu().double().numpy(), t.cpu().double().numpy(),
            inl.cpu().numpy(), int(ninl))


# ---------------------------------------------------------------------------
# resection-intersection bundle adjustment
# ---------------------------------------------------------------------------

@highp
def ba_steps(R, t, X, cam_idx, pt_idx, uv, w, cam_free, iters: int = 12,
             lam: float = 1e-3):
    """Alternating batched GN. R: (C,3,3), t: (C,3), X: (P,3);
    observations cam_idx/pt_idx/uv/w: (O,) / (O,) / (O,2) / (O,).
    cam_free: (C,) 0/1 — gauge-fixed cameras get no update."""
    C, P = R.shape[0], X.shape[0]
    by_cam, by_pt = OrderedSegments(cam_idx), OrderedSegments(pt_idx)

    def seg_sum(segs, n, values):
        return segs.add_(values.new_zeros((n,) + values.shape[1:]), values)

    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    # points with < 2 observations are unconstrained: leave them
    moves = (seg_sum(by_pt, P, w) >= 2).to(X.dtype)[:, None]

    def residual_jac(R, t, X):
        y = torch.einsum("oij,oj->oi", R[cam_idx], X[pt_idx]) + t[cam_idx]
        ww = w * (y[:, 2] > 1e-6)
        _, r, Jx = _residual_jacobian(y, uv, ww, 1e-6)
        return y, r, Jx * ww[:, None, None]

    for _ in range(iters):
        # --- resection: per-camera 6x6 GN (points fixed) ---
        y, r, Jx = residual_jac(R, t, X)
        Jc = torch.cat([-torch.einsum("oij,ojk->oik", Jx,
                                      cross_product_matrix(y)), Jx], -1)
        Hc = seg_sum(by_cam, C, torch.einsum("ori,orj->oij", Jc, Jc))
        gc = seg_sum(by_cam, C, torch.einsum("ori,or->oi", Jc, r))
        diag = eye6 * (lam * Hc.diagonal(dim1=-2, dim2=-1).sum(-1)
                       [:, None, None] / 6.0 + 1e-9)
        d = _solve(Hc + diag, -gc) * cam_free[:, None]         # (C, 6)
        R = so3_exp(d[:, :3]) @ R
        t = t + d[:, 3:]

        # --- intersection: per-point 3x3 GN (cameras fixed) ---
        _, r, Jx = residual_jac(R, t, X)
        Jp = torch.einsum("oij,ojk->oik", Jx, R[cam_idx])       # (O, 2, 3)
        Hp = seg_sum(by_pt, P, torch.einsum("ori,orj->oij", Jp, Jp))
        gp = seg_sum(by_pt, P, torch.einsum("ori,or->oi", Jp, r))
        diagp = eye3 * (lam * Hp.diagonal(dim1=-2, dim2=-1).sum(-1)
                        [:, None, None] / 3.0 + 1e-9)
        X = X + _solve(Hp + diagp, -gp) * moves
    return R, t, X


def bundle_adjust(poses: dict, X: np.ndarray, obs: list, iters: int = 12,
                  device="cuda"):
    """poses: {name: [R (3,3), t (3,)]} (mutated in place); X: (P, 3)
    (returned updated); obs: list of (name, point_index, uv_normalized).
    The first pose in insertion order is gauge-fixed. The steps run in
    float32."""
    names = list(poses.keys())
    cmap = {n: i for i, n in enumerate(names)}
    C, P, O = len(names), len(X), len(obs)
    if O == 0 or P == 0:
        return X
    dev = resolve_device(device)
    Rb = np.stack([poses[n][0] for n in names])
    tb = np.stack([poses[n][1] for n in names])
    ci = np.array([cmap[n] for n, _, _ in obs], np.int64)
    pi = np.array([p for _, p, _ in obs], np.int64)
    uv = np.stack([xy for _, _, xy in obs])
    free = np.ones(C)
    free[0] = 0.0                                   # gauge: fix first camera

    def put(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(dev, dt)

    Rn, tn, Xn = ba_steps(put(Rb), put(tb), put(X), put(ci, torch.int64),
                          put(pi, torch.int64), put(uv),
                          torch.ones(O, dtype=torch.float32, device=dev),
                          put(free),
                          iters=iters)
    Rn, tn, Xn = (a.cpu().double().numpy() for a in (Rn, tn, Xn))
    for n in names:
        poses[n] = [Rn[cmap[n]], tn[cmap[n]]]
    return Xn


# ---------------------------------------------------------------------------
# the incremental mapper
# ---------------------------------------------------------------------------

class NativeReconstruction:
    """Minimal pycolmap.Reconstruction analog: registered poses + points,
    COLMAP text-model output."""

    def __init__(self, cameras: dict, images: dict):
        self.cameras = cameras                       # camera_id -> dict
        self.images = images                         # name -> db row
        self.poses: dict[str, list] = {}             # name -> [R, t]
        self.xyz = np.zeros((0, 3))
        self.track_obs: list[list] = []              # per point: (name, kid)

    def num_reg_images(self) -> int:
        return len(self.poses)

    def num_points3D(self) -> int:
        return len(self.xyz)

    def write_text(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        with open(join(out_dir, "cameras.txt"), "w") as f:
            f.write("# camera_id model w h params\n")
            names = {0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL"}
            for cid, cam in self.cameras.items():
                ps = " ".join(f"{p:.6f}" for p in cam["params"])
                f.write(f"{cid} {names.get(cam['model'], cam['model'])} "
                        f"{cam['width']} {cam['height']} {ps}\n")
        with open(join(out_dir, "images.txt"), "w") as f:
            f.write("# image_id qw qx qy qz tx ty tz camera_id name\n")
            for name, (R, t) in self.poses.items():
                q = rotmat_to_qvec(R)
                row = self.images[name]
                f.write(f"{row['image_id']} "
                        + " ".join(f"{v:.8f}" for v in q) + " "
                        + " ".join(f"{v:.8f}" for v in t)
                        + f" {row['camera_id']} {name}\n\n")
        with open(join(out_dir, "points3D.txt"), "w") as f:
            f.write("# point3D_id x y z r g b error track\n")
            for i, p in enumerate(self.xyz):
                f.write(f"{i + 1} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"128 128 128 0.0\n")


def _triangulate_two(P0, P1, uv0, uv1):
    """Batched two-view DLT. P: (3,4) K-normalized projection,
    uv: (n, 2) normalized coords -> (n, 3)."""
    n = len(uv0)
    A = np.zeros((n, 4, 4), np.float64)
    A[:, 0] = uv0[:, 0, None] * P0[2] - P0[0]
    A[:, 1] = uv0[:, 1, None] * P0[2] - P0[1]
    A[:, 2] = uv1[:, 0, None] * P1[2] - P1[0]
    A[:, 3] = uv1[:, 1, None] * P1[2] - P1[1]
    _, _, vt = np.linalg.svd(A)
    X = vt[:, -1]
    return X[:, :3] / np.where(np.abs(X[:, 3:]) < 1e-12, 1e-12, X[:, 3:])


def _triangulate_multiview(Ps, uvs, w):
    """Batched MULTI-VIEW DLT (the reference gets this from COLMAP's C++
    IncrementalTriangulator; ref hloc/reconstruction.py:61-100).
    Ps: (T, M, 3, 4) K-normalized projections, uvs: (T, M, 2) normalized
    coords, w: (T, M) observation mask (rows with w=0 are padding).
    Returns (T, 3); cheirality is checked by the caller."""
    r0 = uvs[..., 0:1] * Ps[:, :, 2, :] - Ps[:, :, 0, :]   # (T, M, 4)
    r1 = uvs[..., 1:2] * Ps[:, :, 2, :] - Ps[:, :, 1, :]
    A = np.concatenate([r0 * w[..., None], r1 * w[..., None]], 1)
    B = A.transpose(0, 2, 1) @ A                            # (T, 4, 4)
    _, vecs = np.linalg.eigh(B)
    Xh = vecs[..., 0]                                       # (T, 4)
    s = Xh[:, 3:]
    s = np.where(np.abs(s) < 1e-12, 1e-12, s)
    return Xh[:, :3] / s


def incremental_mapping_native(db_path: str, out_dir: str | None = None,
                               reproj_thresh_px: float = 4.0,
                               min_pnp_points: int = 8,
                               seed: int = 0,
                               verbose: bool = True, device="cuda",
                               timer: StageTimer | None = None):
    """Incremental SfM over a verified-matches COLMAP database, its solvers
    on `device`.

    Returns a NativeReconstruction (poses are world->camera [R|t],
    COLMAP convention). Writes the text model to `out_dir` if given.
    `timer` (a `utils/profiling.StageTimer`) accumulates the stages'
    times: init, pnp, triangulate, bundle_adjust and filter.
    """
    from gim_tpu_torch.geometry.pose import estimate_pose
    from gim_tpu_torch.hloc.triangulation import build_tracks

    dev = resolve_device(device)
    timer = timer if timer is not None else StageTimer()
    cameras, images, kpts, pairs = read_database(db_path)
    rec = NativeReconstruction(cameras, images)
    if len(pairs) == 0:
        return rec
    Ks = {n: camera_K(cameras[images[n]["camera_id"]]) for n in images}

    # normalized keypoints precomputed once per image (hot in
    # triangulation/filtering inner loops)
    nkpts = {n: ((kpts[n] - Ks[n][[0, 1], [2, 2]]) / Ks[n][[0, 1], [0, 1]])
             if len(kpts[n]) else kpts[n] for n in images}

    def norm(name, idx):
        return nkpts[name][idx]

    # thresholds in normalized coords (per-image mean focal)
    def nthr(name):
        K = Ks[name]
        return reproj_thresh_px / ((K[0, 0] + K[1, 1]) / 2.0)

    # --- correspondence tracks over the verified matches ---
    tracks = build_tracks(list(pairs.keys()), pairs, {})
    # membership: (name, kpt) -> track id
    node_to_track = {}
    for ti, tr in enumerate(tracks):
        for node in tr:
            node_to_track[node] = ti
    track_of = {name: {} for name in images}
    for (name, ki), ti in node_to_track.items():
        track_of[name][ki] = ti

    # --- init pair: most verified matches ---
    init_pair = max(pairs, key=lambda k: len(pairs[k]))
    n0, n1 = init_pair
    m = pairs[init_pair]
    with timer.stage("init"):
        M = 1 << int(np.ceil(np.log2(max(len(m), 8))))
        p0 = np.zeros((M, 2), np.float32)
        p1 = np.zeros((M, 2), np.float32)
        val = np.zeros(M, bool)
        p0[:len(m)] = kpts[n0][m[:, 0]]
        p1[:len(m)] = kpts[n1][m[:, 1]]
        val[:len(m)] = True

        def put(a):
            return torch.from_numpy(a).to(dev)[None]

        res = estimate_pose(put(p0), put(p1), put(val),
                            put(Ks[n0].astype(np.float32)),
                            put(Ks[n1].astype(np.float32)), thresh=1.0,
                            generators=[torch.Generator(dev)
                                        .manual_seed(seed)])
        if not bool(res["success"][0]):
            return rec
        R1 = res["R"][0].cpu().double().numpy()
        t1 = res["t"][0].cpu().double().numpy()
        inl = res["inliers"][0].cpu().numpy()[:len(m)]
        rec.poses[n0] = [np.eye(3), np.zeros(3)]
        rec.poses[n1] = [R1, t1]
        if verbose:
            print(f"[mapper] init pair {n0} - {n1}: {int(inl.sum())} "
                  f"inliers")

        # triangulate the init pair's inlier tracks
        point_of_track: dict[int, int] = {}
        P0 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
        P1 = np.concatenate([R1, t1[:, None]], 1)
        mi = m[inl]
        uv0 = norm(n0, mi[:, 0])
        uv1 = norm(n1, mi[:, 1])
        X = _triangulate_two(P0, P1, uv0, uv1)
        z0 = X[:, 2]
        z1 = (X @ R1.T + t1)[:, 2]
        keep = (z0 > 1e-6) & (z1 > 1e-6)
        xyz = []
        track_obs = []
        for row, ok in zip(range(len(mi)), keep):
            ti = track_of[n0].get(int(mi[row, 0]))
            if not ok or ti is None or ti in point_of_track:
                continue
            point_of_track[ti] = len(xyz)
            xyz.append(X[row])
            track_obs.append([(nm, ki) for nm, ki in tracks[ti]])
        rec.xyz = np.array(xyz) if xyz else np.zeros((0, 3))
        rec.track_obs = track_obs

    def observations():
        obs = []
        for pi, tr in enumerate(rec.track_obs):
            for nm, ki in tr:
                if nm in rec.poses:
                    obs.append((nm, pi, norm(nm, ki)))
        return obs

    def adjust():
        with timer.stage("bundle_adjust"):
            rec.xyz = bundle_adjust(rec.poses, rec.xyz, observations(),
                                    device=dev)

    def filter_points():
        """Drop points with bad reprojection in any registered view
        (vectorized over the whole observation set)."""
        if len(rec.xyz) == 0:
            return
        pis, Rs, ts, uvn, thr = [], [], [], [], []
        for pi, tr in enumerate(rec.track_obs):
            for nm, ki in tr:
                if nm not in rec.poses:
                    continue
                R, t = rec.poses[nm]
                pis.append(pi)
                Rs.append(R)
                ts.append(t)
                uvn.append(nkpts[nm][ki])
                thr.append(nthr(nm))
        keep = np.ones(len(rec.xyz), bool)
        if pis:
            pis = np.asarray(pis)
            y = (np.einsum("oij,oj->oi", np.stack(Rs), rec.xyz[pis])
                 + np.stack(ts))
            behind = y[:, 2] < 1e-6
            proj = y[:, :2] / np.where(behind[:, None], 1.0, y[:, 2:])
            err = np.linalg.norm(proj - np.stack(uvn), axis=1)
            keep[pis[behind | (err > np.asarray(thr))]] = False
        if keep.all():
            return
        remap = -np.ones(len(rec.xyz), int)
        remap[keep] = np.arange(int(keep.sum()))
        rec.xyz = rec.xyz[keep]
        rec.track_obs = [tr for tr, k in zip(rec.track_obs, keep) if k]
        for ti in list(point_of_track):
            np_ = remap[point_of_track[ti]]
            if np_ < 0:
                del point_of_track[ti]
            else:
                point_of_track[ti] = int(np_)

    adjust()
    with timer.stage("filter"):
        filter_points()

    # registered-observation count per track (drives candidate selection
    # for batched multi-view triangulation)
    reg_count = np.zeros(len(tracks), np.int32)
    for nm in rec.poses:
        for _ki, _ti in track_of[nm].items():
            reg_count[_ti] += 1

    MAX_TRI_OBS = 16   # DLT observation cap per track (memory bound)

    def triangulate_new() -> int:
        """Batched multi-view triangulation of all untriangulated tracks
        with >= 2 registered observations. Returns #points added."""
        untri = np.ones(len(tracks), bool)
        for ti in point_of_track:
            untri[ti] = False
        cand = np.where(untri & (reg_count >= 2))[0]
        if len(cand) == 0:
            return 0
        Pcache = {nm: np.concatenate([R, np.asarray(t).reshape(3, 1)], 1)
                  for nm, (R, t) in rec.poses.items()}
        per_track = [[(nm, ki) for nm, ki in tracks[ti]
                      if nm in rec.poses][:MAX_TRI_OBS] for ti in cand]
        T = len(cand)
        M = max(len(r) for r in per_track)
        P_arr = np.zeros((T, M, 3, 4))
        uv_arr = np.zeros((T, M, 2))
        w_arr = np.zeros((T, M))
        for i, reg in enumerate(per_track):
            for j, (nm, ki) in enumerate(reg):
                P_arr[i, j] = Pcache[nm]
                uv_arr[i, j] = nkpts[nm][ki]
                w_arr[i, j] = 1.0
        X = _triangulate_multiview(P_arr, uv_arr, w_arr)
        # cheirality in EVERY registered view (padding rows exempt)
        z = (np.einsum("tmij,tj->tmi", P_arr[..., :3], X)[..., 2]
             + P_arr[:, :, 2, 3])
        ok = (((z > 1e-6) | (w_arr == 0)).all(1)
              & np.isfinite(X).all(1))
        acc = np.where(ok)[0]
        if len(acc) == 0:
            return 0
        base = len(rec.xyz)
        rec.xyz = (np.concatenate([rec.xyz, X[acc]], 0)
                   if len(rec.xyz) else X[acc])
        for k, i in enumerate(acc):
            ti = int(cand[i])
            point_of_track[ti] = base + k
            rec.track_obs.append(list(tracks[ti]))
        return len(acc)

    # --- incremental registration ---
    gen = torch.Generator(dev).manual_seed(seed + 1)
    while True:
        # 2D-3D correspondence counts per unregistered image
        best_name, best_c = None, 0
        for name in images:
            if name in rec.poses:
                continue
            c = sum(1 for ki, ti in track_of[name].items()
                    if ti in point_of_track)
            if c > best_c:
                best_name, best_c = name, c
        if best_name is None or best_c < min_pnp_points:
            break
        corr = [(ki, point_of_track[ti])
                for ki, ti in track_of[best_name].items()
                if ti in point_of_track]
        kis = np.array([c[0] for c in corr])
        pis = np.array([c[1] for c in corr])
        with timer.stage("pnp"):
            R, t, inl, ninl = pnp_ransac(
                rec.xyz[pis].astype(np.float32), norm(best_name, kis),
                gen, nthr(best_name), device=dev)
        if ninl < min_pnp_points:
            if verbose:
                print(f"[mapper] {best_name}: PnP failed "
                      f"({ninl}/{len(corr)} inliers) — stopping")
            break
        rec.poses[best_name] = [R, t]
        if verbose:
            print(f"[mapper] registered {best_name}: "
                  f"{ninl}/{len(corr)} PnP inliers")

        # triangulate tracks that now have >= 2 registered observations —
        # multi-view DLT over ALL registered observations (capped), batched
        # across tracks (one eigh over (T, 4, 4) instead of a per-track
        # Python loop)
        with timer.stage("triangulate"):
            for ki, ti in track_of[best_name].items():
                reg_count[ti] += 1
            new_pts = triangulate_new()
        adjust()
        with timer.stage("filter"):
            filter_points()
        if verbose:
            print(f"[mapper] +{new_pts} points, total "
                  f"{len(rec.xyz)} after filtering")

    if out_dir is not None:
        rec.write_text(out_dir)
    return rec
