"""The port's native incremental mapper (`gim_tpu_torch/hloc/mapper.py`)
against the JAX package's on the CPU.

- The pieces, on numpy-seeded inputs: `so3_exp`, `rotmat_to_qvec` and the
  PnP DLT rows at float32 1e-5 (the quaternion is the same numpy code:
  exactly); the database reader exactly; the two triangulations (numpy in
  both packages) exactly.
- PnP RANSAC and bundle adjustment in float64 (JAX under x64), where the
  float32 solves are ill-conditioned (a 12x12 eigendecomposition, damped
  Gauss-Newton), to 1e-9 relative: PnP with JAX's `categorical` draws as
  the port's `idx`, over the hypotheses whose nullspace vector JAX's
  eigensolver returned with a proper rotation block (the port fixes that
  sign; `pnp_ransac_device`'s docstring), and `ba_steps` on JAX's padded
  problem, 12 iterations.
- The whole mapper on the 6-camera scene of tests/test_mapper.py: the
  port registers the same images as JAX, meets that file's bounds against
  the ground truth, and its camera centres agree with JAX's within 1e-2
  after a similarity (the draws differ: not bit parity); two runs give
  the same model bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.hloc import mapper as JM
from gim_tpu_torch.hloc import mapper as TM
from tests.test_mapper import _align_similarity, _make_scene, _write_db


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-300))


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def test_so3_qvec_and_pnp_rows_match_jax():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(5, 7, 3)) * [[[0.01]], [[0.3]], [[1.0]], [[2.5]],
                                       [[1e-9]]]).astype(np.float32)
    want = np.asarray(JM.so3_exp(jnp.asarray(w)))
    got = TM.so3_exp(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for wi in w.reshape(-1, 3)[:20].astype(np.float64):
        R = _rodrigues(wi) if np.linalg.norm(wi) > 0 else np.eye(3)
        R = R @ np.diag([1, -1, -1]) if wi[0] < 0 else R   # trace <= 0 too
        np.testing.assert_array_equal(TM.rotmat_to_qvec(R),
                                      JM.rotmat_to_qvec(R))
    X = rng.normal(size=(4, 6, 3)).astype(np.float32)
    uv = rng.normal(size=(4, 6, 2)).astype(np.float32)
    np.testing.assert_allclose(
        TM._pnp_rows(torch.from_numpy(X), torch.from_numpy(uv)).numpy(),
        np.asarray(JM._pnp_rows(jnp.asarray(X), jnp.asarray(uv))),
        rtol=0, atol=1e-5)


def _pnp_problem(seed=0, n=128, n_valid=118, outliers=0.25):
    rng = np.random.default_rng(seed)
    R = _rodrigues(np.array([0.1, -0.2, 0.05]))
    t = np.array([0.3, -0.1, 0.5])
    X = rng.uniform([-1, -1, 4], [1, 1, 6], (n, 3))
    y = X @ R.T + t
    uv = y[:, :2] / y[:, 2:] + rng.normal(0, 0.3 / 600, (n, 2))
    bad = rng.random(n) < outliers
    uv[bad] += rng.uniform(-0.2, 0.2, (int(bad.sum()), 2))
    w = np.zeros(n)
    w[:n_valid] = 1.0
    return X, uv, w


def test_pnp_ransac_matches_jax_in_float64():
    X, uv, w = _pnp_problem()
    H, thresh = 512, 4.0 / 600
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(5)
        want = [np.asarray(a) for a in JM._pnp_ransac_device(
            jnp.asarray(X), jnp.asarray(uv), jnp.asarray(w), key, thresh,
            num_hypotheses=H)]
        # JAX's draws (`_pnp_ransac_device`'s categorical over the valid
        # rows) and the sign JAX's eigensolver gave each nullspace vector
        logits = jnp.where(jnp.asarray(w) > 0, 0.0, -1e9)
        idx = np.asarray(jax.random.categorical(key, logits[None, :],
                                                shape=(H, 6)))
        A = JM._pnp_rows(jnp.asarray(X)[idx], jnp.asarray(uv)[idx])
        vec = np.asarray(jnp.linalg.eigh(
            jnp.einsum("hri,hrj->hij", A, A))[1][..., 0])
    proper = np.linalg.det(vec.reshape(H, 3, 4)[:, :, :3]) >= 0
    assert 0.2 < proper.mean() < 0.8
    got = TM.pnp_ransac_device(*(torch.from_numpy(a) for a in (X, uv, w)),
                               torch.tensor(idx[proper]), thresh)
    assert got[0].dtype == torch.float64
    for g, wv in zip(got[:2], want[:2]):
        assert _rel(g.numpy(), wv) < 1e-9
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert int(got[3]) == int(want[3]) >= 80


def test_pnp_ransac_wrapper_draws_from_its_generator():
    X, uv, w = _pnp_problem(seed=1, n_valid=128)

    def run(seed):
        return TM.pnp_ransac(X, uv, torch.Generator().manual_seed(seed),
                             4.0 / 600, device="cpu")

    a, b = run(3), run(3)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    assert a[0].dtype == np.float64 and a[3] >= 80
    idx = torch.randint(len(X), (512, 6),
                        generator=torch.Generator().manual_seed(3))
    c = TM.pnp_ransac_device(*(torch.from_numpy(v).float()
                               for v in (X, uv, np.ones(len(X)))),
                             idx, 4.0 / 600)
    np.testing.assert_array_equal(a[0], c[0].double().numpy())


def _ba_problem(seed=0, C=5, P=60, noise=1e-3):
    """JAX's padded layout (bundle_adjust): cameras to a power of two
    (identity, not free), points and observations to powers of two (w 0)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1, -1, 4], [1, 1, 6], (P, 3))
    Rs = [_rodrigues(rng.normal(size=3) * 0.1) for _ in range(C)]
    ts = [rng.normal(size=3) * 0.2 for _ in range(C)]
    obs = [(c, p) for c in range(C) for p in range(P)
           if rng.random() < 0.8]
    Cp, Pp, Op = JM._pow2(C, 2), JM._pow2(P), JM._pow2(len(obs))
    R = np.tile(np.eye(3), (Cp, 1, 1))
    t = np.zeros((Cp, 3))
    for c in range(C):
        R[c] = Rs[c] @ _rodrigues(rng.normal(size=3) * 0.01)
        t[c] = ts[c] + rng.normal(size=3) * 0.01
    X = np.zeros((Pp, 3))
    X[:P] = pts + rng.normal(size=(P, 3)) * 0.02
    ci, pi = np.zeros(Op, np.int32), np.zeros(Op, np.int32)
    uv, w = np.zeros((Op, 2)), np.zeros(Op)
    for o, (c, p) in enumerate(obs):
        y = Rs[c] @ pts[p] + ts[c]
        ci[o], pi[o], w[o] = c, p, 1.0
        uv[o] = y[:2] / y[2] + rng.normal(size=2) * noise
    free = np.ones(Cp)
    free[0] = 0.0
    free[C:] = 0.0
    return R, t, X, ci, pi, uv, w, free


def test_ba_steps_match_jax_in_float64():
    args = _ba_problem()
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in JM._ba_steps(
            *(jnp.asarray(a) for a in args), iters=12)]
    t_args = [torch.from_numpy(a) for a in args]
    t_args[3], t_args[4] = t_args[3].long(), t_args[4].long()
    got = TM.ba_steps(*t_args, iters=12)
    for g, wv, what in zip(got, want, ("R", "t", "X")):
        assert g.dtype == torch.float64
        assert _rel(g.numpy(), wv) < 1e-9, what
    # the adjustment moved the perturbed cameras and points
    assert np.abs(want[2] - args[2]).max() > 1e-3


def test_triangulations_and_database_reader_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    P0 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    P1 = np.concatenate([_rodrigues(np.array([0.02, 0.1, 0.0])),
                         [[0.5], [0.0], [0.05]]], 1)
    X = rng.uniform([-1, -1, 4], [1, 1, 6], (40, 3))
    uv0 = X[:, :2] / X[:, 2:]
    y1 = X @ P1[:, :3].T + P1[:, 3]
    uv1 = y1[:, :2] / y1[:, 2:] + rng.normal(0, 1e-3, (40, 2))
    np.testing.assert_array_equal(TM._triangulate_two(P0, P1, uv0, uv1),
                                  JM._triangulate_two(P0, P1, uv0, uv1))
    Ps = rng.normal(size=(30, 5, 3, 4))
    uvs = rng.normal(size=(30, 5, 2))
    w = (rng.random((30, 5)) < 0.7).astype(np.float64)
    np.testing.assert_array_equal(TM._triangulate_multiview(Ps, uvs, w),
                                  JM._triangulate_multiview(Ps, uvs, w))

    names, _, _, K, wh, kpts, _, order = _make_scene(n_cams=3, n_pts=40)
    _write_db(tmp_path / "db.db", names, K, wh, kpts, order)
    got = TM.read_database(str(tmp_path / "db.db"))
    want = JM.read_database(str(tmp_path / "db.db"))
    assert got[0].keys() == want[0].keys() and got[1] == want[1]
    for a, b in zip(got[2:], want[2:]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for cid in want[0]:
        np.testing.assert_array_equal(TM.camera_K(got[0][cid]),
                                      JM.camera_K(want[0][cid]))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    names, cams, pts, K, wh, kpts, vis, order = _make_scene()
    db = tmp_path_factory.mktemp("mapper") / "database.db"
    _write_db(db, names, K, wh, kpts, order)
    jrec = JM.incremental_mapping_native(str(db), verbose=False)
    trec = TM.incremental_mapping_native(str(db), verbose=False,
                                         device="cpu")
    return names, cams, pts, vis, str(db), jrec, trec


def _centres(rec, names):
    return np.array([-(np.asarray(R).T @ t) for R, t in
                     (rec.poses[n] for n in names)])


def test_mapper_registers_what_jax_registers(scene):
    names, cams, pts, vis, _, jrec, trec = scene
    assert list(trec.poses) == list(jrec.poses)
    assert trec.num_reg_images() == len(names)
    assert trec.num_points3D() > 150
    # tests/test_mapper.py's bounds against the ground truth
    C_est, C_gt = _centres(trec, names), np.array([-(R.T @ t)
                                                   for R, t in cams])
    s, Rs, ts = _align_similarity(C_est, C_gt)
    err = np.linalg.norm((C_est @ (s * Rs).T + ts) - C_gt, axis=-1)
    assert err.max() < 0.05, err
    for n, (R_gt, _) in zip(names, cams):
        dR = R_gt @ (np.asarray(trec.poses[n][0]) @ Rs.T).T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 1.0, (n, ang)
    est = np.array([trec.xyz[pi] for pi in range(len(trec.track_obs))])
    gt = np.array([pts[vis[tr[0][0]][tr[0][1]]] for tr in trec.track_obs])
    s, Rs, ts = _align_similarity(est, gt)
    assert np.median(np.linalg.norm(est @ (s * Rs).T + ts - gt,
                                    axis=-1)) < 0.02
    # against JAX's reconstruction
    Cj = _centres(jrec, names)
    s, Rs, ts = _align_similarity(C_est, Cj)
    d = np.linalg.norm((C_est @ (s * Rs).T + ts) - Cj, axis=-1)
    assert d.max() < 1e-2, d


def test_mapper_runs_the_same_twice_and_writes_the_model(scene, tmp_path):
    names, _, _, _, db, _, trec = scene
    again = TM.incremental_mapping_native(db, out_dir=str(tmp_path),
                                          verbose=False, device="cpu")
    assert list(again.poses) == list(trec.poses)
    for n in names:
        for a, b in zip(again.poses[n], trec.poses[n]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(again.xyz, trec.xyz)
    assert again.track_obs == trec.track_obs
    imgs = (tmp_path / "images.txt").read_text()
    assert all(n in imgs for n in names)
    n_pts = sum(1 for line in
                (tmp_path / "points3D.txt").read_text().splitlines()
                if line and not line.startswith("#"))
    assert n_pts == again.num_points3D()


def test_mapper_times_its_stages_and_needs_cuda_by_default(scene,
                                                           monkeypatch):
    from gim_tpu_torch.utils.profiling import StageTimer

    names, _, _, _, db, _, _ = scene
    timer = StageTimer()
    TM.incremental_mapping_native(db, verbose=False, device="cpu",
                                  timer=timer)
    assert set(timer.times) == {"init", "pnp", "triangulate",
                                "bundle_adjust", "filter"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.incremental_mapping_native(db, verbose=False)
