"""The port's geometry (gim_tpu_torch/geometry/) against gim_tpu on the CPU,
float32, on the same inputs.

RANSAC's uniforms are JAX's own draws (`jax.random.split(key)`, then one
bank per round), so both sides sample the same minimal sets. Scenes are
two-view projections of random 3D points (planar for homographies) with
pixel noise and uniform outliers, made from a seed with numpy.

Tolerances:
- epipolar and Sampson distances: rtol 1e-5 on generic points;
- the 5-point stages on the same inputs: nullspace basis, constraint
  matrix and Gauss-Jordan within 1e-4 of each sample's largest entry;
  det B(z)'s coefficients within 1e-2 (they cancel: 1.2e-3 measured);
  degree-10 roots: the valid slots equal on >= 99 %, roots within 1e-4
  (relative past 1) on >= 98 % of the slots valid in both. A near-double
  root moves by ~sqrt(float32 eps) ~ 3e-4 under rounding: JAX's own eager
  run agrees with its jitted one on 99.1 % of these slots, the port on
  98.9 %;
- candidate essentials on 400 exact minimal problems: the rate of
  recovering the true E to 1e-2 within 2 points of JAX's; the valid
  slots equal on >= 99 %; candidates agreeing with JAX's to 1e-3 up to
  sign on >= 88.9 % of the slots valid in both: JAX's own eager run
  agrees with its jitted one on 90.9 % of them, less 2 points. The solve
  is ill-conditioned in float32 (the JAX package's tests/test_fivepoint.py:
  ~93 % recovery); the port agrees on 90.8 %;
- RANSAC (H = 256, M = 512, 0.1 px noise), each kind: the model up to
  sign and scale within 1e-3 on >= 90 % of scenes, inlier masks equal on
  >= 99 % of slots;
- pair_metrics (0.2 px noise): the same success flags, epipolar errors
  within rtol 1e-4 + atol 1e-8 (an inlier's residual p1^T E p0 cancels
  in float32, so below 1e-4 only the absolute error is small; the dump's
  precision threshold is 5e-4), R and t errors within 0.05 deg where
  JAX's are below 5 deg.

The RANSAC and pair_metrics scenes have 0.1-0.2 px of noise against the
0.5 px threshold. At 0.5 px, a 512-point scene's inlier set shares its
boundary with many points, and the IRLS refits (weights 1/residual)
reach another local optimum under rounding alone: JAX's own jitted and
eager RANSAC end 0.029 apart on one scene in three, with inlier masks
85.5 % equal; the port is no closer to either.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.eval import zeb as jzeb
from gim_tpu.geometry import epipolar as jep
from gim_tpu.geometry import fivepoint as jfp
from gim_tpu.geometry import pose as jpose
from gim_tpu.geometry import ransac as jr
from gim_tpu_torch.eval import zeb as tzeb
from gim_tpu_torch.geometry import epipolar as tep
from gim_tpu_torch.geometry import fivepoint as tfp
from gim_tpu_torch.geometry import pose as tpose
from gim_tpu_torch.geometry import ransac as tr

HIGH = jax.default_matmul_precision("highest")
H_HYP, M = 256, 512


def T(a):
    return torch.from_numpy(np.array(a))


def rodrigues(r):
    th = np.linalg.norm(r)
    k = r / max(th, 1e-12)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def make_scene(rng, m, n_valid, inlier_ratio, noise_px, planar=False,
               f=800.0, im=1024):
    """m correspondence slots in pixels, the first n_valid valid; a share
    of them inliers with Gaussian noise, the rest uniform outliers.
    Returns p0, p1 (m, 2), valid (m,), K (3, 3), T_0to1 (4, 4)."""
    K = np.array([[f, 0, im / 2], [0, f, im / 2], [0, 0, 1.0]])
    R = rodrigues(rng.uniform(-0.25, 0.25, 3))
    t = rng.standard_normal(3)
    t = 0.5 * t / np.linalg.norm(t)
    xy = rng.uniform(-3, 3, (m, 2))
    z = (6.0 + 0.3 * xy[:, :1] if planar else rng.uniform(4, 12, (m, 1)))
    X = np.concatenate([xy, z], -1)
    x0 = X @ K.T
    x1 = (X @ R.T + t) @ K.T
    p0 = x0[:, :2] / x0[:, 2:] + rng.standard_normal((m, 2)) * noise_px
    p1 = x1[:, :2] / x1[:, 2:] + rng.standard_normal((m, 2)) * noise_px
    out = rng.random(m) > inlier_ratio
    p1[out] = rng.uniform(0, im, (int(out.sum()), 2))
    valid = np.arange(m) < n_valid
    Tm = np.eye(4)
    Tm[:3, :3], Tm[:3, 3] = R, t
    return (p0.astype(np.float32), p1.astype(np.float32), valid,
            K.astype(np.float32), Tm.astype(np.float32))


def jax_noise(key, num_hypotheses, m):
    """RANSAC's two uniform banks as the JAX package draws them from
    `key` (gim_tpu/geometry/ransac.py:175, :323)."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k1, (num_hypotheses, m))),
            np.asarray(jax.random.uniform(
                k2, (tr.lo_hypotheses(num_hypotheses), m))))


def _rel(got, want, axes):
    scale = np.abs(want).max(axis=axes, keepdims=True)
    return (np.abs(got - want) / np.maximum(scale, 1e-30)).max()


def _up_to_sign(a, b):
    """max |a - b| up to sign, over the trailing (3, 3)."""
    return np.minimum(np.abs(a - b).max((-1, -2)),
                      np.abs(a + b).max((-1, -2)))


# ---------------------------------------------------------------------------
# epipolar.py
# ---------------------------------------------------------------------------

def test_epipolar_primitives():
    rng = np.random.default_rng(0)
    Tm = np.stack([make_scene(rng, 4, 4, 1.0, 0.0)[4] for _ in range(3)])
    K = np.stack([make_scene(rng, 4, 4, 1.0, 0.0)[3] for _ in range(3)])
    p0 = rng.uniform(0, 1024, (3, 50, 2)).astype(np.float32)
    p1 = rng.uniform(0, 1024, (3, 50, 2)).astype(np.float32)
    t = rng.standard_normal((3, 3)).astype(np.float32)
    F = rng.standard_normal((3, 3, 3)).astype(np.float32)
    p0h = np.concatenate([p0 / 1024, np.ones((3, 50, 1), np.float32)], -1)
    p1h = np.concatenate([p1 / 1024, np.ones((3, 50, 1), np.float32)], -1)
    with HIGH:
        E = np.asarray(jep.essential_from_pose(jnp.asarray(Tm)))
        want = {
            "skew": jep.cross_product_matrix(jnp.asarray(t)),
            "E": E,
            "norm": jep.normalize_points(jnp.asarray(p0), jnp.asarray(K)),
            "sym": jep.symmetric_epipolar_distance(
                jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(E),
                jnp.asarray(K), jnp.asarray(K)),
            "sampson": jep.sampson_distance(jnp.asarray(p0h),
                                            jnp.asarray(p1h),
                                            jnp.asarray(F)),
        }
    got = {
        "skew": tep.cross_product_matrix(T(t)),
        "E": tep.essential_from_pose(T(Tm)),
        "norm": tep.normalize_points(T(p0), T(K)),
        "sym": tep.symmetric_epipolar_distance(T(p0), T(p1), T(E), T(K),
                                               T(K)),
        "sampson": tep.sampson_distance(T(p0h), T(p1h), T(F)),
    }
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# fivepoint.py
# ---------------------------------------------------------------------------

def _minimal_problems(n, seed):
    """n exact 5-point problems in normalized coordinates and their true
    unit-norm essentials (tests/test_fivepoint.py's construction)."""
    rng = np.random.default_rng(seed)
    P0, P1, E = [], [], []
    for _ in range(n):
        Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        Q *= np.sign(np.linalg.det(Q))
        t = rng.standard_normal(3)
        t /= np.linalg.norm(t)
        X = rng.standard_normal((5, 3)) * 0.5 + np.array([0, 0, 4.0])
        X1 = X @ Q.T + t
        P0.append(X[:, :2] / X[:, 2:3])
        P1.append(X1[:, :2] / X1[:, 2:3])
        e = tep.cross_product_matrix(torch.from_numpy(t)).numpy() @ Q
        E.append(e / np.linalg.norm(e))
    return (np.stack(P0).astype(np.float32), np.stack(P1).astype(np.float32),
            np.stack(E))


@pytest.fixture(scope="module")
def scene_samples():
    """Minimal samples drawn from a noisy scene with outliers, as RANSAC
    draws them, and JAX's stage outputs on them (one compile)."""
    rng = np.random.default_rng(3)
    p0, p1, valid, K, _ = make_scene(rng, M, 400, 0.7, 0.5)
    p0 = (p0 - K[:2, 2]) / K[0, 0]
    p1 = (p1 - K[:2, 2]) / K[0, 0]
    idx = np.argsort(rng.random((H_HYP, 400)), 1)[:, :5]   # no repeats
    s0, s1 = p0[idx], p1[idx]

    def stages(s0, s1):
        basis = jfp.nullspace_basis(s0, s1)
        cm = jfp.constraint_matrix(basis)
        red = jfp.gauss_jordan(cm)
        det, _ = jfp.detb_coeffs(red)
        roots, rvalid = jfp.roots_deg10(det)
        return basis, cm, red, det, roots, rvalid

    with HIGH:
        out = jax.jit(stages)(jnp.asarray(s0), jnp.asarray(s1))
    return s0, s1, [np.asarray(o) for o in out]


def test_fivepoint_stages(scene_samples):
    s0, s1, (basis, cm, red, det, roots, rvalid) = scene_samples
    assert _rel(tfp.nullspace_basis(T(s0), T(s1)).numpy(), basis,
                (-3, -2, -1)) <= 1e-4
    assert _rel(tfp.constraint_matrix(T(basis)).numpy(), cm,
                (-2, -1)) <= 1e-4
    assert _rel(tfp.gauss_jordan(T(cm)).numpy(), red, (-2, -1)) <= 1e-4
    # det B(z)'s coefficients cancel: 1.2e-3 of the largest; the roots
    # below hold the end of the chain
    assert _rel(tfp.detb_coeffs(T(red))[0].numpy(), det, -1) <= 1e-2

    r, v = (x.numpy() for x in tfp.roots_deg10(T(det)))
    assert (v == rvalid).mean() >= 0.99
    both = v & rvalid
    assert both.sum() > H_HYP
    close = np.abs(r - roots) <= 1e-4 * np.maximum(1.0, np.abs(roots))
    assert close[both].mean() >= 0.98, np.abs(r - roots)[both].max()


def test_essential_candidates_on_exact_problems():
    p0, p1, E_true = _minimal_problems(400, 0)
    with HIGH:
        jE, jv = jax.jit(jfp.essential_candidates)(jnp.asarray(p0),
                                                   jnp.asarray(p1))
    jE, jv = np.asarray(jE), np.asarray(jv)
    tE, tv = (x.numpy() for x in tfp.essential_candidates(T(p0), T(p1)))

    def recovery(E, v):
        return ((_up_to_sign(E, E_true[:, None]) < 1e-2) & v).any(1).mean()

    assert abs(recovery(tE, tv) - recovery(jE, jv)) <= 0.02
    assert recovery(tE, tv) >= 0.9

    both = tv & jv
    assert (tv == jv).mean() >= 0.99
    agree = (_up_to_sign(tE, jE)[both] < 1e-3).mean()
    assert agree >= 0.889, agree        # JAX eager against jit: 0.909


# ---------------------------------------------------------------------------
# ransac.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["essential", "fundamental", "homography"])
def test_ransac_matches_jax_given_its_uniforms(kind):
    rng = np.random.default_rng(1)
    scenes, noises, confs = [], [], []
    for s in range(8):
        p0, p1, valid, K, _ = make_scene(rng, M, 300 + 25 * s, 0.6, 0.1,
                                         planar=kind == "homography")
        if kind == "essential":
            p0 = (p0 - K[:2, 2]) / K[0, 0]
            p1 = (p1 - K[:2, 2]) / K[0, 0]
        scenes.append((p0, p1, valid))
        noises.append(jax_noise(jax.random.PRNGKey(s), H_HYP, M))
        confs.append(rng.random(M).astype(np.float32))
    thr = 0.5 / 800.0 if kind == "essential" else 1.0

    want = [jr.ransac(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(v),
                      jax.random.PRNGKey(s), thr, model_kind=kind,
                      num_hypotheses=H_HYP, conf=jnp.asarray(c))
            for s, ((p0, p1, v), c) in enumerate(zip(scenes, confs))]
    got = tr.ransac(*(T(np.stack(x)) for x in zip(*scenes)), thr,
                    model_kind=kind, num_hypotheses=H_HYP,
                    conf=T(np.stack(confs)),
                    noise=tuple(T(np.stack(n)) for n in zip(*noises)))

    jm = np.stack([np.asarray(w.model) for w in want])
    jm /= np.linalg.norm(jm, axis=(1, 2), keepdims=True)
    tm = got.model.numpy()
    tm /= np.linalg.norm(tm, axis=(1, 2), keepdims=True)
    assert (_up_to_sign(tm, jm) <= 1e-3).mean() >= 0.9, _up_to_sign(tm, jm)
    jin = np.stack([np.asarray(w.inliers) for w in want])
    assert (got.inliers.numpy() == jin).mean() >= 0.99
    assert got.success.numpy().all() == all(bool(w.success) for w in want)
    np.testing.assert_array_equal(got.num_inliers.numpy(),
                                  got.inliers.numpy().sum(1))


def test_ransac_needs_uniforms_of_the_right_shape():
    p = torch.zeros(2, 16, 2)
    v = torch.ones(2, 16, dtype=torch.bool)
    with pytest.raises(ValueError, match="noise"):
        tr.ransac(p, p, v, 1.0, num_hypotheses=32)
    with pytest.raises(ValueError, match="do not fit"):
        tr.ransac(p, p, v, 1.0, num_hypotheses=32,
                  noise=(torch.rand(2, 32, 16), torch.rand(2, 8, 16)))


def test_recover_pose_and_relative_pose_error():
    rng = np.random.default_rng(4)
    Es, p0s, p1s, ws, Ts = [], [], [], [], []
    for _ in range(4):
        p0, p1, valid, K, Tm = make_scene(rng, 256, 256, 0.8, 0.3)
        p0 = (p0 - K[:2, 2]) / K[0, 0]
        p1 = (p1 - K[:2, 2]) / K[0, 0]
        E = tep.essential_from_pose(T(Tm)).numpy()
        Es.append(E + 1e-3 * rng.standard_normal((3, 3)).astype(np.float32))
        p0s.append(p0)
        p1s.append(p1)
        ws.append((rng.random(256) < 0.9).astype(np.float32))
        Ts.append(Tm)
    R, t, n, good = tr.recover_pose(*(T(np.stack(x))
                                      for x in (Es, p0s, p1s, ws)))
    for b in range(4):
        with HIGH:
            jR, jt, jn, jgood = jr.recover_pose(
                jnp.asarray(Es[b]), jnp.asarray(p0s[b]),
                jnp.asarray(p1s[b]), jnp.asarray(ws[b]))
        np.testing.assert_allclose(R[b].numpy(), np.asarray(jR), atol=1e-5)
        np.testing.assert_allclose(t[b].numpy(), np.asarray(jt), atol=1e-5)
        assert float(n[b]) == float(jn)
        assert (good[b].numpy() == np.asarray(jgood)).mean() >= 0.99

    # pose errors of perturbed poses, errors of 0.5 to 40 degrees
    Tg = np.stack(Ts)
    Rp = np.stack([rodrigues(rng.uniform(-0.35, 0.35, 3)) @ x[:3, :3]
                   for x in Tg]).astype(np.float32)
    tp = (Tg[:, :3, 3] + 0.2 * rng.standard_normal((4, 3))).astype(
        np.float32)
    want = jpose.relative_pose_error(jnp.asarray(Tg), jnp.asarray(Rp),
                                     jnp.asarray(tp))
    got = tpose.relative_pose_error(T(Tg), T(Rp), T(tp))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# pair_metrics (eval/zeb.py)
# ---------------------------------------------------------------------------

def test_pair_metrics_matches_jax_given_its_uniforms():
    rng = np.random.default_rng(5)
    shape = [(M, 0.7), (400, 0.5), (300, 0.7), (4, 1.0)]   # last: too few
    scenes = [make_scene(rng, M, n, w, 0.2) for n, w in shape]
    p0, p1, valid, K, Tm = (np.stack(x) for x in zip(*scenes))
    conf = rng.random((4, M)).astype(np.float32)
    ids = [f"scene{i}#a#b" for i in range(4)]
    keys = np.stack([jzeb.identifier_key(i) for i in ids])
    with HIGH:
        want = jzeb.pair_metrics(jnp.asarray(p0), jnp.asarray(p1),
                                 jnp.asarray(valid), jnp.asarray(K),
                                 jnp.asarray(K), jnp.asarray(Tm),
                                 jnp.asarray(keys), 0.5, H_HYP,
                                 conf=jnp.asarray(conf))
    want = {k: np.asarray(v) for k, v in want.items()}
    noise = [jax_noise(jnp.asarray(k), H_HYP, M) for k in keys]
    got = tzeb.pair_metrics(T(p0), T(p1), T(valid), T(K), T(K), T(Tm),
                            keys, 0.5, H_HYP, conf=T(conf),
                            noise=tuple(T(np.stack(n))
                                        for n in zip(*noise)))
    got = {k: v.numpy() for k, v in got.items()}

    np.testing.assert_allclose(got["epi_errs"], want["epi_errs"], rtol=1e-4,
                               atol=1e-8)
    ok_j = np.isfinite(want["R_errs"])
    np.testing.assert_array_equal(np.isfinite(got["R_errs"]), ok_j)
    assert ok_j[:3].all() and not ok_j[3]
    for k in ("R_errs", "t_errs"):
        near = want[k] < 5.0
        assert near[:3].all(), want[k]
        np.testing.assert_allclose(got[k][near], want[k][near], rtol=0,
                                   atol=0.05, err_msg=k)
    assert (got["inliers"] == want["inliers"]).mean() >= 0.95


def test_pair_metrics_generators_follow_the_identifier():
    """Default uniforms: one generator per pair seeded from its
    identifier's blake2s key, so a pair's result does not depend on the
    batch around it."""
    rng = np.random.default_rng(6)
    p0, p1, valid, K, Tm = (np.stack(x) for x in zip(
        *[make_scene(rng, 128, 128, 0.8, 0.3) for _ in range(2)]))
    keys = [tzeb.identifier_key(f"s{i}") for i in range(2)]
    both = tzeb.pair_metrics(T(p0), T(p1), T(valid), T(K), T(K), T(Tm),
                             keys, 0.5, 64)
    one = tzeb.pair_metrics(T(p0[1:]), T(p1[1:]), T(valid[1:]), T(K[1:]),
                            T(K[1:]), T(Tm[1:]), keys[1:], 0.5, 64)
    for k in both:
        np.testing.assert_array_equal(both[k][1:].numpy(), one[k].numpy(),
                                      err_msg=k)
    assert tzeb.seed_of(keys[0]) == int.from_bytes(
        np.asarray(keys[0]).tobytes(), "little")
