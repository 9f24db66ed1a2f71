"""Kernel K1 (fused dual-softmax mutual matching) of gim_tpu_torch against
the JAX package's Pallas kernel, on the CPU.

The JAX side runs `gim_tpu.ops.pallas_kernels.dsmax.dual_softmax_mutual`
in interpret mode under highest matmul precision, as
tests/test_pallas_kernels.py runs it. The port's side runs the CPU path of
its wrapper (the kernel's plain sweeps plus the partial reductions that
the card path runs too) and its dense `dual_softmax_mutual_plain`.

Tolerance: indices exact; conf rtol 1e-4 (atol 1e-7), the JAX package's
own kernel tolerance — float32 throughout, the log-domain route and the
dense softmax differ only in rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.ops.pallas_kernels.dsmax import dual_softmax_mutual as j_dsmax
from gim_tpu_torch.ops.kernels import dsmax as K

T = 0.1


def _jax_batched(f0, f1, m0=None, m1=None):
    out = []
    with jax.default_matmul_precision("highest"):
        for b in range(f0.shape[0]):
            out.append(j_dsmax(
                jnp.asarray(f0[b]), jnp.asarray(f1[b]), T,
                None if m0 is None else jnp.asarray(m0[b]),
                None if m1 is None else jnp.asarray(m1[b]), block=128))
    return [np.stack([np.asarray(o[i]) for o in out]) for i in range(3)]


def _feats(rng, B, L, S, C):
    f0 = rng.standard_normal((B, L, C)).astype(np.float32)
    f1 = rng.standard_normal((B, S, C)).astype(np.float32)
    return f0, f1


def _check(got, want, rows=None):
    jb, cf, mu = (g.numpy() for g in got)
    wjb, wcf, wmu = want
    keep = np.ones_like(wmu, bool) if rows is None else rows
    np.testing.assert_array_equal(jb[keep], wjb[keep])
    np.testing.assert_array_equal(mu, wmu)
    np.testing.assert_allclose(cf, wcf, rtol=1e-4, atol=1e-7)


def _run(fn, f0, f1, m0=None, m1=None):
    t = torch.from_numpy
    return fn(t(f0), t(f1), T, None if m0 is None else t(m0),
              None if m1 is None else t(m1))


@pytest.mark.parametrize("fn", ["fused", "plain"])
@pytest.mark.parametrize("L,S,C,masked", [
    (70, 90, 32, False),      # L != S, one ragged row tile of 64
    (150, 130, 16, False),    # several row tiles, ragged
    (150, 130, 16, True),
    (64, 200, 32, True),      # exact row tile, wide S
])
def test_matches_jax_kernel(fn, L, S, C, masked):
    rng = np.random.default_rng(L * 7 + S + masked)
    f0, f1 = _feats(rng, 2, L, S, C)
    f0 /= np.sqrt(C)
    f1 /= np.sqrt(C)
    m0 = m1 = None
    if masked:
        m0 = rng.random((2, L)) > 0.25
        m1 = rng.random((2, S)) > 0.25
        m0[1, : L // 3] = False          # a masked run across a tile edge
    want = _jax_batched(f0, f1, m0, m1)
    port = K.dual_softmax_mutual if fn == "fused" else K.dual_softmax_mutual_plain
    got = _run(port, f0, f1, m0, m1)
    # j_best of an invalid row is not part of the contract
    _check(got, want, rows=m0)
    if masked:
        assert not got[2].numpy()[~m0].any()
        assert (got[1].numpy()[~m0] == 0).all()


def _separated(rng, B, L, C):
    """f1 is a permutation of f0 plus small noise: well-separated maxima."""
    f0 = rng.standard_normal((B, L, C)).astype(np.float32) / np.sqrt(C)
    perm = rng.permutation(L)
    f1 = f0[:, perm] + 0.01 * rng.standard_normal((B, L, C)).astype(
        np.float32) / np.sqrt(C)
    return f0, np.ascontiguousarray(f1), perm


def test_planted_column_tie_goes_to_first_index():
    rng = np.random.default_rng(21)
    f0, f1, perm = _separated(rng, 1, 140, 32)
    # f1[j] is a noisy copy of f0[perm[j]]; make column j2 a copy of
    # column j1 < j2 so row perm[j1] sees an exact tie between the two
    j1, j2 = 5, 100
    i1 = perm[j1]
    f1[0, j2] = f1[0, j1]
    want = _jax_batched(f0, f1)
    for port in (K.dual_softmax_mutual, K.dual_softmax_mutual_plain):
        got = _run(port, f0, f1)
        _check(got, want)
        assert got[0][0, i1] == j1
        assert bool(got[2][0, i1])


def test_planted_row_tie_goes_to_first_index():
    rng = np.random.default_rng(22)
    f0, f1, perm = _separated(rng, 1, 140, 32)
    i1, i2 = 3, 120                       # rows in different row tiles
    f0[0, i2] = f0[0, i1]
    want = _jax_batched(f0, f1)
    for port in (K.dual_softmax_mutual, K.dual_softmax_mutual_plain):
        got = _run(port, f0, f1)
        _check(got, want)
        # both rows pick the same column; only the first is its mutual match
        assert got[0][0, i1] == got[0][0, i2]
        assert bool(got[2][0, i1]) and not bool(got[2][0, i2])


def test_plain_sweeps_tile_layout():
    """The stats sweep's column partials reduce to the dense column
    statistics, whatever the row tiling."""
    rng = np.random.default_rng(23)
    f0, f1 = _feats(rng, 2, 100, 70, 16)
    t0, t1 = torch.from_numpy(f0), torch.from_numpy(f1)
    m0 = torch.ones(2, 100)
    m1 = torch.ones(2, 70)
    rmax, rsum, cpmax, cpsum = K.dsmax_stats(t0, t1, m0, m1, 1 / T)
    assert cpmax.shape == (2, 2, 70)                 # ceil(100 / 64) tiles
    sim = torch.einsum("blc,bsc->bls", t0, t1) / T
    cmax = cpmax.amax(1)
    csum = (cpsum * torch.exp(cpmax - cmax[:, None])).sum(1)
    torch.testing.assert_close(cmax, sim.amax(1))
    torch.testing.assert_close(cmax + torch.log(csum), torch.logsumexp(sim, 1))
    torch.testing.assert_close(rmax + torch.log(rsum), torch.logsumexp(sim, 2))


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    CPU path does not count launches."""
    before = dict(K.LAUNCHES)
    f = torch.empty((1, 64, 32), device="meta")
    m = torch.empty((1, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.dsmax_stats(f, f, m, m, 10.0)
    with pytest.raises(ValueError, match="CUDA"):
        K.dsmax_argmax(f, f, m, m, m, m, 10.0)
    rng = np.random.default_rng(24)
    f0, f1 = _feats(rng, 1, 30, 40, 16)
    _run(K.dual_softmax_mutual, f0, f1)
    assert K.LAUNCHES == before
