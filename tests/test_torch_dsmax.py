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
    (300, 129, 256, True),    # main-path width; L, S not multiples of 128
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


@pytest.mark.parametrize("dtype,n_blocks", [
    (torch.bfloat16, 3),      # ceil(300 / 128): the wgmma kernel's blocks
    (torch.float32, 3),       # ceil(300 / 128): the SIMT kernel's
])
def test_plain_sweeps_tile_layout(dtype, n_blocks):
    """The stats sweep's column partials come in the kernel's row blocks
    for the features' dtype, and reduce to the dense column statistics."""
    rng = np.random.default_rng(23)
    f0, f1 = _feats(rng, 2, 300, 70, 16)
    t0, t1 = torch.from_numpy(f0).to(dtype), torch.from_numpy(f1).to(dtype)
    m0 = torch.ones(2, 300)
    m1 = torch.ones(2, 70)
    rmax, rsum, cpmax, cpsum = K.dsmax_stats(t0, t1, m0, m1, 1 / T)
    assert cpmax.shape == (2, n_blocks, 70)
    assert K.block_rows(dtype) * (n_blocks - 1) < 300 <= \
        K.block_rows(dtype) * n_blocks
    sim = torch.einsum("blc,bsc->bls", t0.float(), t1.float()) / T
    cmax = cpmax.amax(1)
    csum = (cpsum * torch.exp(cpmax - cmax[:, None])).sum(1)
    torch.testing.assert_close(cmax, sim.amax(1))
    torch.testing.assert_close(cmax + torch.log(csum), torch.logsumexp(sim, 1))
    torch.testing.assert_close(rmax + torch.log(rsum), torch.logsumexp(sim, 2))


def _kernel_inputs(B, L, S, C, dtype=torch.bfloat16):
    f0 = torch.zeros(B, L, C, dtype=dtype)
    f1 = torch.zeros(B, S, C, dtype=dtype)
    return f0, f1, torch.ones(B, L), torch.ones(B, S)


@pytest.mark.parametrize("C", [16, 32, 64, 256])
def test_kernel_args_accepts(C):
    """Any C that is a multiple of 8 up to 256 (narrow widths are read
    through a zero-filled 64-column box), bf16 in 128-row blocks over all
    of S; float32 in 128-row blocks times the chunks of S that fill the
    card (S = 129: two 128-column tiles, one chunk each)."""
    f0, f1, m0, m1 = _kernel_inputs(2, 300, 129, C)
    args = K.kernel_args(f0, f1, m0, m1)
    assert args == (2, 300, 129, C, 128, (3, 2), 1, 1)
    terms = (torch.zeros(2, 129), torch.zeros(2, 300))
    assert K.kernel_args(f0, f1, m0, m1, *terms) == args
    f32 = _kernel_inputs(2, 300, 129, C, torch.float32)
    assert K.kernel_args(*f32).grid == (6, 2)
    assert K.kernel_args(*f32).chunks == 2


@pytest.mark.parametrize("case,err", [
    ("C=12", ValueError),           # not a multiple of 8 (TMA's 16 bytes)
    ("C=264", ValueError),          # wider than the shared memory holds
    ("sliced f0", ValueError),      # non-contiguous: nothing is copied
    ("float16", TypeError),
    ("terms swapped", ValueError),
    ("misaligned base", ValueError),  # TMA reads from 16-byte aligned bases
])
def test_kernel_args_refuses(case, err):
    f0, f1, m0, m1 = _kernel_inputs(2, 100, 90, 64)
    terms = ()
    if case == "C=12":
        f0, f1, m0, m1 = _kernel_inputs(2, 100, 90, 12)
    elif case == "C=264":
        f0, f1, m0, m1 = _kernel_inputs(2, 100, 90, 264)
    elif case == "sliced f0":
        f0 = torch.zeros(2, 100, 128, dtype=torch.bfloat16)[:, :, :64]
    elif case == "float16":
        f0, f1 = f0.half(), f1.half()
    elif case == "misaligned base":
        f0 = torch.zeros(2 * 100 * 64 + 1, dtype=torch.bfloat16)[1:].view(
            2, 100, 64)
    else:
        terms = (torch.zeros(2, 100), torch.zeros(2, 90))
    with pytest.raises(err):
        K.kernel_args(f0, f1, m0, m1, *terms)


@pytest.mark.parametrize("name", ["dsmax", "flash"])
def test_library_path_covers_the_shared_header(name, tmp_path, monkeypatch):
    """An edited csrc/hopper.cuh gives a new library path, so a stale
    build of a source that includes it is never loaded."""
    from gim_tpu_torch.ops.kernels import build

    for f in (f"{name}.cu", "hopper.cuh"):
        (tmp_path / f).write_bytes((build.CSRC / f).read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert tmp_path / "hopper.cuh" in build._inputs(name)
    before = build.library_path(name)
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    assert build.library_path(name) != before


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
