"""K1's float32 layout (row partials over chunks of S, 128-row blocks)
against the JAX package's Pallas kernel, on the CPU.

The float32 kernel cuts S into `chunks` runs of whole 128-column tiles
so that its blocks fill the card at one pair; each chunk leaves row
partials (B, chunks, L) that the wrapper merges (log-sum-exp for the
statistics, the first chunk holding the maximum for the argmax). On the
CPU the wrapper hands the same chunk count to the plain sweeps, so these
tests run the layout that the card runs. The JAX side runs
`gim_tpu.ops.pallas_kernels.dsmax.dual_softmax_mutual` in interpret mode
under highest matmul precision, as tests/test_pallas_kernels.py runs it.

Tolerances, float32 throughout: indices and mutual flags exact; conf
rtol 1e-4 (atol 1e-7), the JAX package's own kernel tolerance (the
log-domain route and the dense softmax differ only in rounding); a merged
log-sum-exp against the unchunked sweep within 1e-5 of the logs (a few
float32 roundings of values of order 10), an argmax merged from chunks
exactly equal to the unchunked one (maxima are exact).
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
    f0 = rng.standard_normal((B, L, C)).astype(np.float32) / np.sqrt(C)
    f1 = rng.standard_normal((B, S, C)).astype(np.float32) / np.sqrt(C)
    return f0, f1


def _port(f0, f1, m0=None, m1=None, chunks=None):
    t = torch.from_numpy
    return K.dual_softmax_mutual(t(f0), t(f1), T,
                                 None if m0 is None else t(m0),
                                 None if m1 is None else t(m1),
                                 chunks=chunks)


def _check(got, want, rows=None):
    jb, cf, mu = (g.numpy() for g in got)
    wjb, wcf, wmu = want
    keep = np.ones_like(wmu, bool) if rows is None else rows
    np.testing.assert_array_equal(jb[keep], wjb[keep])
    np.testing.assert_array_equal(mu, wmu)
    np.testing.assert_allclose(cf, wcf, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("L,S,C,masked", [
    (70, 300, 8, False),      # narrowest C; one ragged row block
    (150, 330, 32, True),     # two row blocks, ragged L and S
    (260, 290, 256, True),    # three row blocks at the main-path width
    (130, 513, 256, False),   # S one column past four tiles
])
def test_float32_layout_matches_jax_kernel(L, S, C, masked, chunks):
    rng = np.random.default_rng(L + 3 * S + C + masked)
    f0, f1 = _feats(rng, 2, L, S, C)
    m0 = m1 = None
    if masked:
        m0 = rng.random((2, L)) > 0.25
        m1 = rng.random((2, S)) > 0.25
        m1[1, 120:140] = False           # a masked run across a tile edge
    want = _jax_batched(f0, f1, m0, m1)
    got = _port(f0, f1, m0, m1, chunks)
    # j_best of an invalid row is not part of the contract
    _check(got, want, rows=m0)


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_sweeps_merge_to_the_whole_sweep(masked):
    """The plain sweeps' row partials over 3 chunks merge to the sweep over
    all of S; the column partials do not depend on the chunks."""
    rng = np.random.default_rng(31 + masked)
    f0, f1 = (torch.from_numpy(a) for a in _feats(rng, 2, 200, 700, 32))
    m0 = torch.ones(2, 200)
    m1 = torch.ones(2, 700)
    if masked:
        m1 = torch.from_numpy((rng.random((2, 700)) > 0.3).astype(
            np.float32))
        m1[0, :300] = 0.0             # chunk 0 of row 0 wholly masked
    one = K.dsmax_stats_plain(f0, f1, m0, m1, 1 / T, chunks=1)
    three = K.dsmax_stats_plain(f0, f1, m0, m1, 1 / T, chunks=3)
    assert three[0].shape == (2, 3, 200) and one[0].shape == (2, 1, 200)
    rmax, rsum = K.merge_row_stats(three[0], three[1])
    torch.testing.assert_close(rmax, one[0][:, 0], rtol=0, atol=0)
    torch.testing.assert_close(rmax + rsum.log(),
                               one[0][:, 0] + one[1][:, 0].log(), rtol=0,
                               atol=1e-5)
    for a, b in zip(one[2:], three[2:]):
        assert torch.equal(a, b)
    rowterm = rmax + rsum.log()
    colterm = torch.randn(2, 700, generator=torch.Generator().manual_seed(0))
    a1 = K.dsmax_argmax_plain(f0, f1, m0, m1, colterm, rowterm, 1 / T,
                              chunks=1)
    a3 = K.dsmax_argmax_plain(f0, f1, m0, m1, colterm, rowterm, 1 / T,
                              chunks=3)
    jb, jv = K.merge_row_argmax(a3[0], a3[1])
    assert torch.equal(jb, a1[0][:, 0]) and torch.equal(jv, a1[1][:, 0])
    for a, b in zip(a1[2:], a3[2:]):
        assert torch.equal(a, b)
    # every chunk's index lies in its own columns
    span = K.chunk_span(700, 3)
    for c in range(3):
        idx = a3[0][:, c]
        assert bool(((idx >= c * span) & (idx < (c + 1) * span)).all())


def _separated(rng, L, C):
    """f1 is a permutation of f0 plus small noise: well-separated maxima."""
    f0 = rng.standard_normal((1, L, C)).astype(np.float32) / np.sqrt(C)
    perm = rng.permutation(L)
    f1 = f0[:, perm] + 0.01 * rng.standard_normal((1, L, C)).astype(
        np.float32) / np.sqrt(C)
    return f0, np.ascontiguousarray(f1), perm


@pytest.mark.parametrize("chunks", [2, 3])
def test_planted_column_tie_across_a_chunk_border(chunks):
    """A row whose two best columns lie in different chunks takes the
    first; a lower chunk's equal maximum wins the merge."""
    rng = np.random.default_rng(41)
    f0, f1, perm = _separated(rng, 520, 32)
    span = K.chunk_span(520, chunks)
    j1, j2 = 7, span + 20                 # chunks 0 and 1
    f1[0, j2] = f1[0, j1]
    row = perm[j1]
    want = _jax_batched(f0, f1)
    got = _port(f0, f1, chunks=chunks)
    _check(got, want)
    assert int(got[0][0, row]) == j1 and bool(got[2][0, row])


@pytest.mark.parametrize("chunks", [1, 3])
def test_planted_row_tie_across_a_row_block_border(chunks):
    """Two equal rows in different 128-row blocks: the column's partials
    tie and the first row is the column's best, so only it is mutual."""
    rng = np.random.default_rng(42)
    f0, f1, perm = _separated(rng, 520, 32)
    i1, i2 = 100, 300                     # row blocks 0 and 2
    f0[0, i2] = f0[0, i1]
    want = _jax_batched(f0, f1)
    got = _port(f0, f1, chunks=chunks)
    _check(got, want)
    assert int(got[0][0, i1]) == int(got[0][0, i2])
    assert bool(got[2][0, i1]) and not bool(got[2][0, i2])


def test_sweep_chunks_fills_the_card_at_zeb():
    """ZEB's (1, 11025, 11025) on 132 SMs: 87 row blocks x 3 chunks of 29
    tiles, 261 blocks, a last wave 3 blocks short of full; bf16 sweeps all
    of S in one chunk; no chunk count leaves a chunk empty."""
    assert K.sweep_chunks(torch.float32, 1, 11025, 11025, 132) == 3
    assert K.chunk_span(11025, 3) == 29 * 128
    n = 87 * 3
    assert n % 132 >= 0.9 * 132
    assert K.sweep_chunks(torch.bfloat16, 1, 11025, 11025, 132) == 1
    for S in (1, 127, 129, 300, 11025):
        for L in (1, 300, 11025):
            for B in (1, 8):
                n = K.sweep_chunks(torch.float32, B, L, S, 132)
                assert -(-S // K.chunk_span(S, n)) == n


def _kernel_inputs(B, L, S, C, dtype=torch.float32):
    f0 = torch.zeros(B, L, C, dtype=dtype)
    f1 = torch.zeros(B, S, C, dtype=dtype)
    return f0, f1, torch.ones(B, L), torch.ones(B, S)


@pytest.mark.parametrize("S,chunks,grid", [
    (11025, None, (87 * 3, 1)),   # the wrapper's choice at ZEB's shape
    (11025, 1, (87, 1)),
    (11025, 8, (87 * 8, 1)),      # 11 tiles a chunk, the last 10
    (300, 3, (87 * 3, 1)),        # one tile a chunk, the last ragged
])
def test_kernel_args_float32_grid(S, chunks, grid):
    f0, f1, m0, m1 = _kernel_inputs(1, 11025, S, 256)
    args = K.kernel_args(f0, f1, m0, m1, chunks=chunks)
    assert args.block == 128 and args.grid == grid
    assert args.chunks == grid[0] // 87


@pytest.mark.parametrize("case", [
    "zero chunks",
    "empty chunk",        # 4 chunks of 300 columns: 3 tiles, one left over
    "bf16 in chunks",     # the bf16 kernel sweeps all of S
])
def test_kernel_args_refuses_chunks(case):
    dtype = torch.bfloat16 if case == "bf16 in chunks" else torch.float32
    f0, f1, m0, m1 = _kernel_inputs(1, 200, 300, 64, dtype)
    chunks = {"zero chunks": 0, "empty chunk": 4, "bf16 in chunks": 2}[case]
    with pytest.raises(ValueError, match="chunks"):
        K.kernel_args(f0, f1, m0, m1, chunks=chunks)
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="chunks"):
            K.dsmax_stats(f0, f1, m0, m1, 1 / T, chunks=chunks)
