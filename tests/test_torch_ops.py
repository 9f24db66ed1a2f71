"""gim_tpu_torch ops against gim_tpu on the CPU, float32.

Inputs come from numpy seeds and go through both packages. Tolerance:
rtol 1e-5 (with an absolute floor of 1e-6 for values near zero) — both
sides compute in float32 and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.ops import attention as jatt
from gim_tpu.ops import matching as jmatch
from gim_tpu.ops.windows import extract_windows_batch as j_windows
from gim_tpu_torch.ops import attention as tatt
from gim_tpu_torch.ops import matching as tmatch
from gim_tpu_torch.ops.windows import extract_windows_batch as t_windows

HIGH = jax.default_matmul_precision("highest")
RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


def _qkv(rng, N, L, S, H, D):
    q = rng.standard_normal((N, L, H, D)).astype(np.float32)
    k = rng.standard_normal((N, S, H, D)).astype(np.float32)
    v = rng.standard_normal((N, S, H, D)).astype(np.float32)
    return q, k, v


def _masks(rng, N, L, S):
    qm = rng.random((N, L)) > 0.3
    km = rng.random((N, S)) > 0.3
    return qm, km


@pytest.mark.parametrize("L,S,masked", [
    (25, 25, False),     # short-sequence regime (fine windows)
    (25, 25, True),
    (100, 130, False),   # long-sequence regime (coarse grid)
    (100, 130, True),
])
def test_linear_attention_matches_head_form(L, S, masked):
    rng = np.random.default_rng(L + S + masked)
    q, k, v = _qkv(rng, 2, L, S, 4, 8)
    qm, km = _masks(rng, 2, L, S) if masked else (None, None)
    with HIGH:
        want = jatt.linear_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if qm is None else jnp.asarray(qm),
            None if km is None else jnp.asarray(km))
    got = tatt.linear_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if qm is None else torch.from_numpy(qm),
        None if km is None else torch.from_numpy(km))
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_linear_attention_matches_channel_form(masked):
    """The port's one form stands for linear_attention_chan too."""
    rng = np.random.default_rng(7 + masked)
    N, L, S, H, D = 2, 90, 120, 8, 4
    q, k, v = _qkv(rng, N, L, S, H, D)
    qm, km = _masks(rng, N, L, S) if masked else (None, None)
    with HIGH:
        want = jatt.linear_attention_chan(
            jnp.asarray(q.reshape(N, L, H * D)),
            jnp.asarray(k.reshape(N, S, H * D)),
            jnp.asarray(v.reshape(N, S, H * D)), H,
            None if qm is None else jnp.asarray(qm),
            None if km is None else jnp.asarray(km))
    got = tatt.linear_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if qm is None else torch.from_numpy(qm),
        None if km is None else torch.from_numpy(km))
    _close(got.reshape(N, L, H * D), want)


@pytest.mark.parametrize("masked", [False, True])
def test_full_attention(masked):
    rng = np.random.default_rng(3 + masked)
    q, k, v = _qkv(rng, 2, 20, 30, 2, 8)
    qm, km = _masks(rng, 2, 20, 30) if masked else (None, None)
    with HIGH:
        want = jatt.full_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if qm is None else jnp.asarray(qm),
            None if km is None else jnp.asarray(km))
    got = tatt.full_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if qm is None else torch.from_numpy(qm),
        None if km is None else torch.from_numpy(km))
    _close(got, want)


def test_extract_windows_including_borders():
    rng = np.random.default_rng(11)
    B, H, W, C, stride, window = 2, 12, 16, 8, 4, 5
    feat = rng.standard_normal((B, H, W, C)).astype(np.float32)
    Wc, Hc = W // stride, H // stride
    # corners and edges of the coarse grid (windows cross the border) plus
    # interior cells
    centers = np.array([[0, Wc - 1, (Hc - 1) * Wc, Hc * Wc - 1, 5, 6],
                        [1, Wc, 2 * Wc - 1, 7, 0, 9]], np.int32)
    want = j_windows(jnp.asarray(feat), jnp.asarray(centers),
                     window=window, stride=stride)
    got = t_windows(torch.from_numpy(feat), torch.from_numpy(centers),
                    window=window, stride=stride)
    assert got.shape == (B, centers.shape[1], window * window, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the corner window is zero-padded like F.unfold
    assert (got[0, 0, 0] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_dual_softmax(masked):
    rng = np.random.default_rng(5 + masked)
    sim = rng.standard_normal((2, 30, 40)).astype(np.float32)
    m0, m1 = _masks(rng, 2, 30, 40) if masked else (None, None)
    want = jmatch.dual_softmax(jnp.asarray(sim), 0.1,
                               None if m0 is None else jnp.asarray(m0),
                               None if m1 is None else jnp.asarray(m1))
    got = tmatch.dual_softmax(torch.from_numpy(sim), 0.1,
                              None if m0 is None else torch.from_numpy(m0),
                              None if m1 is None else torch.from_numpy(m1))
    _close(got, want)


def _planted_conf(rng, N, hc, wc):
    """A dual-softmax conf matrix with strong planted matches plus noise,
    so that many cells pass the threshold and are mutual."""
    L = hc * wc
    f0 = rng.standard_normal((N, L, 16)).astype(np.float32)
    perm = rng.permutation(L)
    f1 = f0[:, perm] + 0.3 * rng.standard_normal((N, L, 16)).astype(
        np.float32)
    sim = np.einsum("nlc,nsc->nls", f0, f1) / 4.0
    return jmatch.dual_softmax(jnp.asarray(sim), 0.1)


@pytest.mark.parametrize("padded,max_matches", [
    (False, 40), (True, 40), (False, 200)])   # 200 > L: zero-padded slots
def test_mutual_topk_matches(padded, max_matches):
    rng = np.random.default_rng(13)
    N, hc, wc = 2, 8, 10
    conf = np.array(_planted_conf(rng, N, hc, wc))
    true_hw = np.array([[7, 9], [6, 10]], np.int32) if padded else None
    kw = dict(hw0_c=(hc, wc), hw1_c=(hc, wc), threshold=0.05, border=1,
              max_matches=max_matches)
    want = jmatch.mutual_topk_matches(
        jnp.asarray(conf), **kw,
        true_hw0=None if true_hw is None else jnp.asarray(true_hw),
        true_hw1=None if true_hw is None else jnp.asarray(true_hw))
    got = tmatch.mutual_topk_matches(
        torch.from_numpy(conf), **kw,
        true_hw0=None if true_hw is None else torch.from_numpy(true_hw),
        true_hw1=None if true_hw is None else torch.from_numpy(true_hw))
    assert int(np.asarray(want["valid"]).sum()) >= 8
    for key in ("i_ids", "j_ids", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    _close(got["mconf"], want["mconf"])


def test_fine_expectation():
    rng = np.random.default_rng(17)
    f0 = rng.standard_normal((50, 25, 32)).astype(np.float32)
    f1 = rng.standard_normal((50, 25, 32)).astype(np.float32)
    with HIGH:
        wc, ws = jmatch.fine_expectation(jnp.asarray(f0), jnp.asarray(f1))
    gc, gs = tmatch.fine_expectation(torch.from_numpy(f0),
                                     torch.from_numpy(f1))
    _close(gc, wc)
    _close(gs, ws)


@pytest.mark.parametrize("batched_scale", [False, True])
def test_cells_to_kpts(batched_scale):
    rng = np.random.default_rng(19)
    ids = rng.integers(0, 12 * 15, size=(2, 30)).astype(np.int32)
    scale = (rng.uniform(0.5, 2.0, (2, 1, 2)).astype(np.float32) * 8.0
             if batched_scale else 8.0)
    want = jmatch.cells_to_kpts(jnp.asarray(ids), 15,
                                jnp.asarray(scale) if batched_scale else scale)
    got = tmatch.cells_to_kpts(torch.from_numpy(ids), 15,
                               torch.from_numpy(scale) if batched_scale
                               else scale)
    _close(got, want)
