"""Training losses of gim_tpu_torch against gim_tpu.train.losses, on the CPU.

Same seeded inputs through both packages. Tolerances: the GT matrices
exactly (labels on whole and half pixels, so every sum is exact); each
loss and its gradient within rtol 1e-5 (float32 sums in another order).
Planted duplicate labels in one cell check the scatter's reduction: max
for the coarse target (a cell hit twice is 1, not 2), sum and count for
the fine target.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.train import losses as JL
from gim_tpu_torch.train import losses as TL

HW = (6, 8)          # coarse grid of a 48 x 64 image at scale 8
SCALE = 8


def _labels(rng, B=2, N=40, dup=True):
    """Labels on half pixels inside a 48 x 64 image; with `dup`, labels 0-2
    of each pair share one coarse cell pair; a few are padded."""
    xy0 = rng.integers(0, 2 * 64, (B, N, 1)) / 2.0
    y0 = rng.integers(0, 2 * 48, (B, N, 1)) / 2.0
    xy1 = rng.integers(0, 2 * 64, (B, N, 1)) / 2.0
    y1 = rng.integers(0, 2 * 48, (B, N, 1)) / 2.0
    lab = np.concatenate([xy0, y0, xy1, y1], -1).astype(np.float32)
    if dup:
        lab[:, 0:3] = [[17.0, 9.5, 40.0, 30.0], [19.5, 12.0, 44.5, 25.0],
                       [23.0, 15.5, 47.0, 31.5]]
    valid = rng.random((B, N)) < 0.85
    valid[:, 0:3] = True
    return lab, valid


def test_coarse_gt_scatter_max_with_duplicates():
    lab, valid = _labels(np.random.default_rng(0))
    want = np.asarray(JL.coarse_gt_from_labels(jnp.asarray(lab),
                                               jnp.asarray(valid), HW, SCALE))
    got = TL.coarse_gt_from_labels(torch.from_numpy(lab),
                                   torch.from_numpy(valid), HW, SCALE)
    np.testing.assert_array_equal(got.numpy(), want)
    L = HW[0] * HW[1]
    i, j = 1 * 8 + 2, 3 * 8 + 5          # the planted cells (x0 // 8, ...)
    assert got.shape == (2, L, L) and got[0, i, j] == 1.0
    assert got.max() == 1.0


def test_coarse_gt_padded_labels_leave_cell_zero():
    lab = np.zeros((1, 4, 4), np.float32)       # all at pixel 0 -> cell 0
    valid = np.zeros((1, 4), bool)
    got = TL.coarse_gt_from_labels(torch.from_numpy(lab),
                                   torch.from_numpy(valid), HW, SCALE)
    assert got.sum() == 0


def test_fine_gt_sums_and_counts_duplicates():
    rng = np.random.default_rng(1)
    lab, valid = _labels(rng)
    M = 10
    i_ids = rng.integers(0, HW[0] * HW[1], (2, M)).astype(np.int32)
    i_ids[:, 0] = 1 * 8 + 2                       # the planted cell
    mk1 = (rng.integers(0, 16, (2, M, 2)) * 4.0).astype(np.float32)
    want = JL.fine_gt_from_labels(jnp.asarray(lab), jnp.asarray(valid),
                                  jnp.asarray(i_ids), jnp.asarray(mk1),
                                  HW, SCALE, 4.0)
    got = TL.fine_gt_from_labels(torch.from_numpy(lab),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(i_ids),
                                 torch.from_numpy(mk1), HW, SCALE, 4.0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # the planted cell: centroids of its valid labels (the 3 planted ones
    # and any random one that fell there)
    cell = (lab[0, :, 1] // 8) * 8 + lab[0, :, 0] // 8
    inside = valid[0] & (cell == 1 * 8 + 2)
    assert inside.sum() >= 3
    c0 = lab[0, inside, :2].mean(0)
    c1 = lab[0, inside, 2:].mean(0)
    gt = (c1 + np.array([2 * 8, 1 * 8]) - c0 - mk1[0, 0]) / 4.0
    np.testing.assert_allclose(got[0][0, 0].numpy(), gt, rtol=1e-6)


@pytest.mark.parametrize("with_valid", [False, True])
def test_coarse_focal_loss_and_gradient(with_valid):
    rng = np.random.default_rng(2)
    lab, valid = _labels(rng)
    conf_gt = np.asarray(JL.coarse_gt_from_labels(
        jnp.asarray(lab), jnp.asarray(valid), HW, SCALE))
    L = HW[0] * HW[1]
    conf = rng.random((2, L, L)).astype(np.float32) ** 4
    conf[0, 0, :4] = 0.0                          # the clamp's regime
    cell_valid = rng.random((2, L, L)) < 0.9 if with_valid else None
    kw = dict(alpha=0.25, gamma=2.0, pos_weight=1.0, neg_weight=0.7)

    def jf(c):
        return JL.coarse_focal_loss(
            c, jnp.asarray(conf_gt), **kw,
            valid=None if cell_valid is None else jnp.asarray(cell_valid))

    want, wgrad = jax.value_and_grad(jf)(jnp.asarray(conf))
    ct = torch.from_numpy(conf).requires_grad_()
    got = TL.coarse_focal_loss(
        ct, torch.from_numpy(conf_gt), **kw,
        valid=None if cell_valid is None else torch.from_numpy(cell_valid))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(wgrad), rtol=1e-5,
                               atol=1e-5 * np.abs(wgrad).max())


def _fine_inputs(rng, B=2, M=24):
    expec = np.concatenate([rng.uniform(-1, 1, (B, M, 2)),
                            rng.uniform(0.05, 1.0, (B, M, 1))],
                           -1).astype(np.float32)
    gt = rng.uniform(-1.4, 1.4, (B, M, 2)).astype(np.float32)
    valid = rng.random((B, M)) < 0.7
    return expec, gt, valid


def test_fine_l2_std_loss_and_gradient():
    expec, gt, valid = _fine_inputs(np.random.default_rng(3))

    def jf(e):
        return JL.fine_l2_std_loss(e, jnp.asarray(gt), jnp.asarray(valid),
                                   1.0)

    want, wgrad = jax.value_and_grad(jf)(jnp.asarray(expec))
    et = torch.from_numpy(expec).requires_grad_()
    got = TL.fine_l2_std_loss(et, torch.from_numpy(gt),
                              torch.from_numpy(valid), 1.0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(wgrad), rtol=1e-5,
                               atol=1e-7)
    assert float(et.grad[..., 2].abs().max()) == 0.0    # weight: no gradient


def test_fine_weight_is_normalised_over_all_slots():
    """The std of a slot that does not count still moves the loss: the
    inverse-std weight is divided by its mean over all (B, M) slots."""
    expec, gt, valid = _fine_inputs(np.random.default_rng(4))
    gt[:] = 0.1                                    # every slot in-window
    off = np.argwhere(~valid)[0]
    moved = expec.copy()
    moved[off[0], off[1], 2] *= 0.25
    for e in (expec, moved):
        want = JL.fine_l2_std_loss(jnp.asarray(e), jnp.asarray(gt),
                                   jnp.asarray(valid), 1.0)
        got = TL.fine_l2_std_loss(torch.from_numpy(e), torch.from_numpy(gt),
                                  torch.from_numpy(valid), 1.0)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    a = TL.fine_l2_std_loss(torch.from_numpy(expec), torch.from_numpy(gt),
                            torch.from_numpy(valid), 1.0)
    b = TL.fine_l2_std_loss(torch.from_numpy(moved), torch.from_numpy(gt),
                            torch.from_numpy(valid), 1.0)
    assert float(b) < float(a)


def test_lightglue_nll_loss_and_gradient():
    rng = np.random.default_rng(5)
    B, L, S = 2, 12, 15
    la = np.log(rng.dirichlet(np.ones(S + 1), (B, L + 1))).astype(np.float32)
    gt = rng.integers(-1, S, (B, L)).astype(np.int32)
    v0 = rng.random((B, L)) < 0.8
    v1 = np.ones((B, S), bool)

    def jf(a):
        return JL.lightglue_nll_loss(a, jnp.asarray(gt), jnp.asarray(v0),
                                     jnp.asarray(v1))

    want, wgrad = jax.value_and_grad(jf)(jnp.asarray(la))
    at = torch.from_numpy(la).requires_grad_()
    got = TL.lightglue_nll_loss(at, torch.from_numpy(gt),
                                torch.from_numpy(v0), torch.from_numpy(v1))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(wgrad), rtol=1e-5,
                               atol=1e-8)
