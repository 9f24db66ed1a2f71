"""The dense matchers' training losses in gim_tpu_torch against
gim_tpu's (`train/dense_losses.py`), on the same numpy-seeded inputs, on
the CPU, within rtol 1e-6 except where JAX's own rounding is larger.

The inputs are float64 (JAX under x64). JAX's balanced BCE pins its class
weights to float32 in any dtype (`pos_mask.astype(jnp.float32)`) and XLA
sums their 360 entries here with an error of 4.4e-6 of the sum, so the
port is held to an exact float64 evaluation in numpy at rtol 1e-12 and to
JAX at rtol 1e-5; so is every value the BCE reaches (the total of
`dense_warp_loss` and the certainty's gradient). `dense_warp_loss` is
also held in float32, at rtol 2e-5.

- `scatter_sparse_warp`: the per-cell mean target, the count mask, labels
  clipped at the grid's edge, padded labels ignored; cells holding one
  label and cells holding several (the sums are order-free up to
  rounding, so the means agree within rtol 1e-6 and the mask exactly);
- `_charbonnier`; `_balanced_bce` (optax's sigmoid_binary_cross_entropy
  at large logits of both signs, where the stable form matters) against
  numpy and JAX as above;
- `_anchor_cls_loss` at a target grid of 8 x 8 anchors;
- `dense_warp_loss` over a symmetric 2B batch in gim_dkm's layout (six
  scales, "dense_flow" / "dense_certainty") and gim_roma's (five scales,
  "flow" / "certainty", the anchor logits at 16): the total, every
  per-scale flow loss, and the gradient of the total with respect to
  every flow and anchor logit within 1e-6 of each leaf's largest
  magnitude (2e-5 in float32), and of every certainty within 1e-4: it is
  divided by JAX's float32 sum of the class weights, off by up to 3.3e-5
  at the 12288 cells of scale 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.train import dense_losses as JD
from gim_tpu_torch.train import dense_losses as TD

IN_HW = (48, 64)
# gradient bounds, of each leaf's largest magnitude: flows and anchor
# logits (float32, float64); certainties, which carry JAX's float32 sum of
# the BCE's class weights (3.3e-5 of the largest entry at 12288 cells)
GRAD = {False: 2e-5, True: 1e-6}
GRAD_CERT = 1e-4


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


def _labels(rng, B, N, hw=IN_HW):
    H, W = hw
    p0 = rng.uniform([-3, -3], [W + 3, H + 3], (B, N, 2))  # some outside
    p1 = p0 + rng.normal(0, 4, (B, N, 2))
    return (np.concatenate([p0, p1], -1), rng.random((B, N)) < 0.8)


@pytest.mark.parametrize("hs,ws,N", [(6, 8, 20), (12, 16, 400)],
                         ids=["sparse", "crowded"])
def test_scatter_sparse_warp_matches_jax(hs, ws, N):
    lab, lv = _labels(np.random.default_rng(hs), 2, N)
    gf, gm = JD.scatter_sparse_warp(jnp.asarray(lab), jnp.asarray(lv),
                                    IN_HW, hs, ws)
    tf, tm = TD.scatter_sparse_warp(torch.from_numpy(lab),
                                    torch.from_numpy(lv), IN_HW, hs, ws)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(gm))
    np.testing.assert_allclose(tf.numpy(), np.asarray(gf), rtol=1e-6,
                               atol=1e-7)
    assert 0 < tm.sum() < tm.numel()


def test_charbonnier_and_balanced_bce_match_jax():
    rng = np.random.default_rng(1)
    d = rng.normal(0, 0.3, (3, 10, 12, 2))
    d[0, 0, 0] = 0.0
    np.testing.assert_allclose(TD._charbonnier(torch.from_numpy(d)).numpy(),
                               np.asarray(JD._charbonnier(jnp.asarray(d))),
                               rtol=1e-6, atol=1e-9)
    logits = rng.normal(0, 3, (3, 10, 12))
    logits[0, :2] = [[40.0] * 12, [-40.0] * 12]          # saturated
    for share in (0.05, 0.5):
        pos = rng.random((3, 10, 12)) < share
        got = float(TD._balanced_bce(torch.from_numpy(logits),
                                     torch.from_numpy(pos)))
        p = pos.astype(np.float64)
        ll = p * np.logaddexp(0, -logits) + (1 - p) * np.logaddexp(0, logits)
        w = p + (1 - p) * (p.sum() / (1 - p).sum())
        np.testing.assert_allclose(got, (ll * w).sum() / w.sum(), rtol=1e-12)
        np.testing.assert_allclose(
            got, float(JD._balanced_bce(jnp.asarray(logits),
                                        jnp.asarray(pos))), rtol=1e-5)


def test_anchor_cls_loss_matches_jax():
    rng = np.random.default_rng(2)
    res = 8
    cls = rng.normal(0, 2, (4, 5, 6, res * res))
    gt = rng.uniform(-1.1, 1.1, (4, 5, 6, 2))
    m = rng.random((4, 5, 6)) < 0.6
    np.testing.assert_allclose(
        float(TD._anchor_cls_loss(*map(torch.from_numpy, (cls, gt, m)), res)),
        float(JD._anchor_cls_loss(*map(jnp.asarray, (cls, gt, m)), res)),
        rtol=1e-6)


def _corresps(rng, B, roma: bool, dtype):
    """Random per-scale predictions of a symmetric 2B batch on a 48 x 64
    input: gim_dkm's keys at strides 32 .. 1, or gim_roma's at 16 .. 1
    with 8 x 8 anchor logits at 16."""
    fk, ck = ("flow", "certainty") if roma else ("dense_flow",
                                                 "dense_certainty")
    out = {}
    for s in ((16, 8, 4, 2, 1) if roma else (32, 16, 8, 4, 2, 1)):
        h, w = max(IN_HW[0] // s, 1), max(IN_HW[1] // s, 1)
        d = {fk: rng.uniform(-1, 1, (2 * B, h, w, 2)),
             ck: rng.normal(0, 2, (2 * B, h, w, 1))}
        if roma and s == 16:
            d["gm_cls"] = rng.normal(0, 2, (2 * B, h, w, 64))
        out[s] = {k: v.astype(dtype) for k, v in d.items()}
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("roma", [False, True], ids=["dkm", "roma"])
def test_dense_warp_loss_and_gradient_match_jax(roma, dtype):
    rng = np.random.default_rng(3 + roma)
    B = 2
    corr = _corresps(rng, B, roma, dtype)
    lab, lv = _labels(rng, B, 300)
    lab = lab.astype(dtype)
    rtol = 1e-5 if dtype == np.float64 else 2e-5
    kw = dict(roma_cls=roma, cls_res=8)

    def jloss(c):
        return JD.dense_warp_loss(c, jnp.asarray(lab), jnp.asarray(lv),
                                  IN_HW, **kw)

    (want, wlogs), wgrad = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, corr))
    tc = {s: {k: torch.from_numpy(v).requires_grad_() for k, v in d.items()}
          for s, d in corr.items()}
    got, logs = TD.dense_warp_loss(tc, torch.from_numpy(lab),
                                   torch.from_numpy(lv), IN_HW, **kw)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    assert set(logs) == set(wlogs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(wlogs[k]),
                                   rtol=rtol, err_msg=k)
    for s, d in tc.items():
        for k, t in d.items():
            w = np.asarray(wgrad[s][k])
            assert t.grad.dtype == torch.from_numpy(w).dtype
            tol = (GRAD_CERT if "certainty" in k
                   else GRAD[dtype == np.float64])
            np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=f"{s} {k}")
