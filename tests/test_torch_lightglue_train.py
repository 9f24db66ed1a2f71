"""gim_lightglue's joint training in gim_tpu_torch against gim_tpu's, on
the CPU.

- `assign_gt_matches` exactly (first index on ties, padded labels and
  keypoints, the 3 px threshold);
- the SuperPoint losses within rtol 1e-6: the detector CE on end points
  that fall one to a cell; where several fall in one cell, the port's
  target is the last of them, held against JAX's loss on the labels with
  only that last one kept (JAX's scatter fixes no order there); the
  descriptor InfoNCE with padded labels and close negatives;
- `lightglue_loss` and one joint step (`lightglue_train_step`: SuperPoint
  at full width, 256-d, 64 keypoints forced; LightGlue at width 64, 4
  heads, 3 layers, from 256-d descriptors) on B = 2 pairs of blocky 64^2
  images with 128 labels, with JAX's pad uniforms (PRNGKey(1), (2)): the
  loss terms within rtol 1e-5 and the GT match count exactly; the clipped
  gradient (against optax's first moment) within 2e-3 per leaf and 1e-5
  over all leaves; >= 99.9 % of the parameters within 1e-2 lr of JAX's
  after the update, every one within 2 lr. Both steps run in float32
  (measured: loss terms within 1.7e-7, gradient 1.6e-4 per leaf and
  4.9e-7 over all, every parameter within 3.3e-2 lr);
- a black image gives finite gradients (tests/test_train.py:136's case:
  every ReLU dead, exact-zero descriptors);
- without pad uniforms the step draws them from generators seeded 1 and
  2, the same on every step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.config import GimConfig as JGimConfig
from gim_tpu.config import LightGlueConfig as JLightGlueConfig
from gim_tpu.config import SuperPointConfig as JSuperPointConfig
from gim_tpu.train import lightglue_loop as JLL
from gim_tpu.weights import port as jport
from gim_tpu_torch import api
from gim_tpu_torch.config import GimConfig, LightGlueConfig, SuperPointConfig
from gim_tpu_torch.models.common import init_weights
from gim_tpu_torch.models.superpoint import SuperPointNet
from gim_tpu_torch.train import lightglue_loop as TLL
from gim_tpu_torch.weights import port as tport
from tests.test_torch_lightglue import LAYERS, LG, _lg_variables
from tests.test_torch_roma import HIGH, _randomize, _to_jax_tree
from tests.torch_train_util import (assert_leaves_close, assert_update_close,
                                    few_threads, first_moment,  # noqa: F401
                                    jax_optimizer, port_optimizer, to_numpy,
                                    torch_batch)

B, S, N, K = 2, 64, 128, 64
TOL = dict(loss=1e-5, grad=(2e-3, 1e-5), share=0.999)


def _cfgs():
    sp = dict(max_num_keypoints=K)
    lg = dict(LG, input_dim=256)
    return (GimConfig(superpoint=SuperPointConfig(**sp),
                      lightglue=LightGlueConfig(**lg)),
            JGimConfig(superpoint=JSuperPointConfig(**sp),
                       lightglue=JLightGlueConfig(**lg)))


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the GT assignment and the SuperPoint losses ---------------------------

def test_assign_gt_matches_exactly():
    rng = np.random.default_rng(0)
    Bn, Kn, Nn = 3, 40, 50
    # integer-ish coordinates: ties in the distances, and labels near
    # keypoints within and beyond the 3 px threshold
    k0 = rng.integers(0, 30, (Bn, Kn, 2)).astype(np.float32)
    k1 = rng.integers(0, 30, (Bn, Kn, 2)).astype(np.float32)
    lab = np.concatenate([k0[:, rng.integers(0, Kn, Nn)]
                          + rng.integers(-3, 4, (Bn, Nn, 2)),
                          k1[:, rng.integers(0, Kn, Nn)]
                          + rng.integers(-3, 4, (Bn, Nn, 2))], -1
                         ).astype(np.float32)
    v0 = rng.random((Bn, Kn)) < 0.8
    v1 = rng.random((Bn, Kn)) < 0.8
    lv = rng.random((Bn, Nn)) < 0.8
    args = (k0, v0, k1, v1, lab, lv)
    want = np.asarray(JLL.assign_gt_matches(*map(jnp.asarray, args)))
    got = TLL.assign_gt_matches(*map(torch.from_numpy, args))
    assert (want >= 0).sum() > 10 and (want < 0).sum() > 10
    np.testing.assert_array_equal(got.numpy(), want)


def _end_points(rng, hc, wc, n, unique: bool):
    """n end points in an (8 hc, 8 wc) image, one to a cell if `unique`,
    else several to some cells; a few invalid and a few outside."""
    if unique:
        cells = rng.permutation(hc * wc)[:n]
    else:
        cells = rng.integers(0, 6, n)
    xy = np.stack([(cells % wc) * 8 + rng.uniform(0, 8, n),
                   (cells // wc) * 8 + rng.uniform(0, 8, n)], -1)
    xy[:3] = [[-2.0, 5.0], [8 * wc + 3.0, 1.0], [4.0, 8 * hc + 9.0]]
    return xy.astype(np.float32), rng.random(n) < 0.85


@pytest.mark.parametrize("unique", [True, False],
                         ids=["one_per_cell", "colliding"])
def test_detection_loss_matches_jax(unique):
    rng = np.random.default_rng(1)
    hc, wc, n = 6, 7, 30
    logits = rng.standard_normal((2, hc, wc, 65)).astype(np.float32)
    pts, valid = zip(*(_end_points(rng, hc, wc, n, unique)
                       for _ in range(2)))
    pts, valid = np.stack(pts), np.stack(valid)
    got = TLL.superpoint_detection_loss(_t(logits), _t(pts), _t(valid))
    if not unique:
        # JAX on the labels with, in each cell, the last valid one kept
        xi = np.clip(pts[..., 0].astype(np.int32), 0, 8 * wc - 1)
        yi = np.clip(pts[..., 1].astype(np.int32), 0, 8 * hc - 1)
        cell = (yi // 8) * wc + xi // 8
        for b in range(2):
            for i in range(n):
                later = valid[b, i + 1:] & (cell[b, i + 1:] == cell[b, i])
                if later.any():
                    valid[b, i] = False
        assert valid.sum() < 0.5 * n * 2
    want = JLL.superpoint_detection_loss(jnp.asarray(logits),
                                         jnp.asarray(pts),
                                         jnp.asarray(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_descriptor_loss_matches_jax():
    rng = np.random.default_rng(2)
    D, hc, wc, n = 32, 6, 8, 40
    d0 = rng.standard_normal((2, D, hc, wc)).astype(np.float32)
    d1 = rng.standard_normal((2, D, hc, wc)).astype(np.float32)
    p0 = rng.uniform(0, [8 * wc, 8 * hc], (2, n, 2))
    p0[:, 1] = p0[:, 0] + 3.0                       # close pairs
    lab = np.concatenate([p0, p0 + rng.normal(0, 2, p0.shape)], -1).astype(
        np.float32)
    lv = rng.random((2, n)) < 0.8
    got = TLL.superpoint_descriptor_loss(_t(d0), _t(d1), _t(lab), _t(lv),
                                         n_max=32)
    want = JLL.superpoint_descriptor_loss(
        jnp.asarray(d0.transpose(0, 2, 3, 1)),
        jnp.asarray(d1.transpose(0, 2, 3, 1)), jnp.asarray(lab),
        jnp.asarray(lv), n_max=32)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- the joint step --------------------------------------------------------

@pytest.fixture(scope="module")
def variables():
    return {"superpoint": jport.port_superpoint(_randomize(SuperPointNet(),
                                                           3)),
            "lightglue": _lg_variables(256, 4)}


def port_model(variables):
    cfg, _ = _cfgs()
    model = api.build_model("gim_lightglue", cfg)
    sd = {f"superpoint.{k}": v for k, v in
          tport.superpoint_state_dict_from_jax(
              variables["superpoint"]).items()}
    sd.update({f"lightglue.{k}": v for k, v in
               tport.lightglue_state_dict_from_jax(
                   variables["lightglue"], LAYERS).items()})
    model.load_state_dict(sd, strict=True)
    return model


def state_dict_from_jax(tree) -> dict:
    """A {"superpoint", "lightglue"} params tree as the port's state dict."""
    sd = {f"superpoint.{k}": v for k, v in
          tport.superpoint_state_dict_from_jax(
              {"params": tree["superpoint"]["params"]}).items()}
    sd.update({f"lightglue.{k}": v for k, v in
               tport.lightglue_state_dict_from_jax(
                   {"params": tree["lightglue"]["params"]}, LAYERS).items()})
    return sd


@pytest.fixture(scope="module")
def batch():
    """Blocky textures; image 1 is image 0 rolled 6 px right; labels at
    the true shift."""
    rng = np.random.default_rng(7)
    blocks = rng.random((B, 3, S // 4, S // 4)).astype(np.float32)
    c0 = np.repeat(np.repeat(blocks, 4, 2), 4, 3)
    c1 = np.roll(c0, 6, axis=-1)
    p0 = rng.integers(0, S - 8, (B, N, 2)) + 0.5
    lab = np.concatenate([p0, p0 + [6.0, 0.0]], -1).astype(np.float32)
    return {"color0": c0, "color1": c1, "labels": lab,
            "label_valid": rng.random((B, N)) < 0.9}


def jax_pad_noise():
    return [np.asarray(jax.random.uniform(jax.random.PRNGKey(s), (B, K, 2)))
            for s in (1, 2)]


@pytest.fixture(scope="module")
def jax_step(variables, batch):
    _, jcfg = _cfgs()
    v = _to_jax_tree(variables)
    tx = jax_optimizer(B)
    with HIGH:
        new_v, state, logs = JLL.lightglue_train_step(
            jcfg, tx, v, tx.init(v), _to_jax_tree(batch))
    return to_numpy({"vars": new_v, "state": state, "logs": logs})


def test_joint_step_matches_jax(variables, batch, jax_step):
    cfg, _ = _cfgs()
    model = port_model(variables)
    opt, sched = port_optimizer(model.parameters(), B)
    lr = sched.get_last_lr()[0]
    pad0, pad1 = map(torch.from_numpy, jax_pad_noise())
    logs = TLL.lightglue_train_step(model, opt, sched, cfg,
                                    torch_batch(batch), pad0, pad1)
    jlogs = jax_step["logs"]
    assert set(logs) == set(jlogs)
    assert float(logs["gt_matches"]) == float(jlogs["gt_matches"]) > 0
    for k in ("loss", "nll", "det", "desc"):
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=TOL["loss"], err_msg=k)
    want_mu = state_dict_from_jax(first_moment(jax_step["state"]))
    params = dict(model.named_parameters())
    assert_leaves_close({k: 0.1 * params[k].grad for k in want_mu}, want_mu,
                        *TOL["grad"], "clipped gradient")
    want_sd = state_dict_from_jax(jax_step["vars"])
    assert_update_close(params, want_sd, lr, TOL["share"])


def test_lightglue_loss_default_draws_are_fixed(variables, batch):
    """Without pad uniforms the loss draws them from generators seeded 1
    and 2: the same loss twice, equal to the loss given those draws."""
    cfg, _ = _cfgs()
    model = port_model(variables)
    tb = torch_batch(batch)
    draws = TLL.pad_draws(B, K, "cpu")
    with torch.no_grad():
        a = TLL.lightglue_loss(model, cfg, tb)[0]
        b = TLL.lightglue_loss(model, cfg, tb)[0]
        c = TLL.lightglue_loss(model, cfg, tb, *draws)[0]
    assert torch.equal(a, b) and torch.equal(a, c)


def test_superpoint_backward_finite_on_black_image():
    """All-black input and zero biases: every ReLU is dead and the dense
    descriptor an exact-zero vector everywhere. The backward stays
    finite (safe_l2_normalize)."""
    net = init_weights(SuperPointNet(), torch.Generator().manual_seed(0))
    scores, desc, logits = TLL._dense_forward(net, torch.zeros(1, 3, 32, 32))
    (desc.sum() + scores.sum() + logits.sum()).backward()
    bad = [k for k, p in net.named_parameters()
           if not torch.isfinite(p.grad).all()]
    assert not bad, bad
    assert not desc.any()
