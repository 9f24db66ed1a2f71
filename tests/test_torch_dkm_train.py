"""gim_dkm's training in gim_tpu_torch against gim_tpu's, on the CPU.

gim_dkm's full width at h_resized = w_resized = 64 (tests/
test_dense_train.py takes 32; there the coarsest grid is 1 x 1, and the
train-mode BatchNorms over its 4 samples leave too little to compare), no
upsample pass, B = 2 pairs of 64^2 images (image 1 is image 0 rolled 8
px) with 64 labels each, some padded; seeded weights with BatchNorm
statistics and affine parameters away from identity (tests/
test_torch_dkm.py's recipe) in both packages. JAX's side runs once
(module fixture) under `jax.jit`: `DKMMatcher(train=True).train_corresps`
and one `gim_tpu.train.dense_losses.dkm_train_step`.

Both run in float32. JAX's DKM graph pins float32 in any dtype (the GP's
kernel and solve, the DFN's and the refiners' outputs), so there is no
float64 reference to hold the port to (and under x64 JAX's step takes
over ten minutes on the CPU). The train-mode graph amplifies rounding:
a 1e-6 perturbation of the input moves the port's fine certainty by 7e-4
of its largest value, and a 1e-7 one moves the gradient of refiner 1's
first BatchNorm scale by 2 %. Every bound is measured at this size, then given room:
- `train_corresps`: flows within 1e-3 and certainties within 3e-2 of the
  reference's largest magnitude (measured 3.2e-4 and 1.0e-2, at scale 1);
  the running statistics it moves within 1e-3 of each leaf's largest
  magnitude (2.1e-4); the encoder's do not move;
- after one whole step (forward, losses, backward with each refiner
  recomputed, clip, AdamW) the running statistics within 1e-3 of each
  leaf's largest magnitude of the step's `batch_stats` (2.1e-4): a
  refiner BatchNorm that moved again in the recomputation would be off by
  0.1 of its batch statistics;
- the loss and per-scale flow losses within rtol 1e-4 (6.7e-6); the clipped
  gradient (against optax's first moment, 0.1 times it) within 0.5 per
  leaf and 3e-2 over all leaves (measured 0.25, refiner 1's first
  BatchNorm scale, and 1.1e-2); the 49 convolution biases before a
  train-mode BatchNorm have a zero gradient by construction and are held
  to a norm below 1e-4 of the whole's; >= 95 % of the parameters within
  1e-2 lr of JAX's after the update (97.5 %) and every one within 2 lr
  (Adam's first step moves an entry by about +-lr, so an entry whose
  gradient is rounding may flip);
- the port's loss falls over 3 steps at the trainer's default schedule
  (the port alone, as tests/test_dense_train.py runs JAX's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.config import GimConfig as JGimConfig
from gim_tpu.config import replace
from gim_tpu.models.dkm import model as jm
from gim_tpu.train import dense_losses as JD
from gim_tpu.weights import port as jport
from gim_tpu_torch.config import DKMConfig, TrainerConfig
from gim_tpu_torch.models.dkm.model import DKMMatcher
from gim_tpu_torch.train import dense_losses as TD
from gim_tpu_torch.train import loop
from gim_tpu_torch.weights.port import dkm_state_dict_from_jax
from tests.test_torch_roma import HIGH, _randomize, _to_jax_tree
from tests.torch_train_util import (assert_leaves_close, assert_stats_close,
                                    assert_update_close, first_moment,
                                    few_threads, jax_optimizer,  # noqa: F401
                                    port_optimizer, running_stats,
                                    shift_batch, to_numpy, torch_batch)

TRAIN = dict(h_resized=64, w_resized=64, upsample_preds=False)
B, S, N = 2, 64, 64
TOL = dict(flow=1e-3, cert=3e-2, stats=1e-3, loss=1e-4, grad=(0.5, 3e-2),
           share=0.95)


@pytest.fixture(scope="module")
def variables():
    return jport.port_dkm(_randomize(DKMMatcher(DKMConfig(**TRAIN)), 0))


@pytest.fixture(scope="module")
def batch():
    return shift_batch(5, B, S, N)


@pytest.fixture(scope="module")
def jax_ref(variables, batch):
    """JAX's train_corresps (with the batch_stats it moves) and one
    dkm_train_step, in float32, as numpy trees."""
    cfg = JGimConfig()
    cfg = replace(cfg, dkm=replace(cfg.dkm, **TRAIN))
    v = _to_jax_tree(variables)
    jb = _to_jax_tree(batch)
    tx = jax_optimizer(B)
    with HIGH:
        fwd = jax.jit(functools.partial(
            jm.DKMMatcher(cfg.dkm, train=True).apply,
            method="train_corresps", mutable=["batch_stats"]))
        corresps, mutated = fwd(v, jb["color0"], jb["color1"])
        new_v, state, logs = JD.dkm_train_step(cfg, tx, v,
                                               tx.init(v["params"]), jb)
    return to_numpy({"corresps": corresps, "fwd_stats": mutated,
                     "vars": new_v, "state": state, "logs": logs})


def port_model(variables, dtype: str = "float32") -> DKMMatcher:
    model = DKMMatcher(DKMConfig(dtype=dtype, **TRAIN), train_mode=True)
    model.load_state_dict(dkm_state_dict_from_jax(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def port_step(variables, batch):
    """The port's model after one dense_train_step on the batch."""
    model = port_model(variables)
    opt, sched = port_optimizer(model.parameters(), B)
    lr = sched.get_last_lr()[0]
    logs = TD.dense_train_step(model, opt, sched, torch_batch(batch))
    return model, logs, lr


def test_train_corresps_and_their_statistics_match_jax(variables, batch,
                                                       jax_ref):
    model = port_model(variables)
    before = {k: v.clone() for k, v in running_stats(model.state_dict()
                                                     ).items()}
    tb = torch_batch(batch)
    with torch.no_grad():
        got = model.train_corresps(tb["color0"], tb["color1"])
    want = jax_ref["corresps"]
    assert sorted(got) == sorted(int(k) for k in want)
    for s, d in want.items():
        for k in ("dense_flow", "dense_certainty"):
            w = d[k]
            g = got[int(s)][k].numpy()
            assert g.shape == w.shape == (2 * B, *g.shape[1:]), (s, k)
            tol = TOL["flow" if k == "dense_flow" else "cert"]
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=f"{s} {k}")
    want_sd = dkm_state_dict_from_jax({"params": variables["params"],
                                       "batch_stats":
                                           jax_ref["fwd_stats"]["batch_stats"]})
    sd = model.state_dict()
    assert_stats_close(sd, want_sd, TOL["stats"])
    moved = [k for k, v in before.items() if not torch.equal(v, sd[k])]
    # the DFN's RRBs and every refiner block move; the encoder does not
    assert moved and all(k.startswith("decoder.") for k in moved)
    assert not any(k.startswith("encoder.") for k in moved)


def test_running_statistics_after_one_step_match_flax(port_step, jax_ref):
    model, _, _ = port_step
    want_sd = dkm_state_dict_from_jax(jax_ref["vars"])
    assert_stats_close(model.state_dict(), want_sd, TOL["stats"])


def test_one_step_matches_jax(port_step, jax_ref):
    model, logs, lr = port_step
    jlogs = jax_ref["logs"]
    assert set(logs) == set(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v),
                                   rtol=TOL["loss"], err_msg=k)
    want_mu = dkm_state_dict_from_jax({"params": first_moment(
        jax_ref["state"])})
    params = dict(model.named_parameters())
    assert_leaves_close({k: 0.1 * params[k].grad for k in want_mu}, want_mu,
                        *TOL["grad"], "clipped gradient")
    assert_update_close(params, dkm_state_dict_from_jax(jax_ref["vars"]), lr,
                        TOL["share"])


def test_port_loss_falls_over_three_steps(variables, batch):
    """At the trainer's default schedule, as tests/test_dense_train.py
    runs JAX's steps."""
    model = port_model(variables)
    opt, sched = loop.make_optimizer(model.parameters(), TrainerConfig(), 1,
                                     1, 100)
    tb = torch_batch(batch)
    losses = [float(TD.dense_train_step(model, opt, sched, tb)["loss"])
              for _ in range(3)]
    assert np.isfinite(losses).all() and losses[2] < losses[0], losses
