"""gim_roma's training in gim_tpu_torch against gim_tpu's, on the CPU.

The tiny configuration of tests/test_dense_train.py (coarse_res 56,
DINOv2 depth 2, one decoder block, no upsample pass) at full width, B = 2
pairs of 56^2 images (image 1 is image 0 rolled 8 px) with 64 labels
each, some padded; seeded weights with BatchNorm statistics and affine
parameters away from identity (tests/test_torch_roma.py's recipe) in both
packages. JAX's side runs once (module fixture) under `jax.jit`, in
float32: `RoMaMatcher(train=True).train_corresps` and one
`gim_tpu.train.dense_losses.roma_train_step`.

JAX's RoMa graph pins float32 in any dtype (the GP, the decoder's
LayerNorms and logits, the refiners' outputs), so both run in float32 and
every bound is measured at this size (in brackets), then given room:
- `train_corresps`: flows within 1e-4 (7.8e-6), certainties within 1e-3
  (1.3e-4) and the anchor logits within 1e-4 (4.3e-6) of the reference's
  largest magnitude; the running statistics it moves within 3e-4 of each
  leaf's largest magnitude (4.2e-5); VGG19's do not move. Each
  projection's BatchNorm moves twice (on f1, then on f2), as the one flax
  module called twice does;
- after one whole step the running statistics within 3e-4 of each leaf's
  largest magnitude of the step's `batch_stats` (4.2e-5; a refiner
  BatchNorm that moved again in the recomputation would be off by 0.1 of
  its batch statistics);
- the loss and per-scale flow losses within rtol 1e-5 (2.5e-7); the
  clipped gradient (against optax's first moment) within 0.2 per leaf
  (3.7e-2, refiner 1's displacement embedding) and 1.5e-2 over all leaves
  (2.9e-3), the frozen DINOv2's exactly zero in both; the biases before a
  train-mode BatchNorm are held to a norm below 1e-4 of the whole's (zero
  by construction); >= 98 % of the parameters within 1e-2 lr of JAX's
  after the update (99.6 %) and every one within 2 lr, DINOv2's included
  (AdamW decays them, in both packages);
- the port's loss falls over 3 steps (the port alone);
- with GIM_TPU_FLASH_VIT=1 the step's forward runs (DINOv2 and the
  coordinate decoder through `flash_sdpa`) and its backward raises at the
  decoder's attention (`KernelBackwardError`), where JAX's step fails.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gim_tpu.config import GimConfig as JGimConfig
from gim_tpu.config import replace
from gim_tpu.models.roma import model as jr
from gim_tpu.train import dense_losses as JD
from gim_tpu.weights import port as jport
from gim_tpu_torch.config import RoMaConfig, TrainerConfig
from gim_tpu_torch.models.roma import RoMaMatcher
from gim_tpu_torch.ops.kernels.forward_only import KernelBackwardError
from gim_tpu_torch.train import dense_losses as TD
from gim_tpu_torch.train import loop
from gim_tpu_torch.weights import port as tport
from tests.test_torch_roma import HIGH, _randomize, _to_jax_tree
from tests.torch_train_util import (assert_leaves_close, assert_stats_close,
                                    assert_update_close, first_moment,
                                    few_threads, jax_optimizer,  # noqa: F401
                                    port_optimizer, running_stats,
                                    shift_batch, to_numpy, torch_batch)

TRAIN = dict(coarse_res=56, upsample_res=(112, 112), num_decoder_blocks=1,
             dino_depth=2, upsample_preds=False)
B, S, N = 2, 56, 64
TOL = dict(flow=1e-4, cert=1e-3, cls=1e-4, stats=3e-4, loss=1e-5,
           grad=(0.2, 1.5e-2), share=0.98)


@pytest.fixture(scope="module")
def variables():
    sd = _randomize(RoMaMatcher(RoMaConfig(**TRAIN)), 0)
    roma_sd, dino_sd = tport.split_roma_state_dict(sd)
    v = jport.port_roma(roma_sd, None, n_decoder_blocks=1)
    v["params"]["dino"] = jport.port_dinov2(dino_sd, depth=2)["params"]
    return v


def state_dict(variables) -> dict:
    return tport.roma_model_state_dict(
        *tport.roma_state_dict_from_jax(variables))


@pytest.fixture(scope="module")
def batch():
    return shift_batch(6, B, S, N)


@pytest.fixture(scope="module")
def jax_ref(variables, batch):
    """JAX's train_corresps (with the batch_stats it moves) and one
    roma_train_step, in float32, as numpy trees."""
    cfg = JGimConfig()
    cfg = replace(cfg, roma=replace(cfg.roma, **TRAIN))
    v = _to_jax_tree(variables)
    jb = _to_jax_tree(batch)
    tx = jax_optimizer(B)
    with HIGH:
        fwd = jax.jit(functools.partial(
            jr.RoMaMatcher(cfg.roma, train=True).apply,
            method="train_corresps", mutable=["batch_stats"]))
        corresps, mutated = fwd(v, jb["color0"], jb["color1"])
        new_v, state, logs = JD.roma_train_step(cfg, tx, v,
                                                tx.init(v["params"]), jb)
    return to_numpy({"corresps": corresps, "fwd_stats": mutated,
                     "vars": new_v, "state": state, "logs": logs})


def port_model(variables) -> RoMaMatcher:
    model = RoMaMatcher(RoMaConfig(**TRAIN), train_mode=True)
    model.load_state_dict(state_dict(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def port_step(variables, batch):
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
        keys = ("flow", "certainty") + (("gm_cls",) if int(s) == 16 else ())
        for k in keys:
            w = d[k]
            g = got[int(s)][k].numpy()
            assert g.shape == w.shape and g.shape[0] == 2 * B, (s, k)
            tol = TOL[{"flow": "flow", "certainty": "cert"}.get(k, "cls")]
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=f"{s} {k}")
    sd = model.state_dict()
    want_sd = state_dict({"params": variables["params"],
                          "batch_stats": jax_ref["fwd_stats"]["batch_stats"]})
    assert_stats_close(sd, want_sd, TOL["stats"])
    moved = [k for k, v in before.items() if not torch.equal(v, sd[k])]
    assert moved and all(k.startswith("decoder.") for k in moved)
    assert any(k.startswith("decoder.proj.") for k in moved)


def test_running_statistics_after_one_step_match_flax(port_step, jax_ref):
    model, _, _ = port_step
    assert_stats_close(model.state_dict(), state_dict(jax_ref["vars"]),
                       TOL["stats"])


def test_one_step_matches_jax(port_step, jax_ref):
    model, logs, lr = port_step
    jlogs = jax_ref["logs"]
    assert set(logs) == set(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v),
                                   rtol=TOL["loss"], err_msg=k)
    want_mu = state_dict({"params": first_moment(jax_ref["state"])})
    params = dict(model.named_parameters())
    dino = [k for k in want_mu if k.startswith("dinov2.")]
    assert dino and all(not np.any(want_mu[k].numpy()) for k in dino)
    assert all(not params[k].grad.any() for k in dino)
    assert_leaves_close({k: 0.1 * params[k].grad for k in want_mu}, want_mu,
                        *TOL["grad"], "clipped gradient")
    assert_update_close(params, state_dict(jax_ref["vars"]), lr,
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


def test_flash_switch_runs_forward_and_refuses_backward(variables, batch,
                                                        monkeypatch):
    """GIM_TPU_FLASH_VIT=1: DINOv2 (under no_grad) and the coordinate
    decoder take `flash_sdpa`; the loss is the switch-off loss (on the
    CPU the kernel's plain version runs), and the backward stops at the
    decoder's attention, as `jax.grad` through the Pallas kernel does."""
    tb = torch_batch(batch)
    with torch.no_grad():
        off, _ = TD.dense_loss(port_model(variables), tb)
    monkeypatch.setenv("GIM_TPU_FLASH_VIT", "1")
    model = port_model(variables)
    loss, _ = TD.dense_loss(model, tb)
    assert torch.equal(loss.detach(), off)
    with pytest.raises(KernelBackwardError, match="flash_attention"):
        loss.backward()
