"""gim_loftr's training step in gim_tpu_torch against gim_tpu, on the CPU.

Train-mode BatchNorm against flax's, `_mix_gt_padding` with JAX's own
draws, the LR schedule, one AdamW update with and without the clip, and
the whole `loftr_train_step` (forward in train mode, focal and fine
losses, backward, clip, AdamW, two steps) against
`gim_tpu.train.loop.loftr_train_step` at 64^2, B = 2, max_matches 32, 256
labels, on test_torch_loftr's weights (random BatchNorm statistics and
affine parameters). The JAX side runs under `jax.jit` at "highest"
matmul precision.

The whole step's reference is JAX's step in float64 (x64 and
`LoFTRConfig(dtype="float64")`; the LayerNorms, the dual-softmax and the
fine expectation stay float32 in both packages). From-scratch weights make
the float32 gradient of the trunk ill-conditioned: measured at this size,
the port's float32 gradient is up to 1.6e-2 (leaf) from the float64 one,
JAX's own float32 gradient up to 4.4e-2 (the backbone alone under a random
cotangent: 1.3e-2 and 4.4e-2), so no float32 gradient of this step agrees
with another to 1e-3. In float64 the two packages agree to 2.6e-6.

Tolerances:
- train-mode BatchNorm: output, gradients (input, scale, bias) and the
  running mean and variance within rtol 1e-5 of flax's; at N*H*W = 8 the
  unbiased variance update of `F.batch_norm` misses that by ~1/7;
- `_mix_gt_padding`: ids, mconf and valid exactly;
- the schedule: rtol 1e-6 at every step across the end of warmup and two
  milestones; one AdamW update: rtol 1e-6 (float32 rounding);
- the whole step, the port in float64: loss, loss_c and loss_f within
  rtol 1e-6; the clipped gradient (against optax's first moment, which
  holds (1 - b1) times it) and the first moment within |delta| <= 1e-4
  |leaf| per leaf, the second moment within 2e-4; BatchNorm statistics
  within 1e-6 of each leaf's largest magnitude; after the update >= 99.9 %
  of the parameters within 1e-2 * lr of JAX's and every one within 2 * lr;
  the second step's losses within rtol 1e-3;
- the port in float32 against the same reference: losses rtol 1e-4;
  gradient and first moment within 5e-2 per leaf and 3e-2 over all leaves,
  second moment 1e-1 and 6e-2 (the float32 determinacy above); BatchNorm
  statistics within 1e-4 of each leaf's largest magnitude; >= 98 % of the
  parameters within 1e-2 * lr and every one within 2 * lr (Adam's first
  update moves each entry by about +-lr, so an entry whose gradient sits
  at rounding level may flip sign); the second step's losses rtol 1e-2.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from gim_tpu.config import GimConfig as JGimConfig
from gim_tpu.config import LoFTRConfig as JLoFTRConfig
from gim_tpu.config import TrainerConfig as JTrainerConfig
from gim_tpu.models.loftr import model as jmodel
from gim_tpu.train import loop as jloop
from gim_tpu_torch.config import LoFTRConfig, TrainerConfig
from gim_tpu_torch.models.common import batchnorm_train
from gim_tpu_torch.models.loftr import LoFTRMatcher
from gim_tpu_torch.models.loftr.model import _mix_gt_padding
from gim_tpu_torch.train import loop
from gim_tpu_torch.weights.port import loftr_state_dict_from_jax
from tests.test_torch_loftr import HIGH, make_variables

B, IMG, MAXM, NLAB = 2, 64, 32, 256


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's steps: the suite runs one
    worker process a core, and torch's default of one thread a core makes
    each of the many small operations of a training step wait for threads
    the other workers hold (measured: 10-30x slower in the full suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
# warmup of one update: update 0 runs at warmup_ratio * lr = 1e-4, update
# 1 at lr = 1e-3 (canonical batch 2 = the test's batch: no scaling)
TCFG = dict(canonical_bs=B, canonical_lr=1e-3, warmup_steps=1)


# -- train-mode BatchNorm ---------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 8, 2, 2), (3, 16, 9, 7)])
def test_batchnorm_train_matches_flax(shape):
    rng = np.random.default_rng(0)
    N, C, H, W = shape
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 3, (1, C, 1, 1))
         + rng.uniform(-2, 2, (1, C, 1, 1))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    ra_mean = rng.standard_normal(C).astype(np.float32)
    ra_var = rng.uniform(0.5, 1.5, C).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    want, upd = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": ra_mean, "var": ra_var}},
        jnp.asarray(x.transpose(0, 2, 3, 1)), mutable=["batch_stats"])

    mod = torch.nn.BatchNorm2d(C, eps=1e-5)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        mod.running_mean.copy_(torch.from_numpy(ra_mean))
        mod.running_var.copy_(torch.from_numpy(ra_var))
    xt = torch.from_numpy(x).requires_grad_()
    got = batchnorm_train(mod, xt, torch.float32)

    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)

    # backward under a random cotangent
    ct = rng.standard_normal(shape).astype(np.float32)

    def f(p, xx):
        y = bn.apply({"params": p, "batch_stats": {"mean": ra_mean,
                                                   "var": ra_var}},
                     xx, mutable=["batch_stats"])[0]
        return jnp.sum(y * ct.transpose(0, 2, 3, 1))

    gp, gx = jax.grad(f, argnums=(0, 1))(
        {"scale": scale, "bias": bias}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(gx).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5 * np.abs(gx).max())
    np.testing.assert_allclose(mod.weight.grad.numpy(), gp["scale"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mod.bias.grad.numpy(), gp["bias"], rtol=1e-5)
    want_mean = np.asarray(upd["batch_stats"]["mean"])
    want_var = np.asarray(upd["batch_stats"]["var"])
    np.testing.assert_allclose(mod.running_mean.numpy(), want_mean,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(), want_var, rtol=1e-5)

    # F.batch_norm's update takes the unbiased variance: off by n / (n - 1)
    # on the batch's share, far outside the tolerance at n = 8
    rm = torch.from_numpy(ra_mean.copy())
    rv = torch.from_numpy(ra_var.copy())
    F.batch_norm(torch.from_numpy(x), rm, rv, training=True, momentum=0.1,
                 eps=1e-5)
    if N * H * W == 8:
        assert not np.allclose(rv.numpy(), want_var, rtol=1e-3)


# -- GT padding of the fine slots ------------------------------------------

def _padding_inputs(rng, Bn, M, G):
    m = {"i_ids": rng.integers(0, 64, (Bn, M)).astype(np.int32),
         "j_ids": rng.integers(0, 64, (Bn, M)).astype(np.int32),
         "mconf": rng.random((Bn, M)).astype(np.float32),
         "valid": rng.random((Bn, M)) < 0.4}
    spv = {"i_ids": rng.integers(0, 64, (Bn, G)).astype(np.int32),
           "j_ids": rng.integers(0, 64, (Bn, G)).astype(np.int32),
           "valid": rng.random((Bn, G)) < 0.6}
    return m, spv


@pytest.mark.parametrize("M,G,pad_min", [(32, 50, 200), (64, 300, 20)])
def test_mix_gt_padding_with_jax_draws_is_exact(M, G, pad_min):
    rng = np.random.default_rng(M)
    m, spv = _padding_inputs(rng, 3, M, G)
    want = jmodel._mix_gt_padding(
        {k: jnp.asarray(v) for k, v in m.items()},
        {k: jnp.asarray(v) for k, v in spv.items()}, pad_min, None)

    # JAX's draws: the fixed key, split as _mix_gt_padding splits it;
    # categorical(k, logits) is argmax(logits + gumbel(k, logits.shape))
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    uniform = np.asarray(jax.random.uniform(r1, (3, M)))
    gumbel = np.asarray(jax.random.gumbel(r2, (3, M, G)))
    logits = np.where(spv["valid"], 0.0, -1e9).astype(np.float32)
    cat = jax.random.categorical(r2, jnp.repeat(logits[:, None], M, 1))
    np.testing.assert_array_equal(
        np.asarray(cat), np.argmax(logits[:, None] + gumbel, -1))

    got = _mix_gt_padding({k: torch.from_numpy(v) for k, v in m.items()},
                          {k: torch.from_numpy(v) for k, v in spv.items()},
                          pad_min, torch.from_numpy(uniform),
                          torch.from_numpy(gumbel))
    for k in ("i_ids", "j_ids", "mconf", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_mix_gt_padding_ties_keep_top_k_order():
    """Equal shuffle keys rank lower index first, as jax.lax.top_k does."""
    M, G = 16, 8
    rng = np.random.default_rng(1)
    m, spv = _padding_inputs(rng, 2, M, G)
    m["valid"][:] = True
    uniform = np.repeat(rng.random((2, 4)), 4, axis=1).astype(np.float32)
    gumbel = rng.gumbel(size=(2, M, G)).astype(np.float32)
    got = _mix_gt_padding({k: torch.from_numpy(v) for k, v in m.items()},
                          {k: torch.from_numpy(v) for k, v in spv.items()},
                          4, torch.from_numpy(uniform),
                          torch.from_numpy(gumbel))
    _, keep = jax.lax.top_k(jnp.asarray(uniform + 2.0), M)
    want = np.take_along_axis(m["i_ids"], np.asarray(keep), 1)
    np.testing.assert_array_equal(got["i_ids"][:, :M - 4].numpy(),
                                  want[:, :M - 4])


# -- schedule and optimizer ------------------------------------------------

def test_schedule_matches_optax_across_warmup_and_milestones():
    kw = dict(canonical_bs=4, canonical_lr=2e-3, warmup_steps=10,
              scheduler_milestones=(2, 3), scheduler_gamma=0.5)
    steps_per_epoch = 7                              # boundaries 14 and 21
    want = jloop.make_schedule(JTrainerConfig(**kw), 1, 4, steps_per_epoch)
    got = loop.make_schedule(TrainerConfig(**kw), 1, 4, steps_per_epoch)
    for t in range(30):
        np.testing.assert_allclose(got(t), float(want(t)), rtol=1e-6,
                                   err_msg=f"step {t}")
    assert got(13) == pytest.approx(2e-3) and got(14) == pytest.approx(1e-3)


@pytest.mark.parametrize("grad_scale, clip", [(10.0, 0.5), (1e-3, 0.5),
                                              (1.0, 3.0), (1e-3, 3.0)])
def test_one_adamw_update_matches_optax(grad_scale, clip):
    """One update from the same parameters and gradients, the clip at the
    config's `gradient_clipping` (0.5, the default, and 3.0): triggered at
    grad_scale 10 (|g| ~ 70) and 1 (|g| ~ 7), not at 1e-3."""
    rng = np.random.default_rng(2)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 3, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    g0 = {k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
          for k, s in shapes.items()}
    tcfg = dict(TCFG, warmup_steps=0, gradient_clipping=clip)
    tx = jloop.make_optimizer(JTrainerConfig(**tcfg), 1, B, 10)
    state = tx.init(jax.tree_util.tree_map(jnp.asarray, p0))
    upd, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, g0), state,
                       jax.tree_util.tree_map(jnp.asarray, p0))
    want = optax.apply_updates(jax.tree_util.tree_map(jnp.asarray, p0), upd)

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    opt, sched = loop.make_optimizer(params.values(),
                                     TrainerConfig(**tcfg), 1, B, 10)
    for k, p in params.items():
        p.grad = torch.from_numpy(g0[k].copy())
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                       for g in g0.values()))
    assert (norm >= clip) == (grad_scale >= 1)
    opt.step()
    sched.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)


# -- the whole step --------------------------------------------------------

def make_batch(seed: int = 3, Bn: int = B) -> dict:
    """Seeded images and labels: image 1 is image 0 moved (3, 2) px; each
    label's end in image 1 is its start moved the same, some of them
    padded (label_valid False)."""
    rng = np.random.default_rng(seed)
    c0 = rng.random((Bn, 3, IMG, IMG)).astype(np.float32)
    c1 = np.roll(c0, (2, 3), axis=(2, 3))
    p0 = rng.uniform(0, IMG - 4, (Bn, NLAB, 2))
    lab = np.concatenate([p0, p0 + [3.0, 2.0]], -1).astype(np.float32)
    valid = rng.random((Bn, NLAB)) < 0.8
    return {"color0": c0, "color1": c1, "labels": lab, "label_valid": valid}


def jax_draws(Bn: int = B):
    """The draws of JAX's step: PRNGKey(0) split, as _mix_gt_padding does
    (float64 under x64, as JAX's float64 step draws them)."""
    with jax.enable_x64(True):
        r1, r2 = jax.random.split(jax.random.PRNGKey(0))
        return (torch.from_numpy(np.array(jax.random.uniform(r1, (Bn, MAXM)))),
                torch.from_numpy(np.array(
                    jax.random.gumbel(r2, (Bn, MAXM, NLAB)))))


def jax_steps(variables, batch, n_steps: int):
    """`gim_tpu.train.loop.loftr_train_step` n_steps times on `batch`, in
    float64 (x64, `LoFTRConfig(dtype="float64")`). Returns per step
    (logs, variables, opt_state) as numpy trees."""
    cfg = JGimConfig(loftr=JLoFTRConfig(max_matches=MAXM, dtype="float64"),
                     trainer=JTrainerConfig(**TCFG))
    out = []
    with jax.enable_x64(True), HIGH:
        tx = jloop.make_optimizer(cfg.trainer, 1, B, 100)
        to64 = (lambda a: jnp.asarray(a, jnp.float64)
                if a.dtype == np.float32 else jnp.asarray(a))
        v = jax.tree_util.tree_map(to64, variables)
        state = tx.init(v["params"])
        jb = jax.tree_util.tree_map(to64, batch)
        for _ in range(n_steps):
            v, state, logs = jloop.loftr_train_step(cfg, tx, v, state, jb)
            out.append(jax.tree_util.tree_map(np.asarray, (logs, v, state)))
    return out


def adam_moments(state):
    """optax's (mu, nu) in the chain (clip, adamw)."""
    adam = next(s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    return adam.mu, adam.nu


def port_model(variables, dtype=torch.float32):
    model = loop.build_train_model(LoFTRConfig(max_matches=MAXM))
    model.load_state_dict(loftr_state_dict_from_jax(variables), strict=True)
    return model.to(dtype)


def torch_batch(batch, rows=slice(None), dtype=torch.float32):
    """The batch's tensors; the images in `dtype` (labels stay float32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(
                dtype if k.startswith("color") else None)
            for k, v in batch.items()}


def leaf_errors(got: dict, want: dict) -> dict:
    """|got - want| / |want| per leaf (Frobenius norms), and over all
    leaves together under the key "all"."""
    assert set(got) == set(want)
    err, num, den = {}, 0.0, 0.0
    for k in want:
        w = np.asarray(want[k], np.float64)
        d = np.linalg.norm(got[k].detach().double().numpy() - w)
        err[k] = d / np.linalg.norm(w)
        num, den = num + d * d, den + np.square(w).sum()
    err["all"] = np.sqrt(num / den)
    return err


def assert_leaves_close(got: dict, want: dict, tol_leaf: float,
                        tol_all: float, what: str):
    err = leaf_errors(got, want)
    worst = max((k for k in err if k != "all"), key=err.get)
    print(f"{what}: worst leaf {worst} {err[worst]:.3g}, all "
          f"{err['all']:.3g}")
    assert err[worst] <= tol_leaf, (what, worst, err[worst])
    assert err["all"] <= tol_all, (what, err["all"])


def assert_stats_close(got_sd: dict, want_sd: dict, tol: float):
    """Running means and variances within tol of each leaf's largest
    magnitude."""
    for k, w in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            w = w.double().numpy()
            np.testing.assert_allclose(got_sd[k].double().numpy(), w,
                                       rtol=0, atol=tol * np.abs(w).max(),
                                       err_msg=k)


def assert_update_close(got_params: dict, want_sd: dict, lr: float,
                        share: float):
    """>= `share` of the parameters' entries within 1e-2 * lr of JAX's,
    every entry within 2 * lr."""
    diffs = np.concatenate([
        np.abs(p.detach().double().numpy() - want_sd[k].double().numpy()
               ).ravel() for k, p in got_params.items()])
    close = np.mean(diffs <= 1e-2 * lr)
    print(f"update: {close:.5f} within 1e-2 lr, max {diffs.max() / lr:.4f} lr")
    assert close >= share, close
    assert diffs.max() <= 2 * lr, diffs.max() / lr


@pytest.fixture(scope="module")
def variables():
    return make_variables()


@pytest.fixture(scope="module")
def jax_two_steps(variables):
    return jax_steps(variables, make_batch(), 2)


# tolerances of the whole step against JAX's float64 step: the port in
# float64, then the port in float32 (see the module docstring)
F64 = dict(loss=1e-6, grad=(1e-4, 1e-4), moment=(2e-4, 2e-4), stats=1e-6,
           share=0.999, loss2=1e-3)
F32 = dict(loss=1e-4, grad=(5e-2, 3e-2), moment=(1e-1, 6e-2), stats=1e-4,
           share=0.98, loss2=1e-2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_loftr_train_step_matches_jax(variables, jax_two_steps, dtype):
    tol = F64 if dtype == torch.float64 else F32
    batch = torch_batch(make_batch(), dtype=dtype)
    uniform, gumbel = (d.to(dtype) for d in jax_draws())
    model = port_model(variables, dtype)
    tcfg = TrainerConfig(**TCFG)
    opt, sched = loop.make_optimizer(model.parameters(), tcfg, 1, B, 100)
    lr0 = sched.get_last_lr()[0]
    logs = loop.loftr_train_step(model, opt, sched, batch, uniform, gumbel)

    (jlogs, jv, jstate), (jlogs2, _, _) = jax_two_steps
    for k in ("loss", "loss_c", "loss_f"):
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=tol["loss"], err_msg=k)

    mu, nu = adam_moments(jstate)
    want_mu = loftr_state_dict_from_jax({"params": mu})
    want_nu = loftr_state_dict_from_jax({"params": nu})
    params = dict(model.named_parameters())
    # the gradient the update took, clipped, against JAX's: optax's first
    # moment after one update is (1 - b1) * the clipped gradient
    grads = {k: 0.1 * params[k].grad for k in want_mu}
    assert_leaves_close(grads, want_mu, *tol["grad"], "gradient")
    assert_leaves_close({k: opt.state[params[k]]["exp_avg"] for k in want_mu},
                        want_mu, *tol["grad"], "first moment")
    assert_leaves_close({k: opt.state[params[k]]["exp_avg_sq"]
                         for k in want_nu}, want_nu, *tol["moment"],
                        "second moment")

    want_sd = loftr_state_dict_from_jax(jv)
    assert_stats_close(model.state_dict(), want_sd, tol["stats"])
    assert_update_close(params, want_sd, lr0, tol["share"])

    # a second step from the port's own state
    logs2 = loop.loftr_train_step(model, opt, sched, batch, uniform, gumbel)
    for k in ("loss", "loss_c", "loss_f"):
        np.testing.assert_allclose(float(logs2[k]), float(jlogs2[k]),
                                   rtol=tol["loss2"], err_msg=k)


def test_train_mode_bypasses_the_fused_kernel_and_defaults_to_fixed_draws(
        variables):
    """fused_matching=True in the config: training still takes the dense
    dual-softmax (conf_matrix returned, no K1 launch); without draws the
    model draws from the fixed seed, the same on every call."""
    from gim_tpu_torch.ops.kernels import dsmax

    model = loop.build_train_model(LoFTRConfig(max_matches=MAXM,
                                               fused_matching=True))
    model.load_state_dict(loftr_state_dict_from_jax(variables), strict=True)
    b = torch_batch(make_batch(), slice(0, 1))
    before = dict(dsmax.LAUNCHES)
    outs = []
    for _ in range(2):
        with torch.no_grad():
            loss, logs = loop.loftr_loss(model, b)
        outs.append(float(loss))
    assert dict(dsmax.LAUNCHES) == before
    assert np.isfinite(outs).all() and outs[0] == outs[1]
    with torch.no_grad():
        out = model(b["color0"], b["color1"], spv=loop.spv_from_labels(
            b["labels"], b["label_valid"], (8, 8), 8))
    assert out["conf_matrix"].shape == (1, 64, 64)
    with pytest.raises(ValueError, match="train_mode"):
        loop.loftr_loss(LoFTRMatcher(LoFTRConfig(max_matches=MAXM)), b)
