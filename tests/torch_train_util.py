"""Helpers shared by the tests of the port's dense and gim_lightglue
training steps against the JAX package's (tests/test_torch_dkm_train.py,
test_torch_roma_train.py, test_torch_lightglue_train.py)."""

import re

import jax
import numpy as np
import pytest
import torch

from gim_tpu.config import TrainerConfig as JTrainerConfig
from gim_tpu.train import loop as jloop
from gim_tpu_torch.config import TrainerConfig

# one update at warmup_ratio * lr = 1e-4, then lr = 1e-3 (the canonical
# batch is the tests' batch: no scaling)
def trainer_kw(batch_size: int) -> dict:
    return dict(canonical_bs=batch_size, canonical_lr=1e-3, warmup_steps=1)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the module's steps: the suite runs one
    worker process a core, and torch's default of one thread a core makes
    each of a step's many small operations wait for threads the other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_optimizer(batch_size: int):
    return jloop.make_optimizer(JTrainerConfig(**trainer_kw(batch_size)), 1,
                                batch_size, 100)


def port_optimizer(params, batch_size: int):
    from gim_tpu_torch.train import loop

    return loop.make_optimizer(params, TrainerConfig(**trainer_kw(batch_size)),
                               1, batch_size, 100)


def first_moment(state):
    """optax's first moment in the chain (clip, adamw): after one update,
    (1 - b1) = 0.1 times the clipped gradient."""
    adam = next(s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    return adam.mu


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaf_errors(got: dict, want: dict) -> dict:
    """|got - want| / |want| per leaf (Frobenius norms; a zero leaf must be
    zero), and over all leaves under the key "all"."""
    assert set(got) == set(want), set(got) ^ set(want)
    err, num, den = {}, 0.0, 0.0
    for k in want:
        w = np.asarray(want[k], np.float64)
        d = np.linalg.norm(got[k].detach().double().numpy() - w)
        n = np.linalg.norm(w)
        err[k] = d / n if n > 0 else (0.0 if d == 0 else np.inf)
        num, den = num + d * d, den + n * n
    err["all"] = np.sqrt(num / den)
    return err


# parameters whose gradient is zero by construction: the biases of the
# convolutions that a train-mode BatchNorm follows (it subtracts them again)
BEFORE_BN = re.compile(r"(block1|hidden_blocks\.\d+)\.0\.bias$"
                       r"|rrb_[du]\.\d+\.conv2\.bias$|proj\.\d+\.0\.bias$")


def assert_leaves_close(got: dict, want: dict, tol_leaf: float,
                        tol_all: float, what: str, nil_tol: float = 1e-4):
    """Per leaf and over all leaves within tol_leaf and tol_all
    (`leaf_errors`). The leaves named by BEFORE_BN are rounding in both
    packages: only their size is held, below nil_tol of the whole's norm
    (the reference's)."""
    total = np.sqrt(sum(np.square(np.asarray(w, np.float64)).sum()
                        for w in want.values()))
    nil = {k for k in want if BEFORE_BN.search(k)}
    for k in nil:
        for side in (got[k].detach().double().numpy(), want[k]):
            size = np.linalg.norm(np.asarray(side, np.float64)) / total
            assert size < nil_tol, (what, k, size)
    err = leaf_errors({k: got[k] for k in want if k not in nil},
                      {k: w for k, w in want.items() if k not in nil})
    worst = max((k for k in err if k != "all"), key=err.get)
    print(f"{what}: worst leaf {worst} {err[worst]:.3g}, all "
          f"{err['all']:.3g} ({len(nil)} leaves zero by construction)")
    assert err[worst] <= tol_leaf, (what, worst, err[worst])
    assert err["all"] <= tol_all, (what, err["all"])


def running_stats(sd: dict) -> dict:
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def assert_stats_close(got_sd: dict, want_sd: dict, tol: float):
    """Every running mean and variance of want_sd within tol of its
    leaf's largest magnitude in got_sd."""
    want = running_stats(want_sd)
    assert want
    err = {k: float((got_sd[k].double() - w.double()).abs().max()
                    / w.double().abs().max()) for k, w in want.items()}
    worst = max(err, key=err.get)
    print(f"running statistics: worst {worst} {err[worst]:.3g}")
    assert err[worst] <= tol, (worst, err[worst])


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


def shift_batch(seed: int, B: int, S: int, N: int, shift: int = 8) -> dict:
    """Seeded numpy training pairs: image 1 is image 0 rolled `shift` px to
    the right; N labels from image 0 to image 1 inside the frame, some
    padded (label_valid False)."""
    rng = np.random.default_rng(seed)
    c0 = rng.random((B, 3, S, S)).astype(np.float32)
    c1 = np.roll(c0, shift, axis=-1)
    p0 = rng.uniform(0, S - shift - 2, (B, N, 2))
    lab = np.concatenate([p0, p0 + [float(shift), 0.0]], -1).astype(
        np.float32)
    return {"color0": c0, "color1": c1, "labels": lab,
            "label_valid": rng.random((B, N)) < 0.9}


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}
