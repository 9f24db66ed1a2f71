"""The data-parallel training steps on the CPU: two gloo processes at
batch 1 each against the port's one process at batch 2 and, for
gim_loftr, against JAX's step at B = 2 (the port's counterpart of
`__graft_entry__.dryrun_multichip` for gim_loftr's training); the same
for gim_dkm's and gim_lightglue's steps against one process (the last
test).

Each process joins a gloo group at tcp://localhost, takes its row of the
batch and of JAX's GT-padding draws, and runs
`train.loop.loftr_train_step`, which under the group sums the BatchNorm
sums, the loss normalisers and the gradients over the two processes. Both
processes must end with the same parameters and statistics, and each
one's default GT-padding draws must be its rows of the global batch's.

The step runs in float64, as test_torch_train_step's reference does: in
float32 from-scratch weights leave the trunk's gradient determined only to
~1e-2, and two processes sum in another order than one. Tolerances: losses
within rtol 1e-6, every clipped-gradient leaf within 1e-4 of its norm,
BatchNorm statistics within 1e-6 of each leaf's largest magnitude, the
parameters after the update within 1e-2 * lr on >= 99.9 % of entries and
2 * lr everywhere (against the one process and against JAX alike).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gim_tpu_torch.config import TrainerConfig
from gim_tpu_torch.models.loftr.model import padding_draws
from gim_tpu_torch.train import loop
from gim_tpu_torch.weights.port import loftr_state_dict_from_jax
from tests.test_torch_train_step import (B, F64, MAXM, NLAB, TCFG,
                                         adam_moments,
                                         assert_leaves_close,
                                         assert_stats_close,
                                         assert_update_close, jax_draws,
                                         jax_steps, make_batch, port_model,
                                         torch_batch)
from tests.test_torch_loftr import make_variables
from tests.torch_train_util import assert_leaves_close as assert_head_leaves

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2


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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _one_step(model, batch, uniform, gumbel, step_fn):
    """A step on a fresh optimizer; returns logs, clipped gradients, the
    state dict and the parameters after the update, and the LR the update
    took."""
    opt, sched = loop.make_optimizer(model.parameters(),
                                     TrainerConfig(**TCFG), 1, B, 100)
    lr = sched.get_last_lr()[0]
    logs = step_fn(model, opt, sched, batch, uniform, gumbel)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return ({k: float(v) for k, v in logs.items()}, grads,
            {k: v.clone() for k, v in model.state_dict().items()},
            {k: p.detach().clone() for k, p in model.named_parameters()}, lr)


def _worker(rank: int, port: int, workdir: str):
    """One process of the group: its row of the batch and of the draws."""
    import torch.distributed as dist

    from gim_tpu_torch.parallel import mesh

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                            weights_only=False)
        model = loop.build_train_model(inputs["cfg"]).double()
        model.load_state_dict(inputs["state_dict"])
        rows = slice(rank, rank + 1)
        batch = {k: v[rows] for k, v in inputs["batch"].items()}
        assert mesh.world_size() == WORLD and mesh.rank() == rank
        out = _one_step(model, batch, inputs["uniform"][rows],
                        inputs["gumbel"][rows],
                        loop.loftr_train_step)
        draws = padding_draws(1, MAXM, NLAB, "cpu")
        torch.save((out, draws), os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def variables():
    return make_variables()


def test_two_process_step_equals_global_batch_and_jax(variables, tmp_path):
    batch = torch_batch(make_batch(), dtype=torch.float64)
    uniform, gumbel = jax_draws()
    model = port_model(variables, torch.float64)
    torch.save({"cfg": model.cfg, "state_dict": model.state_dict(),
                "batch": batch, "uniform": uniform, "gumbel": gumbel},
               tmp_path / "inputs.pt")

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    code = ("import sys; from tests.test_torch_train_ddp import _worker; "
            "_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        # the one process at batch 2, while the group runs
        single = _one_step(model, batch, uniform, gumbel,
                           loop.loftr_train_step)
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    ranks, draws = zip(*(torch.load(tmp_path / f"rank{r}.pt")
                         for r in range(WORLD)))

    # each process's default draws are its rows of the global batch's
    for want, got in zip(padding_draws(WORLD, MAXM, NLAB, "cpu"),
                         zip(*draws)):
        for r in range(WORLD):
            assert torch.equal(got[r], want[r:r + 1])

    # every process ends in the same state
    for k, v in ranks[0][2].items():
        assert torch.equal(v, ranks[1][2][k]), k
    logs, grads, sd, params, lr = ranks[0]
    for k in ("loss", "loss_c", "loss_f"):
        np.testing.assert_allclose(logs[k], ranks[1][0][k], rtol=0)
        np.testing.assert_allclose(logs[k], single[0][k], rtol=1e-6,
                                   err_msg=k)
    assert_leaves_close(grads, single[1], 1e-4, 1e-4, "gradient vs one")
    assert_stats_close(sd, single[2], 1e-6)
    assert_update_close(params, single[2], lr, 0.999)

    # against JAX's step on the global batch
    (jlogs, jv, jstate), = jax_steps(variables, make_batch(), 1)
    for k in ("loss", "loss_c", "loss_f"):
        np.testing.assert_allclose(logs[k], float(jlogs[k]),
                                   rtol=F64["loss"], err_msg=k)
    mu, _ = adam_moments(jstate)
    want_mu = loftr_state_dict_from_jax({"params": mu})
    assert_leaves_close({k: 0.1 * grads[k] for k in want_mu}, want_mu,
                        *F64["grad"], "gradient vs JAX")
    want_sd = loftr_state_dict_from_jax(jv)
    assert_stats_close(sd, want_sd, F64["stats"])
    assert_update_close(params, want_sd, lr, F64["share"])


# -- gim_dkm's and gim_lightglue's steps ------------------------------------

def _head_model(weight: str):
    """The head's model in train mode at a small size, seeded: gim_dkm at
    h_resized = w_resized = 32 with float64 compute (float32 parameters;
    its GP stays float32, as in JAX); gim_lightglue with 64 keypoints and
    LightGlue at width 64, 3 layers."""
    from gim_tpu_torch.cli.train import build_train_model
    from gim_tpu_torch.config import (DKMConfig, GimConfig, LightGlueConfig,
                                      SuperPointConfig)
    from gim_tpu_torch.models.common import init_weights

    if weight == "gim_dkm":
        cfg = GimConfig(dkm=DKMConfig(h_resized=32, w_resized=32,
                                      upsample_preds=False, dtype="float64"))
    else:
        cfg = GimConfig(superpoint=SuperPointConfig(max_num_keypoints=64),
                        lightglue=LightGlueConfig(
                            descriptor_dim=64, num_heads=4, n_layers=3,
                            input_dim=256))
    model = build_train_model(weight, cfg)
    return cfg, init_weights(model, torch.Generator().manual_seed(11))


def _head_step(weight, cfg, model, batch):
    """One step of the head on a fresh optimizer; as `_one_step`."""
    from gim_tpu_torch.train.dense_losses import dense_train_step
    from gim_tpu_torch.train.lightglue_loop import lightglue_train_step

    opt, sched = loop.make_optimizer(model.parameters(),
                                     TrainerConfig(**TCFG), 1, B, 100)
    lr = sched.get_last_lr()[0]
    if weight == "gim_dkm":
        logs = dense_train_step(model, opt, sched, batch)
    else:
        logs = lightglue_train_step(model, opt, sched, cfg, batch)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return ({k: float(v) for k, v in logs.items()}, grads,
            {k: v.clone() for k, v in model.state_dict().items()},
            {k: p.detach().clone() for k, p in model.named_parameters()}, lr)


def _head_batch():
    """2 pairs of blocky 64^2 images, image 1 rolled 6 px, 128 labels."""
    rng = np.random.default_rng(8)
    blocks = rng.random((B, 3, 16, 16)).astype(np.float32)
    c0 = np.repeat(np.repeat(blocks, 4, 2), 4, 3)
    p0 = rng.integers(0, 56, (B, 128, 2)) + 0.5
    lab = np.concatenate([p0, p0 + [6.0, 0.0]], -1).astype(np.float32)
    return {"color0": torch.from_numpy(c0),
            "color1": torch.from_numpy(np.roll(c0, 6, axis=-1)),
            "labels": torch.from_numpy(lab),
            "label_valid": torch.from_numpy(rng.random((B, 128)) < 0.9)}


def _head_worker(rank: int, port: int, workdir: str, weight: str):
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        cfg, model = _head_model(weight)
        model.load_state_dict(torch.load(os.path.join(workdir, "sd.pt")))
        batch = {k: v[rank:rank + 1] for k, v in _head_batch().items()}
        out = _head_step(weight, cfg, model, batch)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("weight", ["gim_dkm", "gim_lightglue"])
def test_two_process_head_step_equals_global_batch(weight, tmp_path):
    """Two gloo processes of 1 pair each against one process of 2 pairs:
    the same losses (the normalisers are the global batch's: labelled
    cells and class masses, the detector's cells, the descriptor and NLL
    counts, the pad draws' rows), gradients, statistics and update.
    Tolerances: losses rtol 1e-5, each gradient leaf within 1e-4 of its
    norm (the biases before a train-mode BatchNorm, zero by construction,
    below 1e-4 of the whole's), statistics within 1e-6 of each leaf's largest magnitude, >=
    99.9 % of the parameters within 1e-2 lr after the update."""
    cfg, model = _head_model(weight)
    torch.save(model.state_dict(), tmp_path / "sd.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    code = ("import sys; from tests.test_torch_train_ddp import _head_worker;"
            " _head_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], "
            "sys.argv[4])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               str(tmp_path), weight], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        single = _head_step(weight, cfg, model, _head_batch())
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    for k, v in ranks[0][2].items():
        assert torch.equal(v, ranks[1][2][k]), k
    logs, grads, sd, params, lr = ranks[0]
    assert set(logs) == set(single[0])
    for k in logs:
        np.testing.assert_allclose(logs[k], single[0][k], rtol=1e-5,
                                   err_msg=k)
    nonzero = {k for k, g in single[1].items() if g.any()}
    assert len(nonzero) > 0.9 * len(single[1])
    assert_head_leaves({k: grads[k] for k in nonzero},
                       {k: single[1][k].numpy() for k in nonzero}, 1e-4,
                       1e-4, "gradient vs one")
    if weight == "gim_dkm":
        assert_stats_close(sd, single[2], 1e-6)
    assert_update_close(params, single[2], lr, 0.999)
