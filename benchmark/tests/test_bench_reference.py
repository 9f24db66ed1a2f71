"""The plain reference against the port at small sizes on the CPU: each
cell's run, judged by its reference, is correct, and the port's numbers
read far inside the limits (the CPU runs the same float32 math on both
sides, K2 as its plain version)."""

import pytest
import torch

from benchmark.harness.cell import run_cell
from benchmark.reference import gim_dkm, gim_lightglue, zeb_rows
from benchmark.tests.small import OVERRIDES, SEED

CELLS = ["dkm-match", "dkm-zeb", "lightglue-match", "lightglue-zeb"]


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_reference(name):
    r = run_cell(name, SEED, 0.5, False, device="cpu",
                 overrides=OVERRIDES[name])
    assert r.correct, r.checked
    assert r.attempted >= 1
    for k, (value, limit) in r.checked.items():
        assert value <= limit / 10 or value == limit == 0, (k, value, limit)
    assert set(r.metrics) >= {"pairs_per_s", "setup_s"}


def test_rows_reference_reads_planted_pose():
    """`zeb_rows.solve` on exact correspondences of a known pose gives that
    pose: epipolar errors near 0, pose errors under a degree, and the
    pose's gain that of the ground truth."""
    rng = torch.Generator().manual_seed(3)
    n = 200
    X = torch.rand(n, 3, generator=rng, dtype=torch.float64) * 4 - 2
    X[:, 2] += 6.0
    K = torch.tensor([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]],
                     dtype=torch.float64)
    T = torch.eye(4, dtype=torch.float64)
    T[0, 3] = -1.0
    x0 = (X / X[:, 2:]) @ K.T
    X1 = X + T[:3, 3]
    x1 = (X1 / X1[:, 2:]) @ K.T
    b = {"K0": K[None].numpy(), "K1": K[None].numpy(),
         "T_0to1": T[None].numpy(), "identifier": ["planted"]}
    m = {"kpts0": x0[None, :, :2], "kpts1": x1[None, :, :2],
         "conf": torch.ones(1, n, dtype=torch.float64),
         "valid": torch.ones(1, n, dtype=torch.bool)}
    solved = zeb_rows.solve(b, m, "cpu")
    (row,) = solved["rows"]
    assert row["epi_errs"].max() < 1e-12
    assert row["R_errs"] < 1.0 and row["t_errs"] < 1.0
    truth = {"R": T[None, :3, :3], "t": T[None, :3, 3],
             "success": torch.ones(1, dtype=torch.bool)}
    g = zeb_rows.gains(b, m, solved["pose"], "cpu")
    assert float(g[0]) == pytest.approx(
        float(zeb_rows.gains(b, m, truth, "cpu")[0]), rel=1e-6)
    t_err, r_err = zeb_rows.pose_errors(T[None], truth["R"], truth["t"])
    assert float(t_err[0]) == float(r_err[0]) == 0.0


@pytest.mark.parametrize("ref", [gim_dkm, gim_lightglue])
def test_skeleton_matches_the_port_state_dict(ref):
    """The reference's state dict is the port's, key for key and shape for
    shape, so the same tensors load into both."""
    from benchmark.harness import registry
    from benchmark.heads.gimconfig import gim_config
    from gim_tpu_torch.api import build_model

    name = ref.__name__.rsplit(".", 1)[1]
    cfg = registry.load_json(registry.BENCH_DIR / "configs" / f"{name}.json")
    port = build_model(name, gim_config(cfg)).state_dict()
    mine = ref.skeleton(cfg).state_dict()
    assert list(port) == list(mine)
    assert all(port[k].shape == mine[k].shape for k in port)
