"""ZEB evaluation across processes and the sweep, on the CPU.

- The pair shard of `parallel.mesh.process_local_pairs` is the JAX CLI's
  (`gim_tpu/cli/zeb_eval.py:150-152`: tail padding, then a stride).
- Two processes in a gloo group, under torchrun's environment, run
  `cli.zeb_eval` on 5 synthetic pairs (the tail padded): rank 0 writes a
  dump byte-equal to one process's, rank 1 writes none. Rows meet
  through the group's store (`eval.zeb.gather_rows_multihost`).
- `cli.sweep` hands `cli.zeb_eval.main` the same argument lists as the
  JAX sweep hands its CLI (the port adds `--device`), over a tree of two
  synthetic datasets and one missing; and, run for real with root_sift,
  it writes both dumps and prints the check and the AUC table.
- A failed consistency check (a second method's dump of a scene covering
  fewer pairs) is a warning in both sweeps: each prints it and the AUC
  table and returns, with the same output.
"""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from gim_tpu_torch.data.synthetic import write_synthetic_benchmark
from gim_tpu_torch.eval import zeb as TE
from gim_tpu_torch.parallel import mesh

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_shard(pairs, n_proc, pid):
    """The JAX CLI's rule, as written at gim_tpu/cli/zeb_eval.py:150-152."""
    per = -(-len(pairs) // n_proc)
    padded = pairs + pairs[:per * n_proc - len(pairs)]
    return padded[pid::n_proc]


@pytest.mark.parametrize("n,world", [(5, 2), (8, 2), (7, 3), (1, 4),
                                     (3, 1)])
def test_shard_is_the_jax_rule(n, world, monkeypatch):
    pairs = [f"pair{i}" for i in range(n)]
    seen = []
    for r in range(world):
        monkeypatch.setattr(mesh, "world_size", lambda: world)
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        got = mesh.process_local_pairs(pairs)
        assert got == _jax_shard(pairs, world, r)
        seen += got
    assert set(seen) == set(pairs)        # every pair in some share


def _cli_args(data_root, out_dir):
    return ["--weight", "root_sift", "--data_root", str(data_root),
            "--seq", "gl3d", "--img_size", "256", "--ransac", "FAST",
            "--device", "cpu", "--out_dir", str(out_dir)]


def test_two_gloo_processes_write_the_one_process_dump(tmp_path):
    data = tmp_path / "data"
    write_synthetic_benchmark(str(data), n_pairs=5, seq="gl3d")
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE="2", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT)]
                       + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gim_tpu_torch.cli.zeb_eval"]
            + _cli_args(data, tmp_path / f"rank{r}"), cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        from gim_tpu_torch.cli import zeb_eval

        zeb_eval.main(_cli_args(data, tmp_path / "one"))
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    assert "3 pairs (proc 0/2)" in outs[0] and "(proc 1/2)" in outs[1]
    one = Path(TE.dump_path(str(tmp_path / "one"), "root_sift", "GL3D",
                            "v0"))
    two = Path(TE.dump_path(str(tmp_path / "rank0"), "root_sift", "GL3D",
                            "v0"))
    assert two.read_bytes() == one.read_bytes()
    assert len(one.read_text().splitlines()) == 6      # header + 5 pairs
    assert not (tmp_path / "rank1").exists()


def _two_datasets(tmp_path):
    data = str(tmp_path / "data")
    write_synthetic_benchmark(data, n_pairs=3, seq="gl3d")
    write_synthetic_benchmark(data, n_pairs=3, seq="blendedmvs")
    return data


@pytest.mark.parametrize("weight", ["root_sift", "gim_lightglue"])
def test_sweep_hands_zeb_eval_the_jax_argument_lists(tmp_path, monkeypatch,
                                                     capsys, weight):
    from gim_tpu.cli import sweep as j_sweep
    from gim_tpu.cli import zeb_eval as j_eval
    from gim_tpu_torch.cli import sweep as t_sweep
    from gim_tpu_torch.cli import zeb_eval as t_eval

    data = _two_datasets(tmp_path)
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(j_eval, "main", calls["jax"].append)
    monkeypatch.setattr(t_eval, "main", calls["port"].append)
    common = ["--weight", weight, "--version", "t0", "--data_root", data,
              "--out_dir", str(tmp_path / "dump"), "--tests", "GL3D",
              "BlendedMVS", "KITTI", "--img_size", "256", "--max_samples",
              "3", "--ckpt", "w.ckpt", "--overwrite", "--skip_analysis"]
    j_sweep.main(common)
    jax_out = capsys.readouterr().out
    t_sweep.main(common + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    assert len(calls["jax"]) == 2
    assert calls["port"] == [a + ["--device", "cpu"] for a in calls["jax"]]
    bs = "16" if weight == "gim_lightglue" else "1"
    assert calls["port"][0][calls["port"][0].index("--batch_size") + 1] == bs
    assert port_out == jax_out
    assert "KITTI: no data" in port_out
    assert "2 benchmarks run, 1 skipped" in port_out


def test_sweep_runs_zeb_eval_check_and_analysis(tmp_path, capsys):
    from gim_tpu_torch.cli import analysis, sweep

    data = _two_datasets(tmp_path)
    out_dir = str(tmp_path / "dump")
    sweep.main(["--weight", "root_sift", "--version", "t0", "--data_root",
                data, "--out_dir", out_dir, "--tests", "GL3D", "BlendedMVS",
                "--img_size", "256", "--ransac", "FAST", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "2 benchmarks run, 0 skipped" in out
    assert out.count("Good") == 2
    for scene in ("GL3D", "BlendedMVS"):
        with open(TE.dump_path(out_dir, "root_sift", scene, "t0")) as f:
            assert len(f.read().splitlines()) == 4     # header + 3 pairs
    res = analysis.main(["--dir", out_dir, "--wid", "root_sift",
                         "--version", "t0"])
    assert set(res) == {"GL3D", "BlendedMVS"}


def test_sweep_with_a_failed_check_returns_as_the_jax_sweep(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    from gim_tpu.cli import sweep as j_sweep
    from gim_tpu.cli import zeb_eval as j_eval
    from gim_tpu_torch.cli import sweep as t_sweep
    from gim_tpu_torch.cli import zeb_eval as t_eval

    data = _two_datasets(tmp_path)
    out_dir = str(tmp_path / "dump")
    common = ["--weight", "root_sift", "--version", "t0", "--data_root",
              data, "--out_dir", out_dir, "--tests", "GL3D", "BlendedMVS",
              "--img_size", "256", "--ransac", "FAST"]
    t_sweep.main(common + ["--device", "cpu"])      # root_sift's dumps
    assert capsys.readouterr().out.count("Good") == 2
    # a second method's GL3D dump over 2 of the 3 pairs, as a run with
    # --max_samples 2 writes it
    with open(TE.dump_path(out_dir, "root_sift", "GL3D", "t0")) as f:
        rows = f.read().splitlines()
    with open(TE.dump_path(out_dir, "gim_dkm", "GL3D", "t0"), "w") as f:
        f.write("\n".join(rows[:3]) + "\n")
    # the dumps exist: each sweep's evaluation calls are stubbed, its check
    # and its AUC table run
    monkeypatch.setattr(j_eval, "main", lambda argv: None)
    monkeypatch.setattr(t_eval, "main", lambda argv: None)
    assert j_sweep.main(common) is None
    jax_out = capsys.readouterr().out
    assert t_sweep.main(common + ["--device", "cpu"]) is None
    port_out = capsys.readouterr().out
    assert "GL3D: Bad (2 methods, 2 pairs)" in port_out
    assert "[sweep] consistency check failed (1); see above" in port_out
    assert "BlendedMVS: Good (1 methods, 3 pairs)" in port_out
    assert "mean auc@5" in port_out
    # the AUC table's heading carries the wall clock's date and time
    stamp = re.compile(r"\d{4}-\d{2}-\d{2}, \d{2}:\d{2}:\d{2}")
    assert stamp.search(port_out)
    assert stamp.sub("T", port_out) == stamp.sub("T", jax_out)
