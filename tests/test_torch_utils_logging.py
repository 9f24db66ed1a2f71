"""The port's `utils/logging.py` and `utils/profiling.py` against the JAX
package's: rank-zero logging without a process group, the info table, the
stage timer's report format, and the trace switch."""

import logging
import os

import torch

from gim_tpu.utils import logging as jlog
from gim_tpu.utils import profiling as jprof
from gim_tpu_torch.utils import flags
from gim_tpu_torch.utils import logging as tlog
from gim_tpu_torch.utils import profiling as tprof


def test_rank_zero_info_logs_without_a_group(capsys):
    assert not torch.distributed.is_initialized()
    logger = tlog.get_logger("gim_tpu_torch_test")
    assert tlog.get_logger("gim_tpu_torch_test") is logger
    assert len(logger.handlers) == 1 and logger.level == logging.INFO
    tlog.rank_zero_info("hello from rank 0", logger)
    assert "hello from rank 0" in capsys.readouterr().out


def test_rank_zero_info_is_silent_off_rank_zero(capsys, monkeypatch):
    monkeypatch.setattr(tlog, "rank", lambda: 1)
    tlog.rank_zero_info("not me", tlog.get_logger("gim_tpu_torch_test"))
    assert "not me" not in capsys.readouterr().out


def test_datainfo_table_matches_jax():
    rows = [{"scene": "GL3D", "pairs": 12, "auc@5": 0.512},
            {"scene": "ETH3D long name", "pairs": 3, "auc@5": None}]
    assert tlog.datainfo_table(rows) == jlog.datainfo_table(rows)
    assert tlog.datainfo_table([]) == jlog.datainfo_table([]) == ""


def test_stage_timer_report_matches_jax_format():
    times = {"extract": 0.25, "match": 1.5, "verify": 0.0125}
    t, j = tprof.StageTimer(), jprof.StageTimer()
    t.times, j.times = dict(times), dict(times)
    assert t.report() == j.report()
    x = torch.ones(3)
    with t.stage("extract", sync_on={"a": [x, (x, 3)]}):
        x = x * 2
    assert t.times["extract"] > 0.25
    with t.stage("new"):
        pass
    assert "new" in t.report() and t.report().splitlines()[-1].startswith(
        "total")


def test_trace_is_off_unless_asked_and_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("GIM_TPU_TRACE", raising=False)
    with tprof.trace("off", str(tmp_path / "off")):
        torch.ones(4).sum()
    assert not (tmp_path / "off").exists()
    monkeypatch.setenv("GIM_TPU_TRACE", "1")
    monkeypatch.setenv("GIM_TPU_TRACE_DIR", str(tmp_path / "on"))
    assert flags.trace_enabled() and flags.trace_dir() == str(tmp_path / "on")
    with tprof.trace("smoke"):
        with tprof.TraceAnnotation("inner"):
            torch.ones(4).sum()
    files = os.listdir(tmp_path / "on")
    assert files and "smoke" in (tmp_path / "on" / files[0]).read_text()


def test_zeb_eval_writes_the_ports_spans_under_the_trace_switch(
        tmp_path, monkeypatch):
    """`cli/zeb_eval` runs its evaluation under `profiling.trace`: with
    `GIM_TPU_TRACE` set it writes a trace holding the pose's span, and
    without it no trace."""
    import tempfile

    from gim_tpu_torch.cli import zeb_eval

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("GIM_TPU_TRACE_DIR", str(tmp_path / "trace"))
    argv = ["--synthetic", "--synthetic_pairs", "2", "--weight", "root_sift",
            "--device", "cpu", "--img_size", "160", "--ransac", "FAST"]
    monkeypatch.delenv("GIM_TPU_TRACE", raising=False)
    zeb_eval.main(argv + ["--out_dir", str(tmp_path / "off")])
    assert not (tmp_path / "trace").exists()
    monkeypatch.setenv("GIM_TPU_TRACE", "1")
    zeb_eval.main(argv + ["--out_dir", str(tmp_path / "on")])
    (trace,) = (tmp_path / "trace").iterdir()
    assert '"gim.zeb.pose"' in trace.read_text()
