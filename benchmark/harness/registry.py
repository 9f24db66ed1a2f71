"""Find a cell's files by the names in `BENCHMARK.json`.

A cell (`workloads` entry) names a configuration and a traffic mix. The
configuration is `configs/<config>.json` with its reference
`reference/<config>.py`; the mix is `traffic/<traffic>.json`, whose
`kind` is a module `kinds/<kind>.py`; the configuration's `head` is a
module `heads/<head>.py`; each per-layer metric is `metrics/<name>.py`.
Nothing here knows a cell, a configuration or a metric by name, so a
later change adds one with files and `BENCHMARK.json` entries alone.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One cell with everything the harness reads for it."""

    name: str
    spec: dict             # the `workloads` entry
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<traffic>.json
    end_to_end: list       # the `end_to_end` entries this cell reports
    per_layer: list        # the `per_layer` entries this cell reports
    run_seconds: int

    @property
    def config_name(self) -> str:
        return self.spec["config"]


def reports(metric: dict, cell: str) -> bool:
    """A metric with a `workloads` key is reported in those cells only."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None,
         bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of `BENCHMARK.json` (or of `bench`)."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    specs = {w["name"]: w for w in bench["workloads"]}
    if name not in specs:
        raise KeyError(f"no workload {name!r}; choose from {sorted(specs)}")
    spec = specs[name]
    return Cell(
        name=name, spec=spec,
        config=load_json(bench_dir / "configs" / f"{spec['config']}.json"),
        traffic=load_json(bench_dir / "traffic" / f"{spec['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
        run_seconds=int(bench["run_seconds"]))


def kind(name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.kinds.{name}")


def head(name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.heads.{name}")


def reference(config_name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.reference.{config_name}")


def metric(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """metrics/<name>.py, loaded from its path (metric names hold dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
