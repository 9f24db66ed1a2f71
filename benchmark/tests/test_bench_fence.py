"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port. Each check runs in a fresh process,
so what the test process itself imported does not count."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness.fence import FORBIDDEN, forbidden

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def loaded_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_fence_compares_whole_top_level_names():
    assert forbidden(["gim_tpu_torch", "gim_tpu_torch.api", "jaxtyping",
                      "flaxen", "numpy"]) == []
    assert forbidden(["gim_tpu", "gim_tpu.api", "jax.numpy", "jaxlib",
                      "flax.linen"]) == ["flax.linen", "gim_tpu",
                                         "gim_tpu.api", "jax.numpy",
                                         "jaxlib"]


def modules_of(folder: str) -> list:
    return [f"benchmark.{folder}.{p.stem}" for p in sorted(
        (BENCH / folder).glob("*.py")) if p.stem != "__init__"]


@pytest.mark.parametrize("folder", ["harness", "kinds", "heads",
                                    "reference", "reference.frozen"])
def test_benchmark_modules_load_no_jax(folder):
    mods = modules_of(folder.replace(".", "/"))
    mods = [m.replace("reference/frozen", "reference.frozen") for m in mods]
    names = loaded_after("import benchmark.run, benchmark.calibrate\n"
                         + "".join(f"import {m}\n" for m in mods))
    assert forbidden(names) == []


def test_reference_loads_nothing_of_the_port():
    mods = modules_of("reference") + [
        m.replace("reference/frozen", "reference.frozen")
        for m in modules_of("reference/frozen")]
    names = loaded_after("".join(f"import {m}\n" for m in mods))
    assert [n for n in names if n.split(".")[0] == "gim_tpu_torch"] == []
    assert forbidden(names) == []


def test_metric_files_load_no_jax():
    names = loaded_after(
        "from benchmark.harness import registry\n"
        + "".join(f"registry.metric({p.stem!r})\n"
                  for p in sorted((BENCH / "metrics").glob("*.py"))
                  if p.stem != "__init__"))
    assert forbidden(names) == []


def test_a_whole_cell_loads_no_jax():
    """A run of a cell at a small size on the CPU, traced spans placed,
    ends with none of FORBIDDEN loaded."""
    names = loaded_after(
        "from benchmark.tests.small import OVERRIDES, SEED\n"
        "from benchmark.harness.cell import run_cell\n"
        "r = run_cell('lightglue-zeb', SEED, 0.5, True, device='cpu', "
        "overrides=OVERRIDES['lightglue-zeb'])\n"
        "assert r.correct, r.checked\n")
    assert "gim_tpu_torch" in names
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN]
