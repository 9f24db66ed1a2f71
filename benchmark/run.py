"""Run one cell of `BENCHMARK.json` once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Exits non-zero, printing no result, when no
CUDA card is present (no fallback to the CPU), when fewer cards are
present than the cell asks for, or when JAX or the JAX package was loaded.
The last line on standard output is the result (JSON); the numbers the
check compared, each beside its limit, are the last lines on standard
error and the result's last key, `checked`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was first run."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port's own nvcc builds go to `build/gim_tpu_torch/` already."""
    base = ROOT / "benchmark" / "cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(base / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = time.perf_counter() - process_age_s()
    cache_dirs()
    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import registry
    from benchmark.harness.cell import run_cell
    from benchmark.harness.fence import forbidden

    cell = registry.cell(args.workload)
    # the deployment's host threads, where its configuration states them
    if "host_threads" in cell.config:
        torch.set_num_threads(int(cell.config["host_threads"]))
    chips = cell.spec["chips"]
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card; nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=t_start)
    bad = forbidden(sys.modules)
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, (v, lim) in res.checked.items():
        print(f"checked {k} {v!r} limit {lim!r}", file=sys.stderr)
    line = {"correct": res.correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": res.metrics,
            "device": res.device}
    if res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["readings"] = res.readings
    line["checked"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in res.checked.items()}
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
