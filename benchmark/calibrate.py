"""Readings for setting a cell's limits: the port's and the control's.

    python -m benchmark.calibrate --workload <cell> --seeds 11,12,13 \
        [--seconds 8] [--control] [--out chiprun_out/calibrate.jsonl]

For each seed: one short run of the cell (`run_cell`, its window long
enough to reach the calls the check reads), whose readings are the
port's; with `--control`, the control's readings too: the reference put
in the port's place and computed in TF32 throughout (the nearest
precision below the configuration's float32 with TF32 off), on the same
seed's checked batches, judged as the port is. One JSON line a seed and
side. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(name: str, seed: int, device, overrides=None) -> dict:
    """The control's readings for `seed`: every number the check reads."""
    import math

    import torch

    from benchmark.harness import registry
    from benchmark.harness.cell import checked_calls, merge
    from benchmark.harness.inputs import batch, make_batches
    from benchmark.harness.weights import seeded_state_dict
    from benchmark.reference import zeb_rows

    cell = registry.cell(name)
    cfg, traffic = cell.config, cell.traffic
    if overrides:
        cfg = merge(cfg, overrides.get("config", {}))
        traffic = merge(traffic, overrides.get("traffic", {}))
    ref_mod = registry.reference(cell.config_name)
    dev = torch.device(device)
    batches = make_batches(traffic, seed)
    state = seeded_state_dict(ref_mod.skeleton(cfg), seed, dev)
    ref = ref_mod.Reference(cfg, state, dev)
    out = {}
    for i in sorted(checked_calls(traffic, seed)):
        b = batch(batches, i)
        ctl = ref.outputs(b, control=True)
        rows = None
        if traffic["kind"] == "zeb":
            solved = zeb_rows.control(b, ctl, dev)
            ctl["pose"], rows = solved["pose"], solved["rows"]
        for k, v in ref.judge(b, ctl, rows).items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness.cell import run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        lines = []
        t = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False)
        lines.append({"side": "port", "seed": seed,
                      "readings": r.readings, "correct": r.correct,
                      "seconds": time.perf_counter() - t})
        if args.control:
            t = time.perf_counter()
            lines.append({"side": "control", "seed": seed,
                          "readings": control_readings(args.workload, seed,
                                                       "cuda"),
                          "seconds": time.perf_counter() - t})
        for line in lines:
            line = {"workload": args.workload, **line}
            print(json.dumps(line), flush=True)
            if sink:
                print(json.dumps(line), file=sink, flush=True)
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
