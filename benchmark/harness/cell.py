"""One run of one cell: set-up, the window, the trace, the check.

`run_cell` is what `benchmark.run` calls on the card; the tests call it on
the CPU at small sizes (`overrides`), where no device metric is read.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.harness import registry
from benchmark.harness.inputs import make_batches
from benchmark.harness.spans import Spans
from benchmark.harness.trace import Tracer
from benchmark.harness.weights import seeded_state_dict
from benchmark.harness.window import Window

GIB = 2.0 ** 30


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checked: dict                      # number -> [value, limit]
    breakdown: dict | None = None
    readings: dict = field(default_factory=dict)   # every number judged


def merge(base: dict, extra: dict) -> dict:
    """`base` with `extra`'s keys set, groups merged at every depth."""
    out = dict(base)
    for k, v in extra.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def checked_calls(traffic: dict, seed: int) -> frozenset:
    """The calls the check reads: `check_calls` of the first `check_from`
    calls, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    return frozenset(int(i) for i in rng.choice(
        int(traffic["check_from"]), int(traffic["check_calls"]),
        replace=False))


def verdict(readings: dict, limits: dict) -> dict:
    """{number: [value, limit]} of the numbers the configuration limits;
    each must read at most its limit. A number that was not read reads
    infinity, and a NaN fails too."""
    return {k: [readings.get(k, math.inf), lim] for k, lim in limits.items()}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             overrides: dict | None = None, bench: dict | None = None,
             bench_dir=registry.BENCH_DIR, fault=None) -> Result:
    """One run. `t_start` is the process's start on the host clock
    (`time.perf_counter`); `overrides` merges into the configuration and
    the traffic (`{"config": {...}, "traffic": {...}}`); `bench` and
    `bench_dir` stand in for `BENCHMARK.json` and this folder's data
    files; `fault(prog)`, where given, breaks the program under the timed
    path (the tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = registry.cell(name, bench, bench_dir)
    cfg, traffic = cell.config, cell.traffic
    if overrides:
        cfg = merge(cfg, overrides.get("config", {}))
        traffic = merge(traffic, overrides.get("traffic", {}))
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    kind = registry.kind(traffic["kind"])
    head = registry.head(cfg["head"])
    ref_mod = registry.reference(cell.config_name)

    batches_in = make_batches(traffic, seed)
    state = seeded_state_dict(ref_mod.skeleton(cfg), seed, dev)
    window = Window(seconds, checked_calls(traffic, seed))
    prog = head.Program(cfg, state, dev, window)
    if fault is not None:
        fault(prog)
    kind.warmup(prog, batches_in, traffic)
    metrics_mods = {m["name"]: registry.metric(m["name"], bench_dir)
                    for m in cell.per_layer} if trace else {}
    span_targets = {s: target for mod in metrics_mods.values()
                    for s, target in mod.SPANS.items()}
    spans = Spans(prog.model)
    tracer = None
    if trace:
        for span, target in span_targets.items():
            spans.place(span, target)
        if on_card:
            tracer = Tracer(window, spans.log,
                            float(traffic["trace_seconds"]))
            tracer.arm()
    counts0 = prog.counters()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    try:
        kept = kind.run_window(prog, batches_in, traffic, window)
    finally:
        if tracer is not None:
            tracer.close()

    if on_card:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    spans.close()
    counts = {k: v - counts0.get(k, 0) for k, v in prog.counters().items()}
    metrics = {}
    e2e = {m["name"]: m for m in cell.end_to_end}
    values = {"pairs_per_s": window.pairs_per_s(),
              "pair_ms_p90": window.latency_ms(90), "setup_s": setup_s}
    if on_card:
        values["peak_mem_gib"] = peak / GIB
    for k, m in e2e.items():
        if k in values and not trace:
            metrics[k] = {"value": values[k], "unit": m["unit"]}
    traced = tracer.reduce(set(span_targets)) if tracer is not None else None

    # the program's state goes before the reference runs; what the check
    # reads stays
    got = {i: {**prog.kept.get(i, {}), **out} for i, (_, out) in kept.items()}
    batches = {i: b for i, (b, _) in kept.items()}
    prog.close()
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ref = ref_mod.Reference(cfg, state, dev)
    readings = {}
    for i in sorted(got):
        zeb = got[i].pop("rows", None)
        r = ref.judge(batches[i], got[i], zeb)
        for k, v in r.items():
            readings[k] = max(readings.get(k, -math.inf), v)
    per_pair = {k: v / window.pairs for k, v in counts.items()}
    for k, want in cfg.get("launches_per_pair", {}).items():
        readings[f"{k}_launch_gap"] = abs(per_pair.get(k, 0.0) - want)
    if window.rows is not None:
        readings["rows_missing"] = float(window.pairs - window.rows)

    breakdown = None
    if traced is not None:
        traced.host_s = dict(window.host_s)
        traced.window_pairs = window.pairs
        if any(getattr(m, "NEEDS_FLOPS", False)
               for m in metrics_mods.values()):
            traced.flops_per_pair = ref.flops_per_pair(batches[min(batches)])
        breakdown = {"device_ops": traced.device_ops,
                     "idle_gaps": traced.idle_gaps}
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        for k, mod in metrics_mods.items():
            v = mod.read(traced)
            if v is not None:
                metrics[k] = {"value": v, "unit": units[k]}
    checked = verdict(readings, cfg["limits"].get(traffic["kind"], {})
                      | cfg["limits"]["all"])
    correct = all(v <= lim for v, lim in checked.values())  # NaN: False
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                "count": 1}
    if on_card:
        dev_info["memory_peak_bytes"] = int(peak)
    if traced is not None:
        dev_info["busy_s"] = traced.busy_s
        dev_info["window_s"] = traced.window_s
    return Result(correct=correct, attempted=window.pairs, failed=0,
                  metrics=metrics, device=dev_info, checked=checked,
                  breakdown=breakdown, readings=readings)
