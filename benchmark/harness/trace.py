"""The traced part of a `--trace 1` run and its reduction.

`Tracer` runs `torch.profiler` (CPU and CUDA activities) over the
window's first calls: from the first call's start to the end of the first
call that ends `seconds` or more later, so the traced window is whole
calls.
`reduce` reads the profiler's events:

- busy: the union of the device activities' intervals (kernels, copies,
  sets; not annotation ranges), so time where two run at once counts
  once, within the traced window (the `bench.traced_window` range);
- a span's device time: the summed duration of the device activities
  launched inside it, each activity placed at the host time of its launch
  (the runtime call with its correlation id, else the operator it is
  linked to), so it reads the work a span launched whatever kernel does
  it;
- the breakdown: the device operations that took most time, and the
  device's idle time summed by what the host was doing when each gap
  began (the innermost benchmark span and the operator then running).
"""

from __future__ import annotations

import bisect
import collections
import time
from dataclasses import dataclass, field

import torch

WINDOW_SPAN = "bench.traced_window"
NAME_CHARS = 160      # kernel names in the breakdown are cut to this


@dataclass
class Traced:
    """What a per-layer metric reads."""

    window_s: float                  # the traced window's length
    busy_s: float                    # device busy (union) in it
    pairs: int                       # pairs the traced calls completed
    span_device_s: dict              # span -> device seconds launched in it
    span_shapes: dict                # span -> [arg shapes] of traced calls
    host_s: dict = field(default_factory=dict)  # host spans, whole window
    window_pairs: int = 0            # pairs of the whole window
    flops_per_pair: float | None = None
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    activities: int = 0


class Tracer:
    """The profiler is started at the end of set-up (`arm`), so its own
    start-up stays out of the window; the traced window opens at the
    window's first call and holds the window open until it closes."""

    def __init__(self, window, log, seconds: float):
        self.window, self.log, self.seconds = window, log, seconds
        self.prof = None
        self.calls = []
        self._t0 = self._t1 = None
        self._range = None
        window.on_start.append(self._start)
        window.on_end.append(self._end)
        window.holds.append(lambda: not self.done)

    def arm(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def _start(self, i: int) -> None:
        if self._t0 is not None:
            return
        from torch.profiler import record_function

        self._range = record_function(WINDOW_SPAN)
        self._range.__enter__()
        self.log.recording = True
        self._t0 = time.perf_counter()

    def _end(self, i: int) -> None:
        if self._t0 is None or self._t1 is not None:
            return
        self.calls.append(i)
        if time.perf_counter() - self._t0 >= self.seconds:
            torch.cuda.synchronize()
            self._t1 = time.perf_counter()
            self._range.__exit__(None, None, None)
            self.log.recording = False
            self.prof.stop()

    def close(self) -> None:
        """Stop the profiler if a failed window left it running."""
        if self.prof is not None and self._t1 is None:
            self._t1 = time.perf_counter()
            self.prof.stop()

    @property
    def done(self) -> bool:
        return self._t1 is not None

    def reduce(self, spans, top: int = 10) -> Traced:
        if not self.done:
            raise RuntimeError("the window closed before the traced calls "
                               "ended")
        pairs = sum(self.window.calls[i].pairs for i in self.calls)
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             set(spans), pairs, self.log.shapes, top)


def _union(intervals):
    """Merged (start, end) of sorted intervals, and their total length."""
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged, sum(b - a for a, b in merged)


def _innermost(starts, items, t):
    """The latest-starting of `items` ((start, end, name), sorted by
    start) that contains t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        if items[j][1] >= t:
            return items[j][2]
    return None


def reduce_events(events, spans: set, pairs: int, shapes: dict,
                  top: int = 10) -> Traced:
    """A `Traced` from the profiler's events; the window is the
    `bench.traced_window` range."""
    from torch.autograd import DeviceType

    dev, ops, annots, launches, linked = [], [], [], {}, {}
    edges = None
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and b > a:
                dev.append((a, b, e.name(), e.correlation_id(),
                            e.linked_correlation_id()))
            continue
        name = e.name()
        if e.is_user_annotation():
            if name == WINDOW_SPAN:
                edges = (a, b)
            elif name in spans:
                annots.append((a, b, name))
            continue
        if name.startswith(("cuda", "cu")):
            launches[e.correlation_id()] = a
        else:
            linked[e.correlation_id()] = a
            ops.append((a, b, name))
    if edges is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} range")
    dev = sorted(d for d in dev if d[0] >= edges[0] and d[1] <= edges[1])
    if not dev:
        raise RuntimeError("the profiler saw no device activity")
    merged, busy = _union((a, b) for a, b, *_ in dev)

    per_span = collections.defaultdict(list)
    for a, b, name in annots:
        per_span[name].append((a, b))
    span_ns = {name: 0 for name in spans}
    for name, iv in per_span.items():
        iv.sort()
        starts = [a for a, _ in iv]
        ends = [b for _, b in iv]
        for a, b, _, corr, link in dev:
            t = launches.get(corr, linked.get(link))
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ends[i]:
                span_ns[name] += b - a

    by_op = collections.Counter()
    for a, b, name, *_ in dev:
        by_op[name] += b - a
    ops.sort()
    annots.sort()
    op_starts = [o[0] for o in ops]
    an_starts = [o[0] for o in annots]
    gaps = collections.Counter()
    prev = edges[0]
    for a, b in merged + [[edges[1], edges[1]]]:
        if a > prev:
            what = (f"{_innermost(an_starts, annots, prev) or 'outside spans'}"
                    f": {_innermost(op_starts, ops, prev) or 'host'}")
            gaps[what] += a - prev
        prev = max(prev, b)
    return Traced(
        window_s=(edges[1] - edges[0]) / 1e9, busy_s=busy / 1e9, pairs=pairs,
        span_device_s={k: v / 1e9 for k, v in span_ns.items()},
        span_shapes=shapes,
        device_ops=[[k[:NAME_CHARS], v / 1e9]
                    for k, v in by_op.most_common(top)],
        idle_gaps=[[k, v / 1e9] for k, v in gaps.most_common(top)],
        activities=len(dev))
