"""Tracing and profiling hooks (port of `gim_tpu/utils/profiling.py`).

The reference has none (SURVEY §5: only tqdm bars and a Timer util). The
JAX package takes `jax.profiler` traces and a stage timer that blocks on
its arrays; here the trace is a `torch.profiler` trace (Chrome trace
files for TensorBoard or Perfetto), an annotation is a `record_function`
span, and the stage timer synchronises the devices of the tensors it is
given, so its numbers are honest under CUDA's asynchronous launches.

`span(name)` is how the port annotates itself: every matching and ZEB
layer enters one (names start with `gim.`: `gim.match`, `gim.dkm.scale.8`,
`gim.lightglue.layer`, `gim.ransac.lo`, ...). A span is on exactly while
a profiler records, under `trace` or any other `torch.profiler` session;
otherwise it costs one read of the profiler's state and enters a shared
do-nothing context, so nothing is built or allocated. No span
synchronises, copies or reorders anything: outputs are the same bit for
bit with the profiler on and off.

A span is a `record_function` range in the same profiler session that
records the CUDA activities, so it shares their clock: a kernel belongs
to the span whose interval holds its launch's host time. The matching and
ZEB paths run on one host thread in a closed loop, so a span's parent is
the span that encloses it, and spans need no request identifier.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)


class _Named:
    """Used as a decorator, a span is entered at each call of the
    function, and decides then whether it is on."""

    __slots__ = ()

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


class TraceAnnotation(_Named):
    """A named `record_function` span for `torch.profiler`."""

    __slots__ = ("name", "_span")

    def __init__(self, name: str):
        self.name = name
        self._span = None

    def __enter__(self):
        self._span = record_function(self.name)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        return False


class _Off(_Named):
    """A span while no profiler records: enters and leaves at no cost."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF: dict[str, _Off] = {}
# whether a profiler records: one read of the profiler's state in C++,
# which every `torch.profiler` session sets on start and clears on stop
recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """The span `name`, as a context manager (`with span("gim.match"):`)
    or a decorator (`@span("gim.zeb.pose")`): a `TraceAnnotation` while a
    profiler records, else the name's one shared do-nothing context."""
    if recording():
        return TraceAnnotation(name)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name)
    return off


def trace_enabled() -> bool:
    """`GIM_TPU_TRACE`: any non-empty value turns `trace` on, as in the
    JAX package."""
    return bool(os.environ.get("GIM_TPU_TRACE"))


def trace_dir() -> str:
    """`GIM_TPU_TRACE_DIR`: where `trace` writes (default `gim_tpu_trace`
    in the temporary directory, `/tmp` for the JAX package)."""
    return os.environ.get("GIM_TPU_TRACE_DIR", os.path.join(
        tempfile.gettempdir(), "gim_tpu_trace"))


@contextlib.contextmanager
def trace(name: str = "gim_tpu", out_dir: str | None = None):
    """`torch.profiler` trace of the block into `out_dir` (default
    `GIM_TPU_TRACE_DIR`), on when `GIM_TPU_TRACE` is set; the CUDA
    activities are traced where a card is present."""
    if not trace_enabled():
        yield
        return
    out_dir = out_dir or trace_dir()
    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(out_dir)):
        with TraceAnnotation(name):
            yield


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class StageTimer:
    """Accumulates per-stage wall time, synchronising the devices of the
    tensors in `sync_on` (a tensor or a nest of lists, tuples and dicts)
    before it reads the clock."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            cards = {leaf.device for leaf in _leaves(sync_on)
                     if torch.is_tensor(leaf) and leaf.is_cuda}
            for dev in cards:
                torch.cuda.synchronize(dev)
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k:<28} {v * 1000:9.1f} ms  "
                 f"{100 * v / max(total, 1e-9):5.1f}%"
                 for k, v in sorted(self.times.items(), key=lambda x: -x[1])]
        lines.append(f"{'total':<28} {total * 1000:9.1f} ms")
        return "\n".join(lines)
