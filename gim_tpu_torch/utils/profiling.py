"""Tracing and profiling hooks (port of `gim_tpu/utils/profiling.py`).

The reference has none (SURVEY §5: only tqdm bars and a Timer util). The
JAX package takes `jax.profiler` traces and a stage timer that blocks on
its arrays; here the trace is a `torch.profiler` trace (Chrome trace
files for TensorBoard or Perfetto), an annotation is an NVTX range plus a
`record_function` span (so it shows in both the profiler and an NVTX
timeline), and the stage timer synchronises the devices of the tensors it
is given, so its numbers are honest under CUDA's asynchronous launches.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

from gim_tpu_torch.utils import flags


class TraceAnnotation(contextlib.ContextDecorator):
    """A named span: an NVTX range on a CUDA machine and a
    `record_function` span for `torch.profiler`."""

    def __init__(self, name: str):
        self.name = name
        self._span = None
        self._nvtx = False

    def __enter__(self):
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._span = record_function(self.name)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        return False


@contextlib.contextmanager
def trace(name: str = "gim_tpu", out_dir: str | None = None):
    """`torch.profiler` trace of the block into `out_dir` (default
    `GIM_TPU_TRACE_DIR`), on when `GIM_TPU_TRACE` is set; the CUDA
    activities are traced where a card is present."""
    if not flags.trace_enabled():
        yield
        return
    out_dir = out_dir or flags.trace_dir()
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
