"""Spans the benchmark places around the port's modules and functions.

A target names where a span goes:

- `model:<path>`: the submodule at attribute path `<path>` of the
  matcher's model (`model:decoder`); its `forward` is wrapped on the
  instance;
- `<python.module>:<name>`: the function `<name>` of that module, which
  is replaced by a wrapper for the run (`gim_tpu_torch.api:extract`), so
  callers that look the name up in that module find the wrapper.

A span is a `torch.profiler.record_function` range named after it, so the
device's work launched inside it can be read from the trace. Each span
also counts its calls and keeps the shapes of its tensor arguments
while `recording` is on (the traced calls), for metrics that count work
from shapes. Spans are placed only in traced runs.
"""

from __future__ import annotations

import functools
import importlib
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function


@dataclass
class SpanLog:
    recording: bool = False
    shapes: dict = field(default_factory=dict)   # span -> [arg shapes]

    def note(self, name: str, args) -> None:
        if self.recording:
            self.shapes.setdefault(name, []).append(
                [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)])


def _wrap(fn, name: str, log: SpanLog):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        log.note(name, args)
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapper


class Spans:
    """Places spans for the run and takes them away on `close`."""

    def __init__(self, model: torch.nn.Module | None):
        self.model = model
        self.log = SpanLog()
        self._undo = []

    def place(self, name: str, target: str) -> None:
        where, attr = target.split(":", 1)
        if where == "model":
            mod = self.model
            for part in attr.split("."):
                mod = getattr(mod, part)
            mod.forward = _wrap(mod.forward, name, self.log)
            self._undo.append(lambda m=mod: m.__dict__.pop("forward", None))
        else:
            owner = importlib.import_module(where)
            old = getattr(owner, attr)
            setattr(owner, attr, _wrap(old, name, self.log))
            self._undo.append(lambda o=owner, a=attr, f=old: setattr(o, a, f))

    def close(self) -> None:
        while self._undo:
            self._undo.pop()()
