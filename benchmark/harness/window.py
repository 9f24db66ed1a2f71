"""The measured window of a closed loop and its arithmetic.

One client hands the program a call, waits until its outputs are on the
host, and hands it the next. The window opens at the first call's start
and closes at the first completion at or after `seconds` later; every call
that started inside it completed inside it. `Window` keeps each call's
start, end and pairs, and which calls the check captures (`checked`).
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field


@dataclass
class Call:
    start: float
    end: float
    pairs: int


@dataclass
class Window:
    seconds: float
    checked: frozenset = frozenset()      # call indices the check reads
    calls: list = field(default_factory=list)
    on_start: list = field(default_factory=list)   # hooks f(call index)
    on_end: list = field(default_factory=list)
    holds: list = field(default_factory=list)      # keep open while true
    host_s: dict = field(default_factory=dict)     # host-clock spans
    rows: int | None = None                        # rows a zeb window gave
    _t0: float | None = None
    _index: int = 0

    @property
    def index(self) -> int:
        """The current call's index."""
        return self._index

    @property
    def capturing(self) -> bool:
        """Whether the current call's outputs are kept for the check."""
        return self._index in self.checked

    def start(self) -> float:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        for f in self.on_start:
            f(self._index)
        return now

    def end(self, started: float, pairs: int) -> bool:
        """Record the current call; True while the window stays open (a
        hold, the traced calls, may keep it open past `seconds`)."""
        now = time.perf_counter()
        self.calls.append(Call(started, now, pairs))
        for f in self.on_end:
            f(self._index)
        self._index += 1
        return now - self._t0 < self.seconds or any(h() for h in self.holds)

    # -- arithmetic ---------------------------------------------------------
    @property
    def span_s(self) -> float:
        return self.calls[-1].end - self.calls[0].start

    @property
    def pairs(self) -> int:
        return sum(c.pairs for c in self.calls)

    def pairs_per_s(self) -> float:
        return self.pairs / self.span_s

    def latency_ms(self, q: int = 90) -> float:
        """The q-th percentile of call latency (start to outputs on the
        host), over every call of the window but those the check captures
        (their copies for the check are not the program's work):
        `statistics.quantiles`' n=100 cut points, its default (exclusive)
        method."""
        lat = [(c.end - c.start) * 1e3 for i, c in enumerate(self.calls)
               if i not in self.checked]
        # a window of captured calls alone (the CPU tests' runs) takes them
        lat = lat or [(c.end - c.start) * 1e3 for c in self.calls]
        if len(lat) < 2:
            return lat[0]
        return statistics.quantiles(lat, n=100)[q - 1]
