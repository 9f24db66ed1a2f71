"""The window's arithmetic on synthetic call times: where it ends, the
rate over all its work and time, and the 90th percentile."""

import statistics

import pytest

from benchmark.harness import window as W


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def drive(monkeypatch, durations, seconds, pairs=1):
    clock = Clock()
    monkeypatch.setattr(W.time, "perf_counter", clock)
    win = W.Window(seconds)
    for d in durations:
        t = win.start()
        clock.t += d
        if not win.end(t, pairs):
            break
    return win


def test_window_closes_at_first_completion_past_seconds(monkeypatch):
    win = drive(monkeypatch, [0.3] * 100, seconds=1.0)
    # ends 0.3, 0.6, 0.9, 1.2: the fourth call is the first at or past 1 s
    assert len(win.calls) == 4
    assert win.span_s == pytest.approx(1.2)
    assert win.pairs_per_s() == pytest.approx(4 / 1.2)


def test_rate_counts_all_work_and_time(monkeypatch):
    win = drive(monkeypatch, [0.1, 0.5, 0.1, 0.1, 0.5], seconds=10.0,
                pairs=16)
    assert win.pairs == 80
    assert win.pairs_per_s() == pytest.approx(80 / 1.3)


def test_p90_over_every_call(monkeypatch):
    durs = [0.01 * (i % 10 + 1) for i in range(120)]
    win = drive(monkeypatch, durs, seconds=100.0)
    lat = [d * 1e3 for d in durs]
    assert win.latency_ms(90) == pytest.approx(
        statistics.quantiles(lat, n=100)[89])
    assert sum(x > win.latency_ms(90) for x in lat) >= 10


def test_checked_calls_are_marked(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(W.time, "perf_counter", clock)
    win = W.Window(10.0, checked=frozenset({1, 3}))
    seen = []
    for _ in range(5):
        t = win.start()
        seen.append(win.capturing)
        clock.t += 0.1
        win.end(t, 1)
    assert seen == [False, True, False, True, False]


def test_p90_leaves_out_the_captured_calls(monkeypatch):
    """The calls the check captures copy their outputs for it inside the
    call; the latency list leaves them out, the rate keeps them."""
    clock = Clock()
    monkeypatch.setattr(W.time, "perf_counter", clock)
    win = W.Window(100.0, checked=frozenset({3, 5, 7}))
    durs = [0.01 * (i % 10 + 1) for i in range(120)]
    for i, d in enumerate(durs):
        t = win.start()
        clock.t += d + (5.0 if win.capturing else 0.0)
        win.end(t, 1)
    kept = [d * 1e3 for i, d in enumerate(durs) if i not in {3, 5, 7}]
    assert win.latency_ms(90) == pytest.approx(
        statistics.quantiles(kept, n=100)[89])
    assert win.pairs_per_s() == pytest.approx(120 / (sum(durs) + 15.0))
