"""The port's own spans (`utils/profiling.span`) on the matching and ZEB
paths: under a CPU `torch.profiler` every span appears, nested where its
work is; with no profiler no `record_function` is built; the outputs are
the same bit for bit either way. Then the benchmark's reading of a span
the port places (`benchmark/harness/program.py`) and the metric
`dkm.wide_refiner_ms` on a hand-built `Traced`. Sizes are
`benchmark/tests/small.py`'s."""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.harness import registry
from benchmark.harness.program import TARGET
from benchmark.harness.spans import Spans
from benchmark.harness.trace import WINDOW_SPAN, Traced, reduce_events
from benchmark.tests.small import LIGHTGLUE, TRAFFIC
from benchmark.tests.test_bench_trace import Ev
from gim_tpu_torch import config as C
from gim_tpu_torch.api import MatchResult, Matcher
from gim_tpu_torch.eval import zeb as E
from gim_tpu_torch.ops.kernels import forward_only
from gim_tpu_torch.utils import profiling as tprof

N_LAYERS = LIGHTGLUE["config"]["gim_config"]["lightglue"]["n_layers"]
S = TRAFFIC["canvas"]


def small_config() -> C.GimConfig:
    cfg = C.GimConfig()
    sp, lg = cfg.superpoint, cfg.lightglue
    return C.replace(
        cfg, superpoint=C.replace(sp, max_num_keypoints=256),
        lightglue=C.replace(lg, n_layers=N_LAYERS),
        dkm=C.replace(cfg.dkm, h_resized=64, w_resized=96,
                      upsample_res=(96, 128), num_samples=200))


@pytest.fixture(scope="module")
def matchers():
    cfg = small_config()
    return {name: Matcher(name, cfg, device="cpu")
            for name in ("gim_lightglue", "gim_dkm")}


@pytest.fixture(scope="module")
def pair():
    g = torch.Generator().manual_seed(5)
    im0, im1 = (torch.rand(1, 3, S, S, generator=g) for _ in range(2))
    mask = torch.zeros(1, S, S, dtype=torch.bool)
    mask[:, :TRAFFIC["content"][0][0], :] = True
    return im0, im1, mask


def planted_batch(B: int = 2, M: int = 64):
    """A ZEB batch of B pairs whose M matches see one rigid scene, and a
    `match` that returns them."""
    rng = np.random.default_rng(3)
    K = np.array([[100.0, 0, 48], [0, 100.0, 48], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.3, 0.05, 0.0)
    X = rng.uniform((-1, -1, 3), (1, 1, 5), (B, M, 3)).astype(np.float32)
    x0 = X @ K.T
    x1 = (X + T[:3, 3]) @ K.T
    k0 = x0[..., :2] / x0[..., 2:]
    k1 = x1[..., :2] / x1[..., 2:]
    batch = {"identifier": [f"planted/{b}" for b in range(B)],
             "covisible0": [1.0] * B, "covisible1": [1.0] * B,
             "K0": np.stack([K] * B), "K1": np.stack([K] * B),
             "T_0to1": np.stack([T] * B)}
    res = MatchResult(torch.from_numpy(k0), torch.from_numpy(k1),
                      torch.ones(B, M), torch.ones(B, M, dtype=torch.bool))
    return batch, lambda _: res


def run_paths(matchers, pair):
    """One gim_lightglue match, one gim_dkm match (K2's switch on: its
    plain version on the CPU) and one ZEB batch; their outputs."""
    im0, im1, mask = pair
    out = {}
    for name, m in matchers.items():
        r = m.match(im0, im1, mask0=mask, mask1=mask)
        out[name] = [r.kpts0, r.kpts1, r.conf, r.valid]
    batch, match = planted_batch()
    rows = E.evaluate(match, [batch], num_hypotheses=64, progress=False)
    out["zeb"] = [np.asarray(r[k], np.float64) for r in rows
                  for k in ("epi_errs", "inliers", "R_errs", "t_errs")]
    return out


def gim_spans(prof) -> list[tuple[str, int, int]]:
    """(name, start, end) of the port's spans, in order of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("gim.")),
                  key=lambda s: s[1:])


def inside(spans, child: str, parent: str) -> bool:
    """Every `child` span lies inside some `parent` span."""
    outer = [(a, b) for n, a, b in spans if n == parent]
    return all(any(a <= c and d <= b for a, b in outer)
               for n, c, d in spans if n == child)


@pytest.fixture(scope="module")
def traced(matchers, pair):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(forward_only, "on_kernel", lambda x: True)
        off = run_paths(matchers, pair)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = run_paths(matchers, pair)
    return off, on, gim_spans(prof)


def test_every_span_appears_once_per_call_of_its_layer(traced):
    _, _, spans = traced
    count = collections.Counter(n for n, _, _ in spans)
    want = {
        # two matches; the ZEB batch's `match` is planted, not the port's
        "gim.match": 2, "gim.match.inputs": 2,
        "gim.superpoint": 2, "gim.superpoint.keypoints": 2,
        "gim.lightglue": 1, "gim.lightglue.layer": N_LAYERS,
        "gim.lightglue.assign": 1,
        "gim.dkm.encoder": 2, "gim.dkm.decoder": 2, "gim.dkm.sample": 1,
        "gim.dkm.scale.32": 1, "gim.dkm.scale.16": 1,
        "gim.dkm.refiner.16": 1,
        # the upsample pass runs strides 8 .. 1 again
        **{f"gim.dkm.scale.{s}": 2 for s in ("8", "4", "2", "1")},
        **{f"gim.dkm.refiner.{s}": 2 for s in ("8", "4", "2", "1")},
        # 8 hidden blocks a refiner at strides 2 and 1, both passes
        "gim.refiner_block": 32,
        "gim.zeb.pose": 1, "gim.zeb.rows": 1, "gim.ransac.noise": 1,
        "gim.ransac.hypotheses": 1, "gim.ransac.lo": 1,
        "gim.ransac.solve": 2, "gim.ransac.score": 2,
        "gim.ransac.irls": 1, "gim.pose.recover": 1,
    }
    assert dict(count) == want


@pytest.mark.parametrize("child,parent", [
    ("gim.match.inputs", "gim.match"),
    ("gim.superpoint", "gim.match"),
    ("gim.superpoint.keypoints", "gim.superpoint"),
    ("gim.lightglue", "gim.match"),
    ("gim.lightglue.layer", "gim.lightglue"),
    ("gim.lightglue.assign", "gim.lightglue"),
    ("gim.dkm.encoder", "gim.match"),
    ("gim.dkm.decoder", "gim.match"),
    ("gim.dkm.sample", "gim.match"),
    ("gim.dkm.scale.8", "gim.dkm.decoder"),
    ("gim.dkm.refiner.16", "gim.dkm.scale.16"),
    ("gim.dkm.refiner.4", "gim.dkm.scale.4"),
    ("gim.refiner_block", "gim.dkm.decoder"),
    ("gim.ransac.noise", "gim.zeb.pose"),
    ("gim.ransac.solve", "gim.zeb.pose"),
    ("gim.ransac.irls", "gim.zeb.pose"),
    ("gim.pose.recover", "gim.zeb.pose"),
])
def test_spans_nest_where_their_work_is(traced, child, parent):
    assert inside(traced[2], child, parent)


def test_each_ransac_round_solves_and_scores(traced):
    spans = traced[2]
    for rnd in ("gim.ransac.hypotheses", "gim.ransac.lo"):
        a, b = next((a, b) for n, a, b in spans if n == rnd)
        held = {n for n, c, d in spans if a <= c and d <= b and n != rnd}
        assert held == {"gim.ransac.solve", "gim.ransac.score"}
    assert not inside(spans, "gim.zeb.rows", "gim.zeb.pose")
    refiners = [(a, b) for n, a, b in spans
                if n in ("gim.dkm.refiner.2", "gim.dkm.refiner.1")]
    assert all(any(a <= c and d <= b for a, b in refiners)
               for n, c, d in spans if n == "gim.refiner_block")


def test_outputs_are_the_same_bit_for_bit_with_the_profiler_on(traced):
    off, on, _ = traced
    assert off.keys() == on.keys()
    for k in off:
        for x, y in zip(off[k], on[k], strict=True):
            if torch.is_tensor(x):
                assert torch.equal(x, y), k
            else:
                np.testing.assert_array_equal(x, y, err_msg=k)


def test_no_span_is_built_while_no_profiler_records(matchers, pair,
                                                     monkeypatch):
    built = []

    def counting(name):
        built.append(name)
        return record_function(name)

    monkeypatch.setattr(tprof, "record_function", counting)
    monkeypatch.setattr(forward_only, "on_kernel", lambda x: True)
    assert not tprof.recording()
    run_paths(matchers, pair)
    assert built == []
    # the same calls build spans while a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        assert tprof.recording()
        with tprof.span("gim.test"):
            pass
    assert not tprof.recording() and built == ["gim.test"]


def test_span_is_a_context_manager_and_a_decorator():
    assert tprof.span("gim.a") is tprof.span("gim.a")     # shared, off

    @tprof.span("gim.deco")
    def f(x):
        with tprof.span("gim.inner"):
            return x + 1

    assert f(1) == 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert f(2) == 3
        with pytest.raises(ValueError):
            with tprof.span("gim.raises"):
                raise ValueError
    spans = gim_spans(prof)
    assert [n for n, _, _ in spans] == ["gim.deco", "gim.inner",
                                        "gim.raises"]
    assert inside(spans, "gim.inner", "gim.deco")


# -- the benchmark's reading of spans the port places ----------------------

def test_a_program_target_places_no_span(matchers, pair):
    metric = registry.metric("dkm.wide_refiner_ms")
    assert set(metric.SPANS.values()) == {TARGET}
    spans = Spans(matchers["gim_dkm"].model)
    for name, target in metric.SPANS.items():
        spans.place(name, target)
    im0, im1, mask = pair
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            matchers["gim_dkm"].match(im0, im1, mask0=mask, mask1=mask)
    finally:
        spans.close()
    count = collections.Counter(n for n, _, _ in gim_spans(prof))
    # the port's own: the upsample pass has no stride 16
    assert [count[n] for n in metric.SPANS] == [1, 2, 2]


def test_the_trace_reads_a_span_the_program_places():
    ms = 1_000_000
    events = [
        Ev(WINDOW_SPAN, 0, 100 * ms, annot=True),
        Ev("dkm.decoder", 10 * ms, 60 * ms, annot=True),
        Ev("gim.dkm.refiner.8", 20 * ms, 30 * ms, annot=True),
        Ev("gim.dkm.refiner.2", 40 * ms, 50 * ms, annot=True),
        Ev("cudaLaunchKernel", 2 * ms, 3 * ms, corr=3),
        Ev("cudaLaunchKernel", 21 * ms, 22 * ms, corr=1),
        Ev("cudaLaunchKernel", 41 * ms, 42 * ms, corr=2),
        Ev("early", 5 * ms, 21 * ms, dev=True, corr=3),
        Ev("wide_1x1", 25 * ms, 35 * ms, dev=True, corr=1),
        Ev("k2", 45 * ms, 47 * ms, dev=True, corr=2),
    ]
    metric = registry.metric("dkm.wide_refiner_ms")
    t = reduce_events(events, {"dkm.decoder", *metric.SPANS}, pairs=2,
                      shapes={})
    assert t.span_device_s["gim.dkm.refiner.8"] == pytest.approx(0.010)
    assert t.span_device_s["gim.dkm.refiner.16"] == 0
    assert t.span_device_s["dkm.decoder"] == pytest.approx(0.012)
    assert metric.read(t) == pytest.approx(5.0)       # 10 ms over 2 pairs
    # an idle gap takes the innermost span it begins in, the port's where
    # a metric reads it; the refiner at 2 is read by none
    assert dict(t.idle_gaps) == pytest.approx({
        "outside spans: host": 0.005, "gim.dkm.refiner.8: host": 0.004,
        "dkm.decoder: host": 0.063})


def test_wide_refiner_ms_reads_a_hand_built_traced():
    metric = registry.metric("dkm.wide_refiner_ms")
    t = Traced(window_s=6.0, busy_s=5.0, pairs=4,
               span_device_s={"gim.dkm.refiner.16": 0.1,
                              "gim.dkm.refiner.8": 0.3,
                              "gim.dkm.refiner.4": 0.2,
                              "gim.dkm.refiner.2": 9.0},
               span_shapes={})
    assert metric.read(t) == pytest.approx(150.0)
    # a program without the spans (an older port) reads nothing
    t.span_device_s = {name: 0.0 for name in metric.SPANS}
    assert metric.read(t) is None
    t.span_device_s = {}
    assert metric.read(t) is None
