"""gim_roma's spans (`models/roma/model.py`, `ops/kernels/flash.py`) and the
benchmark metrics that read them: under a CPU `torch.profiler` every
`gim.roma.*` span of a tiny gim_roma call appears, nested where its work
is, and the outputs are the same bit for bit with the profiler off; the
benchmark's wrapper on `models/dinov2.flash_sdpa` sees every attention
with its shapes; `flash_attention_roofline`'s floor at the cell's shapes
is the hand-computed one; the `roma.*` metrics read their spans."""

from __future__ import annotations

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import registry
from benchmark.harness.peaks import PEAK_BYTES, PEAK_TF32_FLOPS
from benchmark.harness.spans import Spans
from benchmark.harness.trace import Traced
from gim_tpu_torch import config as C
from gim_tpu_torch.api import Matcher

RES, DEPTH, BLOCKS = 56, 2, 5
SCALES = ("16", "8", "4", "2", "1")


@pytest.fixture(scope="module")
def matcher():
    cfg = C.GimConfig()
    cfg = C.replace(cfg, roma=C.replace(
        cfg.roma, coarse_res=RES, upsample_res=(2 * RES, 2 * RES),
        dino_depth=DEPTH, num_samples=128))
    return Matcher("gim_roma", cfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    g = torch.Generator().manual_seed(5)
    im0, im1 = (torch.rand(1, 3, 96, 96, generator=g) for _ in range(2))
    mask = torch.zeros(1, 96, 96, dtype=torch.bool)
    mask[:, :72, :] = True
    return im0, im1, mask


def match(matcher, pair):
    im0, im1, mask = pair
    r = matcher.match(im0, im1, mask0=mask, mask1=mask)
    return [r.kpts0, r.kpts1, r.conf, r.valid]


@pytest.fixture(scope="module")
def traced(matcher, pair):
    # both switches on: K2 and K3 run their plain versions on the CPU
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GIM_TPU_FUSED_REFINER", "1")
        mp.setenv("GIM_TPU_FLASH_VIT", "1")
        off = match(matcher, pair)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = match(matcher, pair)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith("gim.")),
                   key=lambda s: s[1:])
    return off, on, spans


def inside(spans, child: str, parent: str) -> bool:
    outer = [(a, b) for n, a, b in spans if n == parent]
    return all(any(a <= c and d <= b for a, b in outer)
               for n, c, d in spans if n == child)


def test_every_roma_span_appears_once_per_call_of_its_layer(traced):
    count = collections.Counter(n for n, _, _ in traced[2])
    assert dict(count) == {
        "gim.match": 1, "gim.match.inputs": 1,
        # both passes run VGG19 and the decoder; DINOv2 and the match
        # decoder run in the coarse pass, which alone has scale 16
        "gim.roma.vgg": 2, "gim.roma.dinov2": 1, "gim.roma.decoder": 2,
        "gim.roma.match_decoder": 1,
        "gim.roma.scale.16": 1, "gim.roma.refiner.16": 1,
        **{f"gim.roma.scale.{s}": 2 for s in SCALES[1:]},
        **{f"gim.roma.refiner.{s}": 2 for s in SCALES[1:]},
        # 8 hidden blocks a refiner at scales 2 and 1, both passes
        "gim.refiner_block": 32,
        # the sampling is the code gim_dkm runs, under its name
        "gim.dkm.sample": 1,
        # no "gim.flash_attention": with the switch on, `flash_sdpa` runs
        # K3's plain version on the CPU, and the span marks the kernel
    }


@pytest.mark.parametrize("child,parent", [
    ("gim.roma.vgg", "gim.match"),
    ("gim.roma.dinov2", "gim.match"),
    ("gim.roma.decoder", "gim.match"),
    ("gim.roma.scale.16", "gim.roma.decoder"),
    ("gim.roma.match_decoder", "gim.roma.scale.16"),
    ("gim.roma.refiner.16", "gim.roma.scale.16"),
    ("gim.roma.refiner.8", "gim.roma.scale.8"),
    ("gim.roma.refiner.1", "gim.roma.scale.1"),
    ("gim.dkm.sample", "gim.match"),
])
def test_roma_spans_nest_where_their_work_is(traced, child, parent):
    assert inside(traced[2], child, parent)


def test_the_refiner_blocks_lie_in_the_narrow_refiners(traced):
    spans = traced[2]
    narrow = [(a, b) for n, a, b in spans
              if n in ("gim.roma.refiner.2", "gim.roma.refiner.1")]
    assert all(any(a <= c and d <= b for a, b in narrow)
               for n, c, d in spans if n == "gim.refiner_block")
    # the match decoder is not inside a refiner, nor the trunk in the
    # decoder
    assert not inside(spans, "gim.roma.match_decoder", "gim.roma.refiner.16")
    assert not inside(spans, "gim.roma.dinov2", "gim.roma.decoder")


def test_outputs_are_the_same_bit_for_bit_with_the_profiler_on(traced):
    off, on, _ = traced
    for x, y in zip(off, on, strict=True):
        assert torch.equal(x, y)


def test_the_wrapper_on_flash_sdpa_sees_every_attention(matcher, pair,
                                                        monkeypatch):
    """`Attention.forward` looks `flash_sdpa` up at call time, so the
    benchmark's span sees DINOv2's and the decoder's attentions with their
    (B, H, N, D) shapes."""
    monkeypatch.setenv("GIM_TPU_FLASH_VIT", "1")
    metric = registry.metric("flash_attention_roofline")
    spans = Spans(matcher.model)
    for name, target in metric.SPANS.items():
        spans.place(name, target)
    spans.log.recording = True
    try:
        match(matcher, pair)
    finally:
        spans.close()
    n = (RES // 14) ** 2
    q = [shapes[0] for shapes in spans.log.shapes["flash_attention"]]
    assert q == [(2, 16, n + 1, 64)] * DEPTH + [(2, 8, n, 128)] * BLOCKS
    assert all(len(shapes) == 3 for shapes in
               spans.log.shapes["flash_attention"])


def test_flash_floor_at_the_cell_shapes_is_the_hand_computed_one():
    """24 DINOv2 attentions (2, 16, 2305, 64) and 5 decoder attentions
    (2, 8, 2304, 128) a pair: 4 B H N^2 D products each, counted once at
    the TF32 peak, bound the floor; q, k, v and the output at 3.35 TB/s
    take a quarter of that."""
    floor = registry.metric("flash_attention_roofline").floor_s
    vit, dec = floor(2, 16, 2305, 64), floor(2, 8, 2304, 128)
    products = (24 * 4 * 2 * 16 * 2305 ** 2 * 64
                + 5 * 4 * 2 * 8 * 2304 ** 2 * 128)
    assert products == 1_262_015_938_560
    assert 24 * vit["floor"] + 5 * dec["floor"] == pytest.approx(
        products / PEAK_TF32_FLOPS, rel=1e-12)
    assert 24 * vit["floor"] + 5 * dec["floor"] == pytest.approx(
        2.5495e-3, rel=1e-4)
    assert vit["bytes"] == pytest.approx(16 * 2 * 16 * 2305 * 64
                                         / PEAK_BYTES)
    assert vit["products"] > 3 * vit["bytes"]
    assert dec["products"] > 3 * dec["bytes"]


def test_flash_roofline_reads_a_hand_built_traced():
    metric = registry.metric("flash_attention_roofline")
    vit, dec = (2, 16, 2305, 64), (2, 8, 2304, 128)
    floor = (24 * metric.floor_s(*vit)["floor"]
             + 5 * metric.floor_s(*dec)["floor"])
    t = Traced(window_s=6.0, busy_s=5.0, pairs=1,
               span_device_s={"flash_attention": 0.0132},
               span_shapes={"flash_attention": [[vit] * 3] * 24
                            + [[dec] * 3] * 5})
    assert metric.read(t) == pytest.approx(100 * floor / 0.0132)
    assert 19.0 < metric.read(t) < 19.5
    # a trace without the kernel's calls reads nothing
    assert metric.read(Traced(6.0, 5.0, 1, {"flash_attention": 0.0},
                              {})) is None


@pytest.mark.parametrize("name,spans,want", [
    ("roma.vgg_ms", {"gim.roma.vgg": 0.2}, 100.0),
    ("roma.dinov2_ms", {"gim.roma.dinov2": 0.14}, 70.0),
    ("roma.match_decoder_ms", {"gim.roma.match_decoder": 0.05}, 25.0),
    ("roma.refiner_ms", {f"gim.roma.refiner.{s}": 0.08 for s in SCALES},
     200.0),
])
def test_roma_metrics_read_the_port_spans(name, spans, want):
    metric = registry.metric(name)
    assert set(metric.SPANS) == set(spans)
    t = Traced(window_s=6.0, busy_s=5.0, pairs=2,
               span_device_s={**spans, "gim.roma.decoder": 9.0},
               span_shapes={})
    assert metric.read(t) == pytest.approx(want)
    # a port without the spans (an older one) reads nothing
    t.span_device_s = {}
    assert metric.read(t) is None
