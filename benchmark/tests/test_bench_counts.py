"""The work the benchmark counts, against closed forms: K2's floor at
gim_dkm's four shapes, and the FLOPs of the reference."""

import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import peaks
from benchmark.harness import registry

# gim_dkm's hidden-block inputs a call (two images), 8 blocks each
DKM_SHAPES = ((2, 144, 330, 440), (2, 24, 660, 880), (2, 144, 576, 768),
              (2, 24, 1152, 1536))


def test_refiner_floor_closed_form():
    """At these shapes every block is bound by its bytes: x read and the
    output written once in float32, the parameters once."""
    total = 0.0
    for B, C, H, W in DKM_SHAPES:
        t = peaks.refiner_block_floor_s(B, C, C, H, W)
        byte = 4 * (B * H * W * 2 * C + 26 * C + C * C + C) / 3.35e12
        assert t["bytes"] == pytest.approx(byte, rel=1e-12)
        assert t["depthwise"] == pytest.approx(
            50 * C * B * H * W / 66.9e12, rel=1e-12)
        assert t["pointwise"] == pytest.approx(
            2 * C * C * B * H * W / 495e12, rel=1e-12)
        assert t["floor"] == t["bytes"]
        total += 8 * t["floor"]
    assert total * 1e3 == pytest.approx(5.3886, abs=1e-4)


def test_refiner_roofline_reads_floor_over_time():
    m = registry.metric("refiner_block_roofline")
    x, w1 = (2, 144, 576, 768), (144, 144)
    t = type("T", (), {})()
    t.span_shapes = {"refiner_block": [[x, (144, 25), (144,), w1, (144,)]]}
    floor = peaks.refiner_block_floor_s(2, 144, 144, 576, 768)["floor"]
    t.span_device_s = {"refiner_block": 4 * floor}
    assert m.read(t) == pytest.approx(25.0)
    t.span_device_s = {"refiner_block": 0.0}
    assert m.read(t) is None


def test_flop_counter_counts_grouped_conv_and_linear_closed_form():
    conv = nn.Conv2d(24, 24, 5, padding=2, groups=24)
    pw = nn.Conv2d(24, 48, 1)
    lin = nn.Linear(64, 32)
    x = torch.randn(2, 24, 10, 12)
    with FlopCounterMode(display=False) as fc:
        pw(conv(x))
        lin(torch.randn(7, 64))
    want = (2 * 24 * 25 * 2 * 10 * 12      # depthwise: weight (24, 1, 5, 5)
            + 2 * 48 * 24 * 2 * 10 * 12    # 1x1
            + 2 * 7 * 64 * 32)             # linear
    assert fc.get_total_flops() == want


def test_reference_conv_flops_closed_form(monkeypatch):
    """The gim_dkm reference's count at a small size: its convolutions'
    part equals the closed form 2 x (weight's entries) x (output pixels)
    over every `F.conv2d` it runs, and the products of the GP and the
    local correlation come on top."""
    import torch.nn.functional as F

    from benchmark.harness.cell import merge
    from benchmark.harness.inputs import make_batches
    from benchmark.harness.weights import seeded_state_dict
    from benchmark.reference import gim_dkm
    from benchmark.tests.small import OVERRIDES

    cell = registry.cell("dkm-match")
    cfg = merge(cell.config, OVERRIDES["dkm-match"]["config"])
    traffic = merge(cell.traffic, OVERRIDES["dkm-match"]["traffic"])
    ref = gim_dkm.Reference(cfg, seeded_state_dict(gim_dkm.skeleton(cfg), 1,
                                                   "cpu"), "cpu")
    b = make_batches(traffic, 1)[0]
    convs = []
    inner = F.conv2d

    def conv2d(x, w, *args, **kwargs):
        out = inner(x, w, *args, **kwargs)
        convs.append(2 * w.numel() * out.shape[0] * out.shape[2]
                     * out.shape[3])
        return out
    monkeypatch.setattr(F, "conv2d", conv2d)
    with FlopCounterMode(display=False) as fc:
        ref.outputs(b)
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert by_op["aten.convolution"] == sum(convs) > 0
    assert fc.get_total_flops() > sum(convs)
    monkeypatch.undo()
    assert ref.flops_per_pair(b) == fc.get_total_flops()
