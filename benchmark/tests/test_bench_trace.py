"""The trace's reduction on synthetic profiler events: the busy union,
device time placed by the host time of its launch, and the breakdown."""

import pytest
from torch.autograd import DeviceType

from benchmark.harness.trace import WINDOW_SPAN, reduce_events


class Ev:
    def __init__(self, name, a, b, dev=False, annot=False, corr=0, link=0):
        self._n, self._a, self._b = name, a, b
        self._d, self._u, self._c, self._l = dev, annot, corr, link

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def is_user_annotation(self):
        return self._u

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def test_busy_spans_and_gaps():
    ms = 1_000_000
    events = [
        Ev(WINDOW_SPAN, 0, 100 * ms, annot=True),
        Ev("dkm.decoder", 10 * ms, 20 * ms, annot=True),
        Ev("aten::conv2d", 11 * ms, 12 * ms, corr=7),
        Ev("cudaLaunchKernel", 11 * ms, 12 * ms, corr=501),
        Ev("cudaLaunchKernel", 15 * ms, 16 * ms, corr=502),
        Ev("cudaLaunchKernel", 30 * ms, 31 * ms, corr=503),
        # launched inside the span, run after it on the device
        Ev("conv_kernel", 18 * ms, 40 * ms, dev=True, corr=501),
        Ev("gemm_kernel", 35 * ms, 45 * ms, dev=True, corr=502),
        Ev("other_kernel", 60 * ms, 70 * ms, dev=True, corr=503),
        # the profiler's own range on the device is not an activity
        Ev("dkm.decoder", 18 * ms, 45 * ms, dev=True, annot=True),
    ]
    t = reduce_events(events, {"dkm.decoder"}, pairs=2, shapes={})
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.037)        # [18, 45] and [60, 70]
    assert t.span_device_s["dkm.decoder"] == pytest.approx(0.032)
    assert t.device_ops[0] == ["conv_kernel", pytest.approx(0.022)]
    assert sum(v for _, v in t.idle_gaps) == pytest.approx(0.063)
    assert t.activities == 3
