"""Spans the port places itself.

The port annotates its own layers (`gim_tpu_torch/utils/profiling.span`,
names starting with `gim.`), so a metric that reads such a span needs no
wrapper. Its `SPANS` gives the span the target `TARGET`: the harness wraps
`placed`, which nothing calls, so the trace's only ranges of that name are
the port's, and the name joins the spans `trace.reduce_events` reads (the
device time launched inside them, and the idle gaps that begin in them).
A port without the span leaves the metric nothing to read.
"""

TARGET = "benchmark.harness.program:placed"


def placed():
    """Never called: the target of spans the port places itself."""
