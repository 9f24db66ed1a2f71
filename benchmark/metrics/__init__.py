"""Per-layer metrics, one file each, named as in `BENCHMARK.json`. Each
declares the spans it reads (`SPANS`: span name -> where the harness
places it) and `read(traced)`, which returns a number or None."""
