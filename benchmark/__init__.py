"""The port's benchmark: one cell of `BENCHMARK.json` run once.

`python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` builds the cell's configuration from the seed, warms up
its shapes, drives `gim_tpu_torch` for the window, checks what the timed
path produced against the plain reference under `reference/`, and prints
one JSON line. Configurations (`configs/`), traffic mixes (`traffic/`),
per-layer metrics (`metrics/`) and references (`reference/`) are found by
the names in `BENCHMARK.json`; `harness/` holds what is shared.
"""
