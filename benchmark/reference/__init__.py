"""Plain references, one module per configuration of `BENCHMARK.json`,
named after it. Nothing here imports the port."""
