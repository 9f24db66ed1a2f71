"""ZEB evaluation (port of `gim_tpu/eval/`)."""
