"""Data loaders and the synthetic benchmark writer (port of `gim_tpu/data/`)."""
