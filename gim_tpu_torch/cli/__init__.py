"""Command-line entry points of the port (`python -m gim_tpu_torch.cli.<name>`)."""
