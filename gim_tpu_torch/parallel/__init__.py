"""Data-parallel training across processes (`torch.distributed`)."""
