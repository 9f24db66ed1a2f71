"""Seeded random weights, made on the device in a few large calls.

The state dict is keyed as the reference checkpoint is, so the same
tensors load into the port (`load_state_dict`) and into the plain
reference. The draws follow the port's `init_weights` rule (the flax
default the JAX package starts from): convolution and linear kernels
LeCun-normal (normal / sqrt(fan in)), their biases zero, normalisation
layers at identity (weight 1, bias 0, running mean 0, variance 1). All
kernels come from one `torch.randn` of their total size, drawn from a
generator on the device seeded with the run's seed.
"""

from __future__ import annotations

import torch
from torch import nn


def seeded_state_dict(skeleton: nn.Module, seed: int, device,
                      dtype: torch.dtype = torch.float32) -> dict:
    """Weights for every entry of `skeleton.state_dict()` (a module built
    on the meta device gives the shapes)."""
    kernels, fixed = [], {}
    for prefix, mod in skeleton.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            kernels.append((p + "weight", mod.weight.shape))
            if mod.bias is not None:
                fixed[p + "bias"] = (mod.bias.shape, 0.0)
        elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
            fixed[p + "weight"] = (mod.weight.shape, 1.0)
            fixed[p + "bias"] = (mod.bias.shape, 0.0)
            if isinstance(mod, nn.BatchNorm2d):
                fixed[p + "running_mean"] = (mod.running_mean.shape, 0.0)
                fixed[p + "running_var"] = (mod.running_var.shape, 1.0)
    keys = set(skeleton.state_dict())
    drawn = {k for k, _ in kernels} | set(fixed)
    counters = {k for k in keys - drawn if k.endswith("num_batches_tracked")}
    if keys - drawn - counters:
        raise ValueError(f"no rule for {sorted(keys - drawn - counters)[:8]}")
    g = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(s.numel() for _, s in kernels)
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, at = {}, 0
    for k, shape in kernels:
        n = shape.numel()
        out[k] = flat[at:at + n].view(shape) / (n // shape[0]) ** 0.5
        at += n
    for k, (shape, value) in fixed.items():
        out[k] = torch.full(shape, value, device=device, dtype=dtype)
    for k in counters:
        out[k] = torch.zeros((), dtype=torch.long, device=device)
    return {k: out[k] for k in skeleton.state_dict()}
