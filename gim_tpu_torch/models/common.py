"""Pieces shared by the port's models: seeded weights and layers run at a
compute dtype.

The JAX package keeps every parameter in float32 and gives each flax layer
a `dtype` it computes in: a Dense or Conv casts its input and its kernel
to that dtype, a BatchNorm normalises in float32 and returns the dtype, a
LayerNorm built with dtype=float32 returns float32. The helpers below do
the same with the parameters of plain `nn` modules, which stay float32:
the cast is a no-op on the float32 path.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn on the CPU from `generator` so a seed
    gives the same model on every device: LeCun-normal kernels (the flax
    default the JAX package initialises with), zero biases, identity
    normalisation layers and running statistics. Other parameters (ViT
    tokens, layer scales) keep the values their modules are built with."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator)
                    / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
            mod.reset_parameters()
    return model


def _cast(t: torch.Tensor | None, dt: torch.dtype):
    return None if t is None else t.to(dt)


def dense(mod: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=dt): input and kernel cast to dt."""
    return F.linear(x.to(dt), mod.weight.to(dt), _cast(mod.bias, dt))


def conv(mod: nn.Conv2d, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax Conv(dtype=dt) on NCHW: input and kernel cast to dt."""
    return F.conv2d(x.to(dt), mod.weight.to(dt), _cast(mod.bias, dt),
                    mod.stride, mod.padding, mod.dilation, mod.groups)


def batchnorm(mod: nn.BatchNorm2d, x: torch.Tensor,
              dt: torch.dtype) -> torch.Tensor:
    """flax BatchNorm(use_running_average=True, dtype=dt) on NCHW: float32
    statistics and affine parameters, output in dt."""
    return F.batch_norm(x.to(dt), mod.running_mean, mod.running_var,
                        mod.weight, mod.bias, False, 0.0, mod.eps)


def layernorm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm(dtype=float32): computed and returned in float32."""
    return F.layer_norm(x.float(), mod.normalized_shape, mod.weight,
                        mod.bias, mod.eps)
