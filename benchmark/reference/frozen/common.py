"""Layers run at a compute dtype: frozen copy of the port's
`models/common.py` (inference only).

Every parameter stays in its stored dtype; a Dense or Conv casts its input
and its kernel to the compute dtype, a BatchNorm normalises with its
running statistics and returns the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _cast(t: torch.Tensor | None, dt: torch.dtype):
    return None if t is None else t.to(dt)


def dense(mod: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=dt): input and kernel cast to dt."""
    return F.linear(x.to(dt), mod.weight.to(dt), _cast(mod.bias, dt))


def conv(mod: nn.Conv2d, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax Conv(dtype=dt) on NCHW: input and kernel cast to dt."""
    return F.conv2d(x.to(dt), mod.weight.to(dt), _cast(mod.bias, dt),
                    mod.stride, mod.padding, mod.dilation, mod.groups)


def batchnorm(mod: nn.BatchNorm2d, x: torch.Tensor, dt: torch.dtype,
              train: bool = False) -> torch.Tensor:
    """flax BatchNorm(use_running_average=not train, dtype=dt) on NCHW:
    float32 statistics and affine parameters, output in dt. With `train`,
    the batch's statistics (`batchnorm_train`)."""
    if train:
        raise NotImplementedError("the reference runs inference only")
    stats = (mod.running_mean, mod.running_var, mod.weight, mod.bias)
    wide = torch.promote_types(dt, mod.weight.dtype)
    if wide != mod.weight.dtype:        # float64 compute, float32 storage
        stats = tuple(t.to(wide) for t in stats)
    return F.batch_norm(x.to(dt), *stats, False, 0.0, mod.eps)


def layernorm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm(dtype=float32): computed and returned in float32."""
    return F.layer_norm(x.float(), mod.normalized_shape, mod.weight,
                        mod.bias, mod.eps)
