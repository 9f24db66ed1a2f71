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

import contextlib
import contextvars
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gim_tpu_torch.parallel import mesh

# set while `recomputed` re-runs a forward in backward: the running
# statistics have moved once already, in the forward
_RECOMPUTING = contextvars.ContextVar("gim_tpu_torch_recomputing",
                                      default=False)


@contextlib.contextmanager
def _recomputing():
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def recomputed(fn, *args):
    """fn(*args) with its activations recomputed in backward, flax's
    `nn.remat`: `torch.utils.checkpoint` without reentrance. The
    recomputation runs with the running-statistics update of
    `batchnorm_train` off, so the statistics move once a step, in the
    forward, as remat writes `batch_stats` once."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recomputing()))


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


def batchnorm(mod: nn.BatchNorm2d, x: torch.Tensor, dt: torch.dtype,
              train: bool = False) -> torch.Tensor:
    """flax BatchNorm(use_running_average=not train, dtype=dt) on NCHW:
    float32 statistics and affine parameters, output in dt. With `train`,
    the batch's statistics (`batchnorm_train`)."""
    if train:
        return batchnorm_train(mod, x, dt)
    stats = (mod.running_mean, mod.running_var, mod.weight, mod.bias)
    wide = torch.promote_types(dt, mod.weight.dtype)
    if wide != mod.weight.dtype:        # float64 compute, float32 storage
        stats = tuple(t.to(wide) for t in stats)
    return F.batch_norm(x.to(dt), *stats, False, 0.0, mod.eps)


def batchnorm_train(mod: nn.BatchNorm2d, x: torch.Tensor, dt: torch.dtype
                    ) -> torch.Tensor:
    """flax BatchNorm(use_running_average=False, momentum=0.9) on NCHW, the
    JAX package's every BatchNorm.

    The statistics are float32 (or the input's wider type) over N*H*W per
    channel with flax's fast
    variance, var = max(E[x^2] - E[x]^2, 0). The running statistics move
    by `r <- 0.9 r + 0.1 batch`, with the *biased* batch variance, as flax
    does; `F.batch_norm(training=True)` and `nn.SyncBatchNorm` update with
    the unbiased one, so neither is used.

    Inside the recomputation of `recomputed` the running statistics stay.

    Under a process group (`parallel.mesh.in_group`), each channel's sums
    of x and x^2 and the count are all-reduced through
    `torch.distributed.nn.functional.all_reduce`, whose backward sums the
    gradients too: the statistics, and their gradient, are those of the
    global batch (the JAX loop's BatchNorm under jit sharding).
    """
    # at least float32, as flax promotes (a float64 input stays float64)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    n = torch.tensor(float(xf.numel() // xf.shape[1]), dtype=xf.dtype,
                     device=x.device)
    s1 = xf.sum((0, 2, 3))
    s2 = xf.square().sum((0, 2, 3))
    if mesh.in_group():
        from torch.distributed.nn.functional import all_reduce

        s = all_reduce(torch.cat([s1, s2, n[None]]))
        s1, s2, n = s[:s1.shape[0]], s[s1.shape[0]:-1], s[-1]
    mean = s1 / n
    var = (s2 / n - mean.square()).clamp_min(0.0)
    if not _RECOMPUTING.get():
        _update_running_stats(mod, mean, var)
    mul = torch.rsqrt(var + mod.eps) * mod.weight.to(xf.dtype)
    y = (xf - mean[:, None, None]) * mul[:, None, None] \
        + mod.bias.to(xf.dtype)[:, None, None]
    return y.to(dt)


@torch.no_grad()
def _update_running_stats(mod: nn.BatchNorm2d, mean: torch.Tensor,
                          var: torch.Tensor):
    mod.running_mean.mul_(0.9).add_(0.1 * mean.to(mod.running_mean.dtype))
    mod.running_var.mul_(0.9).add_(0.1 * var.to(mod.running_var.dtype))


def layernorm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm(dtype=float32): computed and returned in float32."""
    return F.layer_norm(x.float(), mod.normalized_shape, mod.weight,
                        mod.bias, mod.eps)
