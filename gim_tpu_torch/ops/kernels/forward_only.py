"""The kernels' autograd boundary: a forward and no backward.

The JAX package's Pallas kernels (`pl.pallas_call`) define no derivative
rule, so `jax.grad` through one of them raises. The port's wrappers match
that: each runs its kernel (or, for CPU tensors, its plain version)
through `forward_only`, an autograd Function whose backward raises and
names the kernel. Without it a launch through `ctypes`, which writes into
a buffer autograd does not see, would give every tensor upstream a zero
gradient on the card, while the same call on the CPU, through the plain
version, would differentiate.
"""

from __future__ import annotations

import torch


class KernelBackwardError(RuntimeError):
    """A backward reached a kernel that has none."""


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name: str, fn, *args):
        ctx.kernel = name
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise KernelBackwardError(
            f"kernel {ctx.kernel} has no backward: it is forward only, as "
            "its JAX counterpart (a Pallas kernel, which defines no "
            "derivative) is")


def forward_only(name: str, fn, *args):
    """fn(*args), as one autograd node whose backward raises
    `KernelBackwardError` naming the kernel `name`. The forward runs as
    fn does (autograd does not record inside it)."""
    return _ForwardOnly.apply(name, fn, *args)
