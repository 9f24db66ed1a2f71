"""The kernels' autograd boundary: a forward and no backward, and the one
rule that decides where a kernel runs.

The JAX package's Pallas kernels (`pl.pallas_call`) define no derivative
rule, so `jax.grad` through one of them raises. The port's wrappers match
that: each runs its kernel (or, for CPU tensors, its plain version)
through `forward_only`, an autograd Function whose backward raises and
names the kernel. Without it a launch through `ctypes`, which writes into
a buffer autograd does not see, would give every tensor upstream a zero
gradient on the card, while the same call on the CPU, through the plain
version, would differentiate.

`on_kernel` is the rule for K2 (`models/dkm/blocks.ConvRefiner`), K3
(`models/dinov2.Attention`) and K3's masked variant
(`models/lightglue.SelfBlock`, `CrossBlock`): a kernel runs on a CUDA
tensor inside `torch.inference_mode()`, and the module's plain graph runs
everywhere else. Every inference entry point enters inference mode
(`api.match_fn`, `hloc/pipeline`); a training step never does, and plain
`no_grad` (gim_roma's frozen DINOv2 in training) is not inference mode,
so training stays on the plain graph, as does the CPU, where the tests
hold it against the JAX package. The call sites look the rule up through
this module at call time, so one swap of `on_kernel` turns all three.
"""

from __future__ import annotations

import torch


def on_kernel(x: torch.Tensor) -> bool:
    """Whether the work on `x` runs as a kernel: a CUDA tensor of a dtype
    the kernels take (float64 stays on the plain graph), inside
    inference mode (module docstring)."""
    return (x.device.type == "cuda"
            and x.dtype in (torch.bfloat16, torch.float32)
            and torch.is_inference_mode_enabled())


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
