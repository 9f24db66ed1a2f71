"""The kernels' wrappers are forward only, on the CPU as on the card.

K1 (`dual_softmax_mutual`), K2 (`fused_dw_block`) and K3 (`flash_sdpa`)
run through `ops/kernels/forward_only.py`: with inputs that require a
gradient, the forward equals the same call under `torch.no_grad` exactly
and the plain version (K2, K3: exactly, since on the CPU the wrapper runs
it inside an autograd node; K1: indices and mutual flags exactly and conf
within rtol 1e-4, atol 1e-7, tests/test_torch_dsmax.py's tolerance, since
K1's CPU path runs the plain sweeps, not the dense recipe), and a backward
through the result raises `KernelBackwardError` naming the kernel, as
`jax.grad` through the JAX package's Pallas kernels raises. Under
`torch.no_grad` the results carry no autograd node at all.
"""

import numpy as np
import pytest
import torch

from gim_tpu_torch.ops.kernels import dsmax, flash, refiner
from gim_tpu_torch.ops.kernels.forward_only import KernelBackwardError


def _inputs(name, rng):
    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    if name == "dual_softmax_mutual":
        return (t(2, 40, 32, scale=0.3), t(2, 56, 32, scale=0.3)), (0.1,)
    if name == "refiner_block":
        return (t(2, 12, 9, 11), t(12, 25, scale=0.2), t(12),
                t(16, 12, scale=0.3), t(16)), ()
    return (t(2, 3, 17, 64), t(2, 3, 17, 64), t(2, 3, 17, 64)), ()


WRAPPERS = {
    "dual_softmax_mutual": (dsmax.dual_softmax_mutual,
                            dsmax.dual_softmax_mutual_plain),
    "refiner_block": (refiner.fused_dw_block, refiner.fused_dw_block_plain),
    "flash_attention": (flash.flash_sdpa, flash.flash_sdpa_plain),
}


def _float_out(out):
    """The wrapper's differentiable output: K1's conf, else the tensor."""
    return out[1] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_kernel_forward_equals_plain_and_backward_raises(name):
    kernel, plain = WRAPPERS[name]
    tensors, rest = _inputs(name, np.random.default_rng(len(name)))
    leaves = [x.clone().requires_grad_() for x in tensors]
    got = kernel(*leaves, *rest)
    with torch.no_grad():
        same = kernel(*tensors, *rest)
        want = plain(*tensors, *rest)
    tup = (lambda x: x if isinstance(x, tuple) else (x,))
    for g, s, w in zip(tup(got), tup(same), tup(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.detach(), s)
        if name == "dual_softmax_mutual" and g.is_floating_point():
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-7)
        else:
            assert torch.equal(g.detach(), w)
    out = _float_out(got)
    assert out.requires_grad
    with pytest.raises(KernelBackwardError, match=name):
        out.sum().backward()
    assert all(x.grad is None for x in leaves)

    with torch.no_grad():
        assert _float_out(kernel(*leaves, *rest)).grad_fn is None
