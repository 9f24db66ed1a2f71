"""Kernel K2 (fused ConvRefiner block) of gim_tpu_torch against gim_tpu.

On the CPU the wrapper `fused_dw_block` takes its plain version (grouped
conv with the folded taps, ReLU, 1x1 conv); the CUDA kernel itself is
held against that plain version on the card by chip_smoke.py. Here both
are held against the JAX package's Pallas kernel, run in interpret mode
as tests/test_pallas_kernels.py runs it, and against the flax block's
op sequence (dw conv, BatchNorm running statistics, ReLU, 1x1), on the
five shapes of that file (ragged H, W not a multiple of 128, C_out != C)
and an odd width.

Tolerance: rtol = atol = 1e-4 in float32, the JAX package's own for this
kernel (tests/test_pallas_kernels.py:117-119): the 25 taps and the 1x1
contraction are summed in another order by XLA and by PyTorch's CPU
convolutions. `fold_block_params` is held to 1e-6: the same float32
arithmetic on the same values, up to rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.ops.pallas_kernels import refiner as jref
from gim_tpu_torch.ops.kernels import refiner as tref

SHAPES = [
    ((2, 24, 37, 256), 24, 16),      # scale-1-like: narrow C, odd H
    ((1, 40, 16, 128), 56, 8),       # C_out != C_in, H == block
    ((1, 8, 5, 384), 8, 16),         # H smaller than block
    ((1, 16, 12, 200), 16, 16),      # W not a 128-multiple
    ((1, 8, 24, 1344), 8, 12),       # RoMa-like W
    ((1, 40, 37, 203), 56, 8),       # odd W: rows not 16-byte aligned
]
TOL = 1e-4


def _params(rng, C, C_out, K=5):
    """Random flax block parameters (BN statistics away from identity)."""
    f32 = np.float32
    return {
        "conv1": {"kernel": (0.2 * rng.standard_normal((K, K, 1, C))
                             ).astype(f32),
                  "bias": (0.1 * rng.standard_normal(C)).astype(f32)},
        "bn": {"scale": (1.0 + 0.1 * rng.standard_normal(C)).astype(f32),
               "bias": (0.1 * rng.standard_normal(C)).astype(f32)},
        "bn_stats": {"mean": (0.1 * rng.standard_normal(C)).astype(f32),
                     "var": (1.0 + 0.2 * rng.random(C)).astype(f32)},
        "conv2": {"kernel": (0.2 * rng.standard_normal((1, 1, C, C_out))
                             ).astype(f32),
                  "bias": (0.1 * rng.standard_normal(C_out)).astype(f32)},
    }


def _torch_block(p):
    """The same parameters in torch modules (reference layout)."""
    K, _, _, C = p["conv1"]["kernel"].shape
    C_out = p["conv2"]["kernel"].shape[-1]
    conv1 = torch.nn.Conv2d(C, C, K, padding=K // 2, groups=C)
    bn = torch.nn.BatchNorm2d(C).eval()
    conv2 = torch.nn.Conv2d(C, C_out, 1)
    with torch.no_grad():
        conv1.weight.copy_(torch.from_numpy(
            np.transpose(p["conv1"]["kernel"], (3, 2, 0, 1))))
        conv1.bias.copy_(torch.from_numpy(p["conv1"]["bias"]))
        bn.weight.copy_(torch.from_numpy(p["bn"]["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bn"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(p["bn_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(p["bn_stats"]["var"]))
        conv2.weight.copy_(torch.from_numpy(
            np.transpose(p["conv2"]["kernel"], (3, 2, 0, 1))))
        conv2.bias.copy_(torch.from_numpy(p["conv2"]["bias"]))
    return conv1, bn, conv2


def _flax_block(x_nhwc, p, eps=1e-5):
    """ConvRefiner.block's op sequence in NHWC lax ops."""
    kd = p["conv1"]["kernel"]
    y = jax.lax.conv_general_dilated(
        x_nhwc, kd, (1, 1), "SAME", feature_group_count=kd.shape[-1],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    y = y + p["conv1"]["bias"]
    s = p["bn"]["scale"] / np.sqrt(p["bn_stats"]["var"] + eps)
    y = (y - p["bn_stats"]["mean"]) * s + p["bn"]["bias"]
    y = jnp.maximum(y, 0.0)
    y = jnp.einsum("bhwc,cd->bhwd", y, p["conv2"]["kernel"][0, 0],
                   precision=jax.lax.Precision.HIGHEST)
    return y + p["conv2"]["bias"]


_CASES: dict = {}


def _case(i):
    """Inputs, folded parameters and the JAX kernel's output for SHAPES[i],
    computed once per module."""
    if i not in _CASES:
        shape, C_out, bh = SHAPES[i]
        rng = np.random.default_rng(3 + i)
        x = rng.standard_normal(shape).astype(np.float32)
        p = _params(rng, shape[1], C_out)
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        folded = jref.fold_block_params(jp["conv1"], jp["bn"],
                                        jp["bn_stats"], jp["conv2"])
        want = np.asarray(jref.fused_dw_block(jnp.asarray(x), *folded,
                                              block_h=bh))
        _CASES[i] = x, p, want
    return _CASES[i]


def _port_inputs(p):
    return [t.detach() for t in tref.fold_block_params(*_torch_block(p))]


@pytest.mark.parametrize("i", range(len(SHAPES)))
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_block_matches_jax_kernel(i, fn):
    """The plain version, and the wrapper's CPU path, against the Pallas
    kernel in interpret mode."""
    x, p, want = _case(i)
    f = tref.fused_dw_block_plain if fn == "plain" else tref.fused_dw_block
    got = f(torch.from_numpy(x), *_port_inputs(p))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("i", [0, 1, 3])
def test_block_matches_flax_block(i):
    x, p, _ = _case(i)
    want = np.asarray(_flax_block(jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                                  jax.tree_util.tree_map(jnp.asarray, p)))
    got = tref.fused_dw_block(torch.from_numpy(x), *_port_inputs(p))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("C,C_out", [(24, 24), (40, 56), (144, 144)])
def test_fold_block_params_matches_jax(C, C_out):
    p = _params(np.random.default_rng(C), C, C_out)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    want = jref.fold_block_params(jp["conv1"], jp["bn"], jp["bn_stats"],
                                  jp["conv2"])
    got = _port_inputs(p)
    for g, w, name in zip(got, want, ("wdw", "bdw", "w1", "b1")):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_bf16_plain_keeps_dtype_and_casts_h():
    """bf16 in, bf16 out, h cast to w1's dtype before the 1x1 (as the TPU
    kernel does); close to the float32 result at bf16 precision."""
    x, p, want = _case(0)
    folded = _port_inputs(p)
    got = tref.fused_dw_block_plain(torch.from_numpy(x).bfloat16(),
                                    *(t.bfloat16() for t in folded))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05,
                               atol=0.05)


def test_wrapper_rejects_other_devices():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    another device is refused before any launch."""
    x = torch.zeros(1, 8, 4, 4, device="meta")
    w = [torch.zeros(s, device="meta") for s in ((8, 25), (8,), (8, 8), (8,))]
    with pytest.raises(ValueError, match="CUDA"):
        tref.fused_dw_block(x, *w)
