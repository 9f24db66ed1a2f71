"""Kernel K3 (flash attention) of gim_tpu_torch against gim_tpu.

On the CPU the wrapper `flash_sdpa` takes its plain version (the einsum +
softmax of `ops.attention.sdpa`); the CUDA kernel itself is held against
that plain version on the card by chip_smoke.py. Here the port's `sdpa`,
its plain version and the wrapper's CPU path are held against the JAX
package's `sdpa` and its Pallas `flash_sdpa` (interpret mode), on the
shapes of tests/test_pallas_kernels.py:123-156 and at D = 128 (the RoMa
coordinate decoder's head dim).

Tolerances are the JAX package's own for this kernel: float32 rtol = atol
= 2e-4 (sums in another order, online against two-pass softmax); bf16
rtol 0.05, atol 0.02 against the float32 reference (bf16 scores and
probabilities, 8-bit mantissa).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.ops.attention import sdpa as j_sdpa
from gim_tpu.ops.pallas_kernels.flash import flash_sdpa as j_flash
from gim_tpu_torch.ops.attention import sdpa
from gim_tpu_torch.ops.kernels import flash as K

SHAPES = [
    ((2, 3, 80, 16), 32, 32),     # N not a block multiple (pad + mask)
    ((1, 2, 64, 32), 64, 32),     # bq != bk
    ((1, 1, 128, 64), 64, 64),    # ViT head dim
    ((1, 2, 150, 128), 64, 64),   # decoder head dim, ragged N
]
TOL = 2e-4


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,bq,bk", SHAPES)
@pytest.mark.parametrize("fn", ["sdpa", "plain", "wrapper"])
def test_matches_jax_flash_and_sdpa(shape, bq, bk, fn):
    q, k, v = _qkv(shape, 11)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    want_flash = np.asarray(j_flash(jq, jk, jv, block_q=bq, block_k=bk))
    want_sdpa = np.asarray(j_sdpa(jq, jk, jv))
    f = {"sdpa": sdpa, "plain": K.flash_sdpa_plain,
         "wrapper": K.flash_sdpa}[fn]
    got = f(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, want_flash, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_sdpa, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("D", [16, 128])
def test_bf16_matches_f32_reference(D):
    """bf16 in, bf16 out, as tests/test_pallas_kernels.py's bf16 case."""
    q, k, v = _qkv((1, 4, 70, D), 12)
    want = np.asarray(j_sdpa(*(jnp.asarray(t) for t in (q, k, v))))
    got = K.flash_sdpa(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05,
                               atol=0.02)


def test_masked_sdpa_matches_jax():
    """The port's sdpa with a key mask (the LightGlue contract), fully
    masked rows giving zeros as in the JAX package."""
    q, k, v = _qkv((2, 2, 12, 8), 13)
    mask = np.random.default_rng(14).random((2, 1, 12, 12)) > 0.3
    mask[0, 0, 3] = False
    want = np.asarray(j_sdpa(*(jnp.asarray(t) for t in (q, k, v)),
                             mask=jnp.asarray(mask)))
    got = sdpa(*(torch.from_numpy(t) for t in (q, k, v)),
               mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_wrapper_rejects_other_devices():
    q = torch.zeros(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_sdpa(q, q, q)
