"""Kernel K3 (flash attention) of gim_tpu_torch against gim_tpu.

On the CPU the wrapper `flash_sdpa` takes its plain version (the einsum +
softmax of `ops.attention.sdpa`); the CUDA kernel itself is held against
that plain version on the card by chip_smoke.py. Here the port's `sdpa`,
its plain version and the wrapper's CPU path are held against the JAX
package's `sdpa` and its Pallas `flash_sdpa` (interpret mode), on the
shapes of tests/test_pallas_kernels.py:123-156 and at D = 128 (the RoMa
coordinate decoder's head dim).

The argument builder `kernel_args` (what the CUDA kernel is handed: shape
and strides of the strided q, k, v views) is pure Python and tested here
without a card, in bf16 (TMA's rule) and float32 (16-byte loads).

The float32 kernel runs both products as 3xTF32; that arithmetic is
emulated in numpy (`tests/test_torch_refiner.matmul_3xtf32`) at the
model's N = 2305 and held to a tenth of the tolerance against float64.

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
from tests.test_torch_refiner import matmul_3xtf32

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


def _qkv_views(t, H):
    """q, k, v as `dinov2.Attention` hands them to the kernel: the
    (B, H, N, D) views of a (B, N, 3 H D) qkv projection."""
    B, N, C3 = t.shape
    D = C3 // (3 * H)
    return t.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("B,H,N,D", [(2, 3, 150, 64), (1, 2, 77, 128)])
def test_strided_views_match_jax(B, H, N, D):
    """The wrapper's CPU path on the strided qkv views (row stride 3 H D,
    head stride D), against JAX's flash_sdpa and sdpa on the same values,
    with N not a multiple of any block."""
    qkv = np.random.default_rng(15).standard_normal(
        (B, N, 3 * H * D)).astype(np.float32)
    q, k, v = _qkv_views(torch.from_numpy(qkv), H)
    assert q.stride() == (N * 3 * H * D, D, 3 * H * D, 1)
    got = K.flash_sdpa(q, k, v).numpy()
    jq, jk, jv = (jnp.asarray(t.contiguous().numpy()) for t in (q, k, v))
    want_flash = np.asarray(j_flash(jq, jk, jv, block_q=64, block_k=64))
    want_sdpa = np.asarray(j_sdpa(jq, jk, jv))
    assert got.shape == (B, H, N, D)
    np.testing.assert_allclose(got, want_flash, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_sdpa, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,N,H,D", [(2, 2305, 16, 64), (2, 2304, 8, 128)])
def test_kernel_args_take_the_model_views(B, N, H, D):
    """The argument builder accepts the DINOv2 ViT-L and coordinate-decoder
    views as they are (no copy) and hands the kernel their strides."""
    t = torch.empty(B, N, 3 * H * D, dtype=torch.bfloat16)
    q, k, v = _qkv_views(t, H)
    shape, strides = K.kernel_args(q, k, v)
    assert shape == (B, H, N, D)
    row = 3 * H * D
    assert strides == [N * row, D, row] * 3
    assert [q.data_ptr(), k.data_ptr(), v.data_ptr()] == [
        t.data_ptr() + i * H * D * 2 for i in range(3)]


def test_kernel_args_take_contiguous():
    """Contiguous (B, H, N, D) tensors pass as they are."""
    q = torch.zeros(1, 3, 157, 64)
    shape, strides = K.kernel_args(q, q, q)
    assert shape == (1, 3, 157, 64)
    assert strides == [3 * 157 * 64, 157 * 64, 64] * 3


def _non_unit_inner(t):
    return t[..., ::2]                       # D = 64 at stride 2


def _misaligned_base(t):
    flat = t.reshape(-1)
    return flat[1:1 + t.numel() // 2].view(1, 2, 64, 64)


def _misaligned_rows(t):
    return t.reshape(-1)[:2 * 64 * 68].view(1, 2, 64, 68)[..., :64]


@pytest.mark.parametrize("make,match", [
    (_non_unit_inner, "unit stride"),
    (_misaligned_base, "aligned"),
    (_misaligned_rows, "multiples of 16"),
])
def test_kernel_args_reject(make, match):
    """What TMA cannot read is refused, not copied."""
    base = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)
    q = make(base)
    assert q.shape[-1] == 64
    with pytest.raises(ValueError, match=match):
        K.kernel_args(q, q, q)


def _f32_rows(pitch):
    """float32 (1, 2, 64, 64) views whose rows are `pitch` floats apart."""
    return torch.zeros(2 * 64 * pitch).view(1, 2, 64, pitch)[..., :64]


@pytest.mark.parametrize("make,match", [
    (lambda: _f32_rows(68), None),           # 272-byte rows: taken
    (lambda: _f32_rows(66), "multiples of 16"),
    (lambda: torch.zeros(4 + 2 * 64 * 64)[4:].view(1, 2, 64, 64), None),
    (lambda: torch.zeros(1 + 2 * 64 * 64)[1:].view(1, 2, 64, 64),
     "aligned"),
    (lambda: torch.zeros(1, 2, 64, 128)[..., ::2], "unit stride"),
    (lambda: torch.zeros(1, 2, 64, 96)[..., :64], None),   # 384-byte rows
])
def test_kernel_args_float32(make, match):
    """The float32 kernel reads rows with 16-byte loads: bases and
    strides must be multiples of 16 bytes (4 floats), as in bf16."""
    q = make()
    assert q.dtype == torch.float32 and q.shape[-1] == 64
    if match is None:
        shape, strides = K.kernel_args(q, q, q)
        assert shape == tuple(q.shape)
        assert strides == list(q.stride()[:3]) * 3
    else:
        with pytest.raises(ValueError, match=match):
            K.kernel_args(q, q, q)


@pytest.mark.parametrize("B,N,H,D", [(2, 2305, 16, 64), (2, 2304, 8, 128)])
def test_kernel_args_take_the_model_views_in_float32(B, N, H, D):
    t = torch.empty(B, N, 3 * H * D)
    q, k, v = _qkv_views(t, H)
    shape, strides = K.kernel_args(q, k, v)
    row = 3 * H * D
    assert shape == (B, H, N, D) and strides == [N * row, D, row] * 3


@pytest.mark.parametrize("D", [64, 128])
def test_products_in_3xtf32_keep_float32_accuracy(D):
    """K3's two products at gim_roma's N = 2305 (64 query rows against all
    keys): S = q k^T / sqrt(D) and P V with P a softmax row, each within
    TOL / 10 of float64."""
    N, rows = 2305, 64
    rng = np.random.default_rng(D)
    q = rng.standard_normal((rows, D)).astype(np.float32)
    k, v = (rng.standard_normal((N, D)).astype(np.float32) for _ in range(2))
    scale = D ** -0.5
    s64 = (q.astype(np.float64) @ k.T.astype(np.float64)) * scale
    s = matmul_3xtf32(q, k.T) * np.float32(scale)
    assert float(np.abs(s - s64).max()) <= TOL / 10
    p = np.exp(s64 - s64.max(1, keepdims=True))
    p = (p / p.sum(1, keepdims=True)).astype(np.float32)
    o64 = p.astype(np.float64) @ v.astype(np.float64)
    assert float(np.abs(matmul_3xtf32(p, v) - o64).max()) <= TOL / 10


def test_wrapper_rejects_other_devices():
    q = torch.zeros(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_sdpa(q, q, q)
