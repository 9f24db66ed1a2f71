"""LightGlue's attention on the masked flash kernel (`ops/kernels/flash.
flash_sdpa_masked`), without a card.

On the CPU the wrapper takes its plain version (`sdpa` with the mask
q_valid & k_valid); the CUDA kernel itself is held against that plain
version on the card by chip_smoke.py (phases 7, 14 and 15). Here:

- the wrapper's CPU path against `ops.attention.sdpa` with LightGlue's
  masks (exactly: it is that function) and against a float64 softmax over
  the valid keys, rows of invalid queries or with no valid key exactly 0;
- the kernel's arithmetic emulated in numpy float32 (key tiles of 32 or
  48, invalid keys at -1e30, the online softmax in the log2 domain, zero
  rows) against the same float64 softmax, at the 2e-4 of K3's float32
  kernel (tests/test_torch_flash.py);
- the argument checks the wrapper makes on every device;
- LightGlue's gate: under autograd on the CPU it takes the plain products
  and launches nothing; the kernel path's plumbing (4 launches a layer,
  the cross attention's two directions with the masks swapped) agrees
  with the plain products when forced on the CPU.
"""

import numpy as np
import pytest
import torch

from benchmark.harness import registry
from benchmark.harness.program import TARGET
from benchmark.harness.trace import Traced
from gim_tpu_torch.config import LightGlueConfig
from gim_tpu_torch.models import lightglue as tlg
from gim_tpu_torch.ops.attention import sdpa
from gim_tpu_torch.ops.kernels import flash as K
from gim_tpu_torch.ops.kernels import forward_only

TOL = 2e-4
NEG = np.float32(-1e30)
LOG2E = 1.4426950408889634

# (name, B, H, Nq, Nk, D): the masks each case draws are in _masks
CASES = [
    ("all_valid", 2, 2, 96, 96, 64),
    ("invalid_keys", 2, 2, 100, 100, 64),
    ("invalid_queries", 2, 3, 90, 90, 64),
    ("no_valid_key", 2, 2, 80, 80, 64),
    ("nq_ne_nk", 2, 2, 70, 150, 64),
    ("d128", 1, 2, 75, 110, 128),
    ("leading_invalid_tiles", 2, 2, 64, 130, 64),
    ("one_valid_key", 2, 2, 40, 100, 64),
    ("one_query", 1, 1, 1, 33, 64),
]


def _masks(name, B, Nq, Nk, rng):
    qv = np.ones((B, Nq), bool)
    kv = np.ones((B, Nk), bool)
    if name in ("invalid_keys", "nq_ne_nk", "d128"):
        kv &= rng.random((B, Nk)) > 0.2
        kv[0, -7:] = False                  # a padded tail
    if name == "invalid_queries":
        qv[0, 50:] = False
        qv[1, ::3] = False
    if name == "no_valid_key":
        kv[1] = False
        qv[0, 60:] = False
    if name == "leading_invalid_tiles":     # whole tiles before any key
        kv[:, :70] = False
        kv[1, 100:] = False
    if name == "one_valid_key":
        kv[:] = False
        kv[0, 77] = kv[1, 3] = True
    return qv, kv


def _case(name, B, H, Nq, Nk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Nq, D)).astype(np.float32) * 2.0
    k = rng.standard_normal((B, H, Nk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Nk, D)).astype(np.float32)
    qv, kv = _masks(name, B, Nq, Nk, rng)
    return q, k, v, qv, kv, D ** -0.5


def _reference(q, k, v, qv, kv, scale):
    """float64 softmax over the valid keys; 0 where the query is invalid
    or no key is valid."""
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    s = np.where(kv[:, None, None, :], s, -np.inf)
    keep = qv[:, None, :] & kv.any(-1)[:, None, None]
    m = np.where(keep[..., None], s.max(-1, keepdims=True), 0.0)
    p = np.where(kv[:, None, None, :], np.exp(s - m), 0.0)
    out = (p @ v.astype(np.float64)) / np.where(
        keep, p.sum(-1), 1.0)[..., None]
    return np.where(keep[..., None], out, 0.0)


def _emulate(q, k, v, qv, kv, scale, bk):
    """The masked kernel's arithmetic (csrc/flash.cu, MASK), in float32 with
    exact products: tiles of bk keys, invalid keys and keys past Nk at
    -1e30, m in the log2 domain, rows with an invalid query or no valid key
    written as 0."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    n = -(-Nk // bk)
    pad = n * bk - Nk
    bits = np.pad(kv, ((0, 0), (0, pad)))
    kp = np.pad(k, ((0, 0), (0, 0), (0, pad), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, 0), (0, pad), (0, 0)))
    s_all = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                      kp.astype(np.float64)).astype(np.float32)
    sl2 = np.float32(scale * LOG2E)
    m = np.full((B, H, Nq), NEG, np.float32)
    l = np.zeros((B, H, Nq), np.float32)
    acc = np.zeros((B, H, Nq, D), np.float32)
    any_key = np.zeros(B, bool)
    for j in range(n):
        keys = slice(j * bk, (j + 1) * bk)
        ok = bits[:, keys]
        any_key |= ok.any(-1)
        s = np.where(ok[:, None, None], s_all[..., keys], NEG)
        m_new = np.maximum(m, s.max(-1) * sl2)
        alpha = np.exp2(m - m_new)
        p = np.exp2(s * sl2 - m_new[..., None]).astype(np.float32)
        l = l * alpha + p.sum(-1, dtype=np.float32)
        pv = np.einsum("bhqk,bhkd->bhqd", p.astype(np.float64),
                       vp[:, :, keys].astype(np.float64))
        acc = acc * alpha[..., None] + pv.astype(np.float32)
        m = m_new
    keep = qv[:, None, :] & any_key[:, None, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        out = acc / l[..., None]
    return np.where(keep[..., None], out, np.float32(0.0))


def _zero_rows(qv, kv, shape):
    """(B, H, Nq): rows whose query is invalid or with no valid key."""
    return np.broadcast_to(~(qv[:, None, :] & kv.any(-1)[:, None, None]),
                           shape[:3])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_wrapper_on_the_cpu_is_masked_sdpa(case):
    q, k, v, qv, kv, scale = _case(*case)
    t = [torch.from_numpy(a) for a in (q, k, v, qv, kv)]
    got = K.flash_sdpa_masked(*t)
    mask = t[3][:, None, :, None] & t[4][:, None, None, :]
    np.testing.assert_array_equal(got.numpy(), sdpa(*t[:3], mask).numpy())
    want = _reference(q, k, v, qv, kv, scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    zero = _zero_rows(qv, kv, got.shape)
    assert (got.numpy()[zero] == 0.0).all()
    if case[0] == "no_valid_key":
        assert zero[1].all() and zero[0, :, 60:].all()
    if case[0] == "one_valid_key":          # the softmax of one key is 1
        np.testing.assert_allclose(got.numpy()[0], v[0, :, 77:78].repeat(
            q.shape[2], 1), rtol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_arithmetic_matches_the_softmax(case):
    q, k, v, qv, kv, scale = _case(*case, seed=1)
    bk = 32 if q.shape[-1] == 64 else 48
    got = _emulate(q, k, v, qv, kv, scale, bk)
    want = _reference(q, k, v, qv, kv, scale)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got[_zero_rows(qv, kv, got.shape)] == 0.0).all()


def _ok_args():
    q, k, v, qv, kv, _ = _case("invalid_keys", 2, 2, 40, 56, 64)
    return [torch.from_numpy(a) for a in (q, k, v, qv, kv)]


def _wrong_mask_shape(a):
    a[3] = a[3][:, :-1]


def _wrong_mask_dtype(a):
    a[4] = a[4].to(torch.uint8)


def _strided_mask(a):
    a[4] = torch.ones(2, 112, dtype=torch.bool)[:, ::2]


def _head_dim_32(a):
    a[:3] = [t[..., :32].contiguous() for t in a[:3]]


def _non_unit_d_stride(a):
    a[2] = torch.cat([a[2], a[2]], -1)[..., ::2]


def _float64(a):
    a[:3] = [t.double() for t in a[:3]]


def _kv_shapes_differ(a):
    a[2] = a[2][:, :, :-1]


@pytest.mark.parametrize("make,exc,match", [
    (_wrong_mask_shape, ValueError, "q_valid must be a contiguous"),
    (_wrong_mask_dtype, TypeError, "k_valid must be bool"),
    (_strided_mask, ValueError, "k_valid must be a contiguous"),
    (_head_dim_32, ValueError, "head dim 32"),
    (_non_unit_d_stride, ValueError, "unit stride along D"),
    (_float64, TypeError, "float32"),
    (_kv_shapes_differ, ValueError, "k and v must be"),
])
def test_wrapper_refuses(make, exc, match):
    args = _ok_args()
    K.flash_sdpa_masked(*args)                 # the unbroken call runs
    make(args)
    with pytest.raises(exc, match=match):
        K.flash_sdpa_masked(*args)


def _lightglue_inputs(seed=5, K_=48, B=2):
    g = torch.Generator().manual_seed(seed)
    size = torch.tensor([[128.0, 96.0]] * B)
    kpts = [torch.rand((B, K_, 2), generator=g) * size[:, None] + 0.5
            for _ in range(2)]
    desc = [torch.nn.functional.normalize(torch.randn((B, K_, 256),
                                                      generator=g), dim=-1)
            for _ in range(2)]
    valid0 = torch.ones((B, K_), dtype=torch.bool)
    valid1 = torch.ones((B, K_), dtype=torch.bool)
    valid0[1, 30:] = False
    valid1[0, 20:] = False
    return (*kpts, *desc, size, size, valid0, valid1)


def _lightglue():
    torch.manual_seed(0)
    return tlg.LightGlue(LightGlueConfig(filter_threshold=0.0)).eval()


def test_training_on_the_cpu_takes_the_plain_products(monkeypatch):
    model = _lightglue()
    args = _lightglue_inputs()
    with torch.no_grad():
        want = model(*args)

    def refuse(*a, **kw):
        raise AssertionError("the kernel path under autograd")

    monkeypatch.setattr(tlg, "flash_sdpa_masked", refuse)
    before = dict(K.LAUNCHES)
    with torch.enable_grad():
        assert not forward_only.on_kernel(args[2])
        got = model(*args)
    assert K.LAUNCHES == before
    assert got["log_assignment"].requires_grad
    np.testing.assert_array_equal(got["log_assignment"].detach().numpy(),
                                  want["log_assignment"].numpy())


def test_kernel_path_agrees_with_the_plain_products(monkeypatch):
    """The kernel path forced on the CPU (the wrapper's plain version in the
    kernel's place): 4 calls a layer, 36 a call, each with the operands
    the kernel takes, and the outputs of the plain products."""
    model = _lightglue()
    args = _lightglue_inputs()
    with torch.no_grad():
        want = model(*args)
    calls = []

    def counted(q, k, v, q_valid, k_valid):
        K.masked_args(q, k, v, q_valid, k_valid)    # what the card takes
        calls.append((tuple(q.shape), tuple(k.shape)))
        return K.flash_sdpa_masked(q, k, v, q_valid, k_valid)

    monkeypatch.setattr(forward_only, "on_kernel", lambda x: True)
    monkeypatch.setattr(tlg, "flash_sdpa_masked", counted)
    with torch.no_grad():
        got = model(*args)
    assert len(calls) == 4 * model.cfg.n_layers == 36
    for k in ("log_assignment", "matching_scores0", "matching_scores1",
              "desc0", "desc1"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5)
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    assert (got["matches0"] >= 0).sum() > 0


def test_attention_ms_reads_the_kernel_span():
    """`lightglue.attention_ms` reads the wrapper's span, device ms a pair,
    and nothing from a port that has no such span (the parent's)."""
    metric = registry.metric("lightglue.attention_ms")
    assert metric.SPANS == {"gim.lightglue.attention": TARGET}
    t = Traced(window_s=6.0, busy_s=5.0, pairs=4,
               span_device_s={"gim.lightglue.attention": 0.012,
                              "lightglue.glue": 0.08},
               span_shapes={})
    assert metric.read(t) == pytest.approx(3.0)
    t.span_device_s = {"lightglue.glue": 0.08}
    assert metric.read(t) is None
