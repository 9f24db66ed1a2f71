"""Kernel K2 (fused ConvRefiner block) of gim_tpu_torch against gim_tpu.

On the CPU the wrapper `fused_dw_block` takes its plain version (grouped
conv with the folded taps, ReLU, 1x1 conv); the CUDA kernel itself is
held against that plain version on the card by chip_smoke.py. Here both
are held against the JAX package's Pallas kernel, run in interpret mode
as tests/test_pallas_kernels.py runs it, and against the flax block's
op sequence (dw conv, BatchNorm running statistics, ReLU, 1x1), on the
five shapes of that file (ragged H, W not a multiple of 128, C_out != C)
and an odd width.

The float32 kernel runs its 1x1 on the tensor cores as 3xTF32. Its
arithmetic is emulated here in numpy (`matmul_3xtf32`: the operands split
into TF32 hi and lo parts by the kernel's rounding, three products added
to a float32 accumulator) and held to a tenth of the tolerance against
float64, where a single TF32 product exceeds the tolerance.

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


# -- the float32 kernel's 3xTF32 arithmetic ----------------------------------


def tf32_rna(x):
    """float32 to TF32 (10 mantissa bits), rounded to nearest with ties
    away from zero, as the kernels compute it (`csrc/hopper.cuh`
    tf32_rna: half an ulp added to the bits, then the low 13 bits
    cleared); returned as float32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x):
    """hi = tf32(x), lo = tf32(x - hi); x - hi is exact in float32."""
    hi = tf32_rna(x)
    return hi, tf32_rna(np.asarray(x, np.float32) - hi)


def matmul_3xtf32(a, b):
    """a (M, K) @ b (K, N) as the kernels compute it: both operands split,
    and for each k the products lo.hi, hi.lo, hi.hi (exact in float32: 11
    significant bits each) added in that order to a float32 accumulator.
    The tensor core's own summation order within a k-step of 8 is not
    modelled."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc += np.outer(al[:, k], bh[k])
        acc += np.outer(ah[:, k], bl[k])
        acc += np.outer(ah[:, k], bh[k])
    return acc


def matmul_1xtf32(a, b):
    """The same with one TF32 product (what TF32 on would give)."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc += np.outer(ah[:, k], bh[k])
    return acc


def _tf32_reference(x):
    """Round to 11 significant bits, ties away from zero, in float64."""
    x = np.asarray(x, np.float64)
    m, e = np.frexp(x)                       # x = m 2^e, |m| in [0.5, 1)
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.ldexp(r, e - 11)


def test_tf32_rounding_is_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-6, 6, 20000)
         ).astype(np.float32)
    # exact ties: the 13 dropped bits are 1 followed by zeros
    ties = ((x.view(np.uint32) & np.uint32(0xFFFFE000))
            | np.uint32(0x1000)).view(np.float32)
    for v in (x, ties, np.float32([0.0, -0.0, 1.0, -1.0, 3e-38])):
        np.testing.assert_array_equal(tf32_rna(v).astype(np.float64),
                                      _tf32_reference(v))
    hi, lo = split_tf32(x)
    assert (np.abs(lo) <= np.abs(x) * 2.0 ** -11).all()
    assert (np.abs(hi.astype(np.float64) + lo - x) <= np.abs(x) * 2.0 ** -22
            ).all()


@pytest.mark.parametrize("C", [24, 144, 192])
def test_1x1_in_3xtf32_keeps_float32_accuracy(C):
    """K2's 1x1 at the refiners' widths (C = C_out), h = relu(N(0, 1)),
    w1 ~ N(0, 1/C), 2048 pixels: 3xTF32 within TOL / 10 of float64; one
    TF32 product is over TOL."""
    rng = np.random.default_rng(C)
    h = np.maximum(rng.standard_normal((2048, C)), 0.0).astype(np.float32)
    w = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)
    want = h.astype(np.float64) @ w.astype(np.float64)
    err3 = float(np.abs(matmul_3xtf32(h, w) - want).max())
    err1 = float(np.abs(matmul_1xtf32(h, w) - want).max())
    assert err3 <= TOL / 10, err3
    assert err1 > TOL, err1


# -- variants of the kernels (ops/kernels/f32_probe.py) ----------------------


@pytest.mark.parametrize("name", ["refiner", "flash"])
@pytest.mark.parametrize("variant", ["copy", "edited", "flags"])
def test_library_path_of_a_variant(name, variant, tmp_path):
    """A variant built from another source directory or with extra nvcc
    flags (as f32_probe.py builds them) has its own library path, apart
    from this checkout's build; an unedited copy of the sources shares
    it."""
    from gim_tpu_torch.ops.kernels import build

    for f in build._inputs(name):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    flags = ()
    if variant == "edited":
        with open(tmp_path / f"{name}.cu", "a") as f:
            f.write("\n// edited\n")
    elif variant == "flags":
        flags = ("-DF32_PROBE_NO_EXP",)
    assert build._inputs(name, tmp_path)[0] == tmp_path / f"{name}.cu"
    same = build.library_path(name, tmp_path, flags) == \
        build.library_path(name)
    assert same == (variant == "copy")


@pytest.mark.parametrize("argv,want", [
    ([], {"kernel": ("gim_tpu_torch/csrc", ())}),
    (["parent=build/parent/gim_tpu_torch/csrc", "no_compute"],
     {"parent": ("build/parent/gim_tpu_torch/csrc", ()),
      "no_compute": (None, ("-DF32_PROBE_NO_1X1",
                            "-DF32_PROBE_NO_DEPTHWISE"))}),
    (["no_softmax_exp"], {"no_softmax_exp": (None,
                                             ("-DF32_PROBE_NO_EXP",))}),
])
def test_probe_variants(argv, want):
    """f32_probe's arguments: NAME=DIR (a directory from the root of the
    checkout) or an ablation (this checkout's sources with its macros);
    anything else exits."""
    from gim_tpu_torch.ops.kernels import f32_probe

    got = f32_probe.variants(argv)
    assert list(got) == list(want)
    for name, (d, flags) in want.items():
        assert got[name][1] == flags
        assert got[name][0] == (None if d is None else f32_probe.ROOT / d)
    with pytest.raises(SystemExit):
        f32_probe.variants(["no_such_ablation"])


def test_probe_ablation_macros_are_in_the_sources():
    """Each ablation's macro guards code in the source it names, so a
    variant build differs from the kernel it ablates."""
    from gim_tpu_torch.ops.kernels import build, f32_probe

    text = {n: (build.CSRC / f"{n}.cu").read_text()
            for n in ("refiner", "flash")}
    for flags in f32_probe.ABLATIONS.values():
        for flag in flags:
            macro = flag.removeprefix("-D")
            assert any(f"#ifndef {macro}\n" in t for t in text.values()), \
                macro


@pytest.mark.parametrize("entry,at", [("refiner_block", 7),
                                      ("flash_attention", 5)])
def test_probe_calls_older_libraries_without_scratch(entry, at):
    """Sources from before the float32 kernels took a scratch buffer are
    called with the wrappers' arguments less the scratch pointer, and ask
    for no scratch."""
    from types import SimpleNamespace

    from gim_tpu_torch.ops.kernels import f32_probe

    seen = []
    lib = SimpleNamespace(**{entry: lambda *a: seen.append(a) or 0})
    old = f32_probe._NoScratch(lib, entry)
    kind = entry.split("_")[0]
    assert getattr(old, f"{kind}_scratch_bytes")(1, 2, 3) == 0
    args = tuple(range(13))
    assert getattr(old, entry)(*args) == 0
    assert seen == [args[:at] + args[at + 1:]]
