"""gim_dkm's modules in gim_tpu_torch against gim_tpu on the CPU, float32:
the ResNet-50 pyramid, RRB, CAB, the DFN, GP with and without
`bug_compat`, the DKM ConvRefiner and the decoder. The whole slice is in
tests/test_torch_dkm_matcher.py.

Both packages run on the same weights: seeded numpy values (BatchNorm
parameters and statistics away from identity) go into the port's tiny
DKMMatcher (the JAX package's own test configuration, tests/test_dkm.py:
222: 48 x 64, upsample 96 x 128, at full width), and the JAX variables
come from its state dict through the JAX package's `port_dkm`. The JAX
side runs the small blocks eagerly and the conv stacks under `jax.jit`,
as the JAX package's Matcher runs its graph (`gim_tpu/api.py:139`):
eagerly, each of their hundreds of distinct operations would be compiled
on its own, which takes several times as long as one compile of the
whole.

Tolerances, all float32 (the port sums in another order than XLA; TF32
plays no part on the CPU), as tests/test_torch_roma.py states them:
- blocks of order-1 values (RRB, CAB, the GP posterior relative to its
  largest value): 1e-5;
- conv stacks (the pyramid, the DFN, the ConvRefiner, the decoder): 1e-4
  of the largest magnitude of the reference output.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.config import DKMConfig as JDKMConfig
from gim_tpu.models.dkm import blocks as jb
from gim_tpu.models.dkm import model as jm
from gim_tpu.models.dkm.encoder import ResNet50Pyramid as JPyramid
from gim_tpu.weights import port as jport
from gim_tpu_torch.config import DKMConfig
from gim_tpu_torch.models.dkm import blocks as tb
from gim_tpu_torch.models.dkm import model as tm
from gim_tpu_torch.models.dkm.encoder import ResNet50Pyramid
from gim_tpu_torch.ops.kernels import forward_only
from gim_tpu_torch.weights import port as tport
from tests.test_torch_roma import HIGH, _randomize, _to_jax_tree

TINY = dict(h_resized=48, w_resized=64, upsample_res=(96, 128),
            num_samples=64)


@pytest.fixture(scope="module")
def variables():
    """The JAX package's variables of the tiny DKMMatcher, from seeded
    values through its own port_dkm."""
    return jport.port_dkm(_randomize(tm.DKMMatcher(DKMConfig(**TINY)), 0))


def _port_model(variables) -> tm.DKMMatcher:
    model = tm.DKMMatcher(DKMConfig(**TINY))
    model.load_state_dict(tport.dkm_state_dict_from_jax(variables),
                          strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def port(variables):
    """The port's DKMMatcher on those weights (tests do not change it)."""
    return _port_model(variables)


def _sub(variables, *path):
    """The {"params", "batch_stats"} subtree at `path`, as jnp arrays."""
    out = {}
    for col in ("params", "batch_stats"):
        node = variables.get(col, {})
        for p in path:
            node = node.get(p, {})
        if node:
            out[col] = _to_jax_tree(node)
    return out


def jit_apply(module, variables, *args, **static):
    """module.apply(variables, *args, **static) compiled by jax.jit, at
    full float32 matmul precision; `static` holds the Python arguments."""
    with HIGH:
        return jax.jit(functools.partial(module.apply, **static))(
            variables, *args)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(660, 880), (1152, 1536), (45, 61)])
def test_pyramid_sizes_match_jax(variables, hw):
    """Odd sizes on the way down (165 -> 83, 55 -> 28): the stride-2 1x1
    down_conv (flax SAME) and the 3x3 convs give the same sizes in both;
    shapes only (jax.eval_shape, torch's meta device)."""
    enc = _sub(variables, "encoder")
    want = jax.eval_shape(lambda x: JPyramid().apply(enc, x),
                          jax.ShapeDtypeStruct((1, *hw, 3), jnp.float32))
    with torch.device("meta"):
        got = ResNet50Pyramid()(torch.empty(1, 3, *hw))
    assert sorted(got) == sorted(want) == [1, 2, 4, 8, 16, 32]
    for s in want:
        B, H, W, C = want[s].shape
        assert tuple(got[s].shape) == (B, C, H, W), s
    if hw == (660, 880):
        assert [tuple(got[s].shape[-2:]) for s in (2, 4, 8, 16, 32)] == [
            (330, 440), (165, 220), (83, 110), (42, 55), (21, 28)]


def test_pyramid_matches_jax(variables, port):
    x = np.random.default_rng(1).random((2, 45, 61, 3)).astype(np.float32)
    want = jit_apply(JPyramid(), _sub(variables, "encoder"), jnp.asarray(x))
    with torch.no_grad():
        got = port.encoder(_nchw(x))
    for s, w in want.items():
        _close(got[s].permute(0, 2, 3, 1), w, 1e-4)


# ---------------------------------------------------------------------------
# DFN pieces
# ---------------------------------------------------------------------------

def test_rrb_matches_jax(variables, port):
    x = np.random.default_rng(2).standard_normal((2, 5, 6, 512)).astype(
        np.float32)
    v = _sub(variables, "decoder", "dfn_16", "rrb_d")
    with HIGH:
        want = jb.RRB(384).apply(v, jnp.asarray(x))
    rrb = port.decoder.embedding_decoder.rrb_d["16"]
    with torch.no_grad():
        got = rrb(_nchw(x)).permute(0, 2, 3, 1)
    _close(got, want, 1e-5)


def test_cab_matches_jax(variables, port):
    rng = np.random.default_rng(3)
    x1, x2 = (rng.standard_normal((2, 5, 6, 384)).astype(np.float32)
              for _ in range(2))
    v = _sub(variables, "decoder", "dfn_32", "cab")
    with HIGH:
        want = jb.CAB(384).apply(v, jnp.asarray(x1), jnp.asarray(x2))
    cab = port.decoder.embedding_decoder.cab["32"]
    with torch.no_grad():
        got = cab(_nchw(x1), _nchw(x2)).permute(0, 2, 3, 1)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("scale", ["32", "16"])
def test_dfn_scale_matches_jax(variables, port, scale):
    """DFNScale: feats 1x1 -> [feats; GP posterior] -> RRB -> CAB with the
    context -> RRB -> certainty (channel 0) and flow (channels 1-2)."""
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((2, 3, 4, 256)).astype(np.float32)
    feats = rng.standard_normal((2, 3, 4, 512)).astype(np.float32)
    ctx = rng.standard_normal((2, 3, 4, 384)).astype(np.float32)
    v = _sub(variables, "decoder", f"dfn_{scale}")
    with HIGH:
        want = jb.DFNScale(256, 384).apply(v, jnp.asarray(emb),
                                           jnp.asarray(feats),
                                           jnp.asarray(ctx))
    dfn = port.decoder.embedding_decoder
    with torch.no_grad():
        coord, cert, context = dfn(scale, torch.from_numpy(emb),
                                   _nchw(feats), _nchw(ctx))
    assert coord.dtype == cert.dtype == torch.float32
    for g, w in ((coord, want[0]), (cert, want[1]),
                 (context.permute(0, 2, 3, 1), want[2])):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("bug_compat", [False, True])
def test_gp_bug_compat_matches_jax(variables, port, bug_compat):
    """n = 20 with bug_compat_min_n lowered to 10 on both sides: with the
    switch on, row 0's solve serves both rows (and row 1 then differs from
    its own solve); off, each row has its own. The features share a
    component, so the kernel matrices are far from the identity and the
    two rows' solutions differ."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((1, 4, 5, 512))
    x, y = ((base + 0.7 * rng.standard_normal((2, 4, 5, 512))).astype(
        np.float32) for _ in range(2))
    v = _sub(variables, "decoder", "gp_16")
    with HIGH:
        want = np.asarray(jb.GP(256, bug_compat=bug_compat,
                                bug_compat_min_n=10).apply(
            v, jnp.asarray(x), jnp.asarray(y)))
        plain = np.asarray(jb.GP(256).apply(v, jnp.asarray(x),
                                            jnp.asarray(y)))
    gp = tb.GP(256, bug_compat=bug_compat, bug_compat_min_n=10)
    gp.load_state_dict(port.decoder.gps["16"].state_dict())
    with torch.no_grad():
        got = gp(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    _close(got, want, 1e-5)
    tol = 1e-5 * np.abs(plain).max()
    np.testing.assert_allclose(want[0], plain[0], rtol=0, atol=tol)
    if bug_compat:
        assert np.abs(want[1] - plain[1]).max() > 100 * tol
    else:
        np.testing.assert_allclose(want[1], plain[1], rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# ConvRefiner
# ---------------------------------------------------------------------------

def test_grouped_block1_weight_order_matches_flax():
    """Scale 1's block1 is a grouped 5x5 conv 12 -> 24 (two outputs per
    group): the OIHW kernel that the weight port makes of flax's HWIO one
    computes the same convolution."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 9, 11, 12)).astype(np.float32)
    k = rng.standard_normal((5, 5, 1, 24)).astype(np.float32)
    conv = fnn.Conv(24, (5, 5), padding="SAME", feature_group_count=12)
    with HIGH:
        want = conv.apply({"params": {"kernel": jnp.asarray(k),
                                      "bias": jnp.zeros(24)}},
                          jnp.asarray(x))
    blk = tb._block(12, 24)
    u = tport._FromJax({"params": {"c": {"kernel": k, "bias": np.zeros(24)}}})
    u.conv("c", "w")
    with torch.no_grad():
        blk[0].weight.copy_(u.sd["w.weight"])
        blk[0].bias.zero_()
        got = blk[0](_nchw(x)).permute(0, 2, 3, 1)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("scale,fused", [("1", False), ("1", True),
                                         ("2", False), ("2", True),
                                         ("4", False), ("16", False)])
def test_conv_refiner_matches_jax(variables, port, monkeypatch, scale,
                                  fused):
    """DKM's variant ([cert, dx, dy], emb_scale 1) on random features and a
    flow that leaves the image; scales 4 and 16 with local correlation.
    With `fused`, the port's kernel rule is forced on, so the hidden
    blocks of scales 1 and 2 take K2 (its plain version on the CPU), and
    JAX runs its Pallas kernel (GIM_TPU_FUSED_REFINER=force, interpret
    mode)."""
    monkeypatch.setattr(forward_only, "on_kernel", lambda x: fused)
    monkeypatch.setenv("GIM_TPU_FUSED_REFINER", "force" if fused else "0")
    in_dim, hid, emb, rad = tm.REFINER_SPECS[scale]
    # the sizes of the tiny model's coarse pass, which the decoder test
    # runs too (the eager JAX ops compile once); at scale 16 the 15 x 15
    # correlation window is larger than the map
    C, H, W = {"1": (3, 48, 64), "2": (64, 24, 32), "4": (256, 12, 16),
               "16": (512, 3, 4)}[scale]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    y = rng.standard_normal((2, H, W, C)).astype(np.float32)
    flow = (np.asarray(jb.coords_grid(2, H, W))
            + rng.uniform(-0.3, 0.3, (2, H, W, 2))).astype(np.float32)
    v = _sub(variables, "decoder", f"refiner_{scale}")
    want = jit_apply(jb.ConvRefiner(in_dim, hid, displacement_emb_dim=emb,
                                    local_corr_radius=rad),
                     v, jnp.asarray(x), jnp.asarray(y), jnp.asarray(flow))
    ref = port.decoder.conv_refiner[scale]
    assert ref.fuses_hidden_blocks(_nchw(x)) == (fused and hid <= 192)
    with torch.no_grad():
        got = ref(_nchw(x), _nchw(y), torch.from_numpy(flow))
    assert got[0].shape == (2, H, W, 1) and got[1].shape == (2, H, W, 2)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _pyramid(rng, B, H, W):
    """Random NHWC features of the DKM pyramid at an (H, W) input."""
    chans = {1: 3, 2: 64, 4: 256, 8: 512, 16: 1024, 32: 2048}
    out = {}
    for s, c in chans.items():
        h, w = H, W
        for _ in range(s.bit_length() - 1):
            h, w = -(-h // 2), -(-w // 2)
        out[s] = rng.standard_normal((B, h, w, c)).astype(np.float32)
    return out


@pytest.mark.parametrize("upsample", [False, True])
def test_dkm_decoder_matches_jax(variables, port, upsample):
    """Coarse pass (GP and DFN at 1/32 and 1/16, then five refiners) and
    upsample pass (four refiners from a given flow and certainty): flow
    and certainty at every scale."""
    rng = np.random.default_rng(8)
    f1 = _pyramid(rng, 2, 48, 64)
    f2 = _pyramid(rng, 2, 48, 64)
    kw = {}
    if upsample:
        kw = dict(dense_flow=rng.uniform(-1, 1, (2, 48, 64, 2)).astype(
            np.float32), dense_certainty=rng.standard_normal(
            (2, 48, 64, 1)).astype(np.float32))
    want = jit_apply(jm.DKMDecoder(JDKMConfig(**TINY)),
                     _sub(variables, "decoder"),
                     {k: jnp.asarray(a) for k, a in f1.items()},
                     {k: jnp.asarray(a) for k, a in f2.items()},
                     upsample=upsample,
                     **{k: jnp.asarray(a) for k, a in kw.items()})
    dec = port.decoder
    with torch.no_grad():
        got = dec({k: _nchw(a) for k, a in f1.items()},
                  {k: _nchw(a) for k, a in f2.items()}, upsample,
                  *(torch.from_numpy(a) for a in kw.values()))
    assert sorted(got) == sorted(want)
    for s in want:
        _close(got[s]["flow"], want[s]["dense_flow"], 1e-4)
        _close(got[s]["certainty"], want[s]["dense_certainty"], 1e-4)


def test_warp_to_pixels_matches_jax():
    m = np.random.default_rng(9).uniform(-1, 1, (50, 4)).astype(np.float32)
    want = jm.warp_to_pixels(jnp.asarray(m), 660, 880)
    got = tm.warp_to_pixels(torch.from_numpy(m), 660, 880)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
