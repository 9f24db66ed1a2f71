"""gim_roma's modules in gim_tpu_torch against gim_tpu on the CPU, float32.

The weights are those of tests/test_torch_roma.py (seeded numpy values
through the JAX package's `port_roma` / `port_dinov2`, loaded by the port
through `roma_state_dict_from_jax`), and so are the tolerances, stated
there. This file holds the weight port and the pieces of the decoder and
the trunk one by one; tests/test_torch_roma.py holds the whole slice,
whose JAX graph is slow to build here and runs beside this file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.models.dinov2 import DinoViT as JDinoViT
from gim_tpu.models.dkm import blocks as jb
from gim_tpu.models.dkm.model import sample_matches as j_sample_matches
from gim_tpu.models.roma import model as jr
from gim_tpu.weights import port as jport
from gim_tpu_torch.api import Matcher
from gim_tpu_torch.config import GimConfig, RoMaConfig
from gim_tpu_torch.models.dinov2 import DinoViT
from gim_tpu_torch.models.dkm import blocks as tb
from gim_tpu_torch.models.dkm.model import sample_matches
from gim_tpu_torch.models.roma import RoMaMatcher, cls_to_flow_refine
from gim_tpu_torch.ops.kernels import forward_only
from gim_tpu_torch.ops.resize import nearest_indices, bicubic_matrix
from gim_tpu_torch.weights import port as tport
from tests.test_torch_roma import (HIGH, TINY, _flat, _port_model,
                                   _randomize, _to_jax_tree,
                                   variables)  # noqa: F401  (fixture)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_state_dict_round_trip(variables):
    """port_roma + port_dinov2 of the port's state dict give back the JAX
    tree exactly, with no key left over (both assert that)."""
    sd = {k: v.numpy() for k, v in _port_model(variables).state_dict().items()}
    roma_sd, dino_sd = tport.split_roma_state_dict(sd)
    back = jport.port_roma(roma_sd, None, n_decoder_blocks=1)
    back["params"]["dino"] = jport.port_dinov2(dino_sd, depth=1)["params"]
    a, b = _flat(variables), _flat(back)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), a[k], err_msg=k)


def test_full_size_state_dict_maps_every_key():
    """The full model's state dict (ViT-L depth 24, 5 decoder blocks)
    through port_roma(sd, dino_sd) leaves no key unmapped; shapes only."""
    with torch.device("meta"):
        model = RoMaMatcher(RoMaConfig())
    sd = {k: np.zeros(v.shape, np.float32)
          for k, v in model.state_dict().items()}
    roma_sd, dino_sd = tport.split_roma_state_dict(sd)
    v = jport.port_roma({f"model.{k}": a for k, a in roma_sd.items()},
                        dino_sd)
    blocks = [k for k in v["params"]["dino"] if k.startswith("block_")]
    assert len(blocks) == 24


def test_state_dict_from_jax_rejects_leftover_leaves(variables):
    extra = dict(variables)
    extra["params"] = dict(variables["params"],
                           stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray/kernel"):
        tport.roma_state_dict_from_jax(extra)


def test_matcher_from_checkpoint(tmp_path, variables):
    """A reference-layout gim_roma checkpoint ('model.' prefixes) and the
    DINOv2 hub file beside it load through from_checkpoint; without the
    hub file every other weight still loads."""
    cfg = GimConfig(roma=RoMaConfig(**TINY))
    src = _port_model(variables).state_dict()
    roma_sd, dino_sd = tport.split_roma_state_dict(src)
    ckpt = tmp_path / "gim_roma_100h.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in roma_sd.items()}},
               ckpt)
    m = Matcher.from_checkpoint("gim_roma", str(ckpt), cfg, device="cpu")
    got = m.model.state_dict()
    assert any(k.startswith("dinov2.") for k in got)
    for k, v in roma_sd.items():
        assert torch.equal(got[k], v), k
    torch.save(dict(dino_sd, mask_token=torch.zeros(1, 1024)),
               tmp_path / "dinov2_vitl14_pretrain.pth")
    m = Matcher.from_checkpoint("gim_roma", str(ckpt), cfg, device="cpu")
    got = m.model.state_dict()
    for k, v in src.items():
        assert torch.equal(got[k], v), k


# ---------------------------------------------------------------------------
# resizes and sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n0,hp,wp", [(37, 48, 48), (2, 4, 3), (6, 4, 9)])
def test_bicubic_resize_matches_jax(n0, hp, wp):
    """The DINOv2 position grid resize: JAX's Keys a = -0.5 kernel with
    renormalised borders (and antialiasing when it shrinks)."""
    x = np.random.default_rng(n0).standard_normal((1, n0, n0, 5)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, hp, wp, 5),
                                       method="bicubic"))
    got = torch.einsum("ih,jw,hwc->ijc", bicubic_matrix(n0, hp),
                       bicubic_matrix(n0, wp), torch.from_numpy(x[0]))
    np.testing.assert_allclose(got.numpy(), want[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(56, 112), (64, 48), (672, 1344),
                                        (45, 112)])
def test_nearest_indices_match_jax(n_in, n_out):
    src = jnp.arange(n_in, dtype=jnp.float32)[None]
    want = np.asarray(jax.image.resize(src, (1, n_out), "nearest"))[0]
    np.testing.assert_array_equal(nearest_indices(n_in, n_out).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("h,w", [(24, 40), (9, 7)])
def test_resize_nhwc_matches_jax(h, w):
    x = np.random.default_rng(h).random((2, 16, 20, 3)).astype(np.float32)
    want = np.asarray(jb.resize_nhwc(jnp.asarray(x), h, w))
    got = tb.resize_nhwc(torch.from_numpy(x), h, w).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resize_region_and_sample_match_jax():
    rng = np.random.default_rng(5)
    x = rng.random((2, 30, 40, 3)).astype(np.float32)
    ext = np.array([[0.75, 1.0], [1.0, 0.6]], np.float32)
    want = np.asarray(jb.resize_region_nhwc(jnp.asarray(x), 28, 28,
                                            jnp.asarray(ext)))
    got = tb.resize_region_nhwc(torch.from_numpy(x), 28, 28,
                                torch.from_numpy(ext)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    coords = rng.uniform(-1.2, 1.2, (2, 7, 9, 2)).astype(np.float32)
    for mode in ("zeros", "border"):
        want = np.asarray(jb.sample_nhwc(jnp.asarray(x), jnp.asarray(coords),
                                         padding_mode=mode))
        got = tb.sample_nhwc(torch.from_numpy(x), torch.from_numpy(coords),
                             padding_mode=mode).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# decoder pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius,with_flow", [(2, True), (3, False),
                                              (7, True)])
def test_local_correlation_matches_jax(radius, with_flow):
    """Against the JAX package's default (packed-row) form; the flow
    reaches past the border, so out-of-bounds windows are exercised."""
    rng = np.random.default_rng(radius)
    x = rng.standard_normal((2, 12, 14, 16)).astype(np.float32)
    y = rng.standard_normal((2, 12, 14, 16)).astype(np.float32)
    flow = None
    if with_flow:
        flow = rng.uniform(-1.1, 1.1, (2, 12, 14, 2)).astype(np.float32)
    with HIGH:
        want = np.asarray(jb.local_correlation(
            jnp.asarray(x), jnp.asarray(y), radius,
            flow=None if flow is None else jnp.asarray(flow)))
    got = tb.local_correlation(torch.from_numpy(x).permute(0, 3, 1, 2),
                               torch.from_numpy(y).permute(0, 3, 1, 2),
                               radius, None if flow is None
                               else torch.from_numpy(flow))
    assert got.shape == (2, (2 * radius + 1) ** 2, 12, 14)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


def test_gp_matches_jax(variables):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 5, 512)).astype(np.float32)
    y = rng.standard_normal((2, 4, 5, 512)).astype(np.float32)
    gp_params = variables["params"]["decoder"]["gp_16"]
    with HIGH:
        want = np.asarray(jb.GP(512).apply(
            {"params": _to_jax_tree(gp_params)}, jnp.asarray(x),
            jnp.asarray(y)))
    gp = _port_model(variables).decoder.gps["16"]
    with torch.no_grad():
        got = gp(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_kde_density_matches_jax():
    x = np.random.default_rng(7).uniform(-1, 1, (300, 4)).astype(np.float32)
    want = np.asarray(jb.kde_density(jnp.asarray(x), std=0.1, chunk=128))
    got = tb.kde_density(torch.from_numpy(x), std=0.1, chunk=128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_cls_to_flow_refine_with_planted_ties_matches_jax():
    """Ties take the first anchor in both; the neighbours of the grid's
    first and last anchors are clipped to it."""
    rng = np.random.default_rng(8)
    res = 8
    logits = rng.standard_normal((2, 3, 4, res * res)).astype(np.float32)
    logits[0, 0, 0, [5, 40]] = 9.0                  # tie: anchor 5 wins
    logits[0, 0, 1, [0, 63]] = 9.0                  # tie at both ends
    logits[0, 1, 0, 63] = 12.0                      # last anchor
    logits[1, 2, 3, 0] = 12.0                       # first anchor
    want = np.asarray(jr.cls_to_flow_refine(jnp.asarray(logits)))
    got = cls_to_flow_refine(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("scale,fused", [("1", False), ("1", True),
                                         ("2", False), ("2", True),
                                         ("4", False), ("16", False)])
def test_conv_refiner_matches_jax(variables, monkeypatch, scale, fused):
    """One refiner of the tiny model on random features and a flow that
    leaves the image; with `fused` the port's kernel rule is forced on,
    so the hidden blocks of the narrow scales take K2 (its plain version
    on the CPU), and JAX runs its Pallas kernel
    (GIM_TPU_FUSED_REFINER=force, interpret mode)."""
    monkeypatch.setattr(forward_only, "on_kernel", lambda x: fused)
    monkeypatch.setenv("GIM_TPU_FUSED_REFINER", "force" if fused else "0")
    C = jr.PROJ_SPECS[scale][1]
    H, W = (20, 24) if scale in ("1", "2") else (8, 10)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    y = rng.standard_normal((2, H, W, C)).astype(np.float32)
    flow = (np.asarray(jb.coords_grid(2, H, W))
            + rng.uniform(-0.3, 0.3, (2, H, W, 2))).astype(np.float32)
    in_dim, hid, emb, rad = jr.ROMA_REFINER_SPECS[scale]
    dec = variables["params"]["decoder"]
    jvars = {"params": _to_jax_tree(dec[f"refiner_{scale}"]),
             "batch_stats": _to_jax_tree(
                 variables["batch_stats"]["decoder"][f"refiner_{scale}"])}
    with HIGH:
        want_c, want_d = jb.ConvRefiner(
            in_dim, hid, displacement_emb_dim=emb, local_corr_radius=rad,
            disp_first=True).apply(jvars, jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(flow), emb_scale=1.25)
    ref = _port_model(variables).decoder.conv_refiner[scale]
    assert ref.fuses_hidden_blocks(torch.from_numpy(x)) == (
        fused and hid <= 192)
    with torch.no_grad():
        got_c, got_d = ref(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(y).permute(0, 3, 1, 2),
                           torch.from_numpy(flow), emb_scale=1.25)
    for g, w in ((got_c, want_c), (got_d, want_d)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("hw,flash", [((56, 42), False), ((56, 42), True),
                                      ((28, 28), False)])
def test_dinovit_matches_jax(monkeypatch, hw, flash):
    """A narrow DINOv2 (64 wide, 4 heads, 2 blocks, pretrained grid 2 x 2):
    56 x 42 resizes the position grid to 4 x 3, 28 x 28 keeps it. With
    `flash` the port's kernel rule is forced on (K3's plain version on the
    CPU) and JAX runs its flash kernel (GIM_TPU_FLASH_VIT=1)."""
    monkeypatch.setattr(forward_only, "on_kernel", lambda x: flash)
    monkeypatch.setenv("GIM_TPU_FLASH_VIT", "1" if flash else "0")
    kw = dict(embed_dim=64, depth=2, num_heads=4, patch_size=14,
              pretrain_img_size=28)
    model = DinoViT(**kw).eval()
    sd = _randomize(model, 10)
    params = jport.port_dinov2(sd, depth=2)
    x = np.random.default_rng(11).random((2, 3, *hw)).astype(np.float32)
    with HIGH:
        want = np.asarray(JDinoViT(**kw).apply(_to_jax_tree(params),
                                               jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["threshold_balanced", "threshold"])
def test_sample_matches_with_jax_noise_is_identical(mode):
    rng = np.random.default_rng(12)
    warp = rng.uniform(-1, 1, (20, 40, 4)).astype(np.float32)
    cert = rng.random((20, 40)).astype(np.float32) * 0.1
    cert[:5] = 0.0
    key = jax.random.PRNGKey(3)
    want = j_sample_matches(key, jnp.asarray(warp), jnp.asarray(cert), 100,
                            0.05, mode)
    k1, k2 = jax.random.split(key)
    noise = (np.array(jax.random.gumbel(k1, (800,))),
             np.array(jax.random.gumbel(k2, (400,))))
    got = sample_matches(torch.from_numpy(warp), torch.from_numpy(cert), 100,
                         0.05, mode,
                         noise=tuple(torch.from_numpy(n) for n in noise))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
