"""gim_roma in gim_tpu_torch against gim_tpu on the CPU, float32: the
whole slice here, its modules in tests/test_torch_roma_modules.py.

Both packages run on the same weights: seeded numpy values (BatchNorm
and LayerNorm parameters and statistics away from identity, position
tokens non-zero) go into the JAX package's tree through its own
`port_roma` / `port_dinov2`, and the port loads that tree through
`roma_state_dict_from_jax`. The model is the tiny configuration of the
JAX package's own RoMa test (tests/test_roma_semseg.py:60-62: coarse 56,
upsample 112, anchor grid 8 x 8, 1 decoder block) with a 1-block DINOv2 at
full width (1024, 16 heads). The JAX side runs eagerly, each module once.

Tolerances, all float32 (the port sums in another order than XLA; TF32
plays no part on the CPU):
- resizes, sampling, correlation, the GP and cls_to_flow_refine: 1e-5
  absolute on values of order 1, or relative to the largest value where
  they are larger (the GP posterior);
- the KDE: 1e-4 relative; it expands |a - b|^2 = |a|^2 + |b|^2 - 2 a.b,
  whose float32 cancellation the 1 / (2 std^2) = 50 in the exponent
  amplifies;
- ConvRefiner and the DINOv2 trunk: 1e-4 of the largest magnitude of the
  reference output (9 depthwise blocks of 5 x 5 taps, or 2 transformer
  blocks, summed in another order);
- the whole matcher: warp within 1e-4 (normalized coordinates) and
  certainty within 1e-4 on >= 99.9 % of pixels: the coarse flow takes an
  argmax over the anchor grid, and a near-tie there moves a pixel's flow
  by a whole anchor, which the allowance of 0.1 % of pixels covers;
- the sampled matches: identical, given JAX's Gumbel draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.api import match_fn as j_match_fn
from gim_tpu.config import GimConfig as JGimConfig
from gim_tpu.config import RoMaConfig as JRoMaConfig
from gim_tpu.models.roma import model as jr
from gim_tpu.weights import port as jport
from gim_tpu_torch.api import Matcher, match_fn
from gim_tpu_torch.config import GimConfig, RoMaConfig
from gim_tpu_torch.models.roma import RoMaMatcher
from gim_tpu_torch.ops.kernels import forward_only
from gim_tpu_torch.weights import port as tport

HIGH = jax.default_matmul_precision("highest")
TINY = dict(coarse_res=56, upsample_res=(112, 112), cls_to_coord_res=8,
            num_decoder_blocks=1, num_samples=32, dino_depth=1)


def _kernels(monkeypatch, on: bool):
    """The port's kernel rule forced: K2 and K3 take their plain versions
    on the CPU where it holds."""
    monkeypatch.setattr(forward_only, "on_kernel", lambda x: on)


@torch.no_grad()
def _randomize(model: torch.nn.Module, seed: int) -> dict:
    """Seeded numpy values for every parameter and statistic; returns the
    state dict as numpy arrays."""
    rng = np.random.default_rng(seed)

    def put(t, a):
        t.copy_(torch.from_numpy(np.asarray(a, np.float32)))

    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            w = mod.weight
            put(w, rng.standard_normal(w.shape) / np.sqrt(w[0].numel()))
            if mod.bias is not None:
                put(mod.bias, 0.1 * rng.standard_normal(mod.bias.shape))
        elif isinstance(mod, (torch.nn.BatchNorm2d, torch.nn.LayerNorm)):
            n = mod.weight.shape
            put(mod.weight, rng.uniform(0.5, 1.5, n))
            put(mod.bias, 0.1 * rng.standard_normal(n))
            if isinstance(mod, torch.nn.BatchNorm2d):
                put(mod.running_mean, 0.1 * rng.standard_normal(n))
                put(mod.running_var, rng.uniform(0.5, 1.5, n))
    for name, p in model.named_parameters():
        if name.endswith(("cls_token", "pos_embed")):
            put(p, 0.5 * rng.standard_normal(p.shape))
        elif name.endswith("gamma"):
            put(p, rng.uniform(0.5, 1.5, p.shape))
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _to_jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def variables():
    """The JAX package's variables for the tiny model, from seeded values
    through its own port_roma + port_dinov2."""
    sd = _randomize(RoMaMatcher(RoMaConfig(**TINY)), 0)
    roma_sd, dino_sd = tport.split_roma_state_dict(sd)
    v = jport.port_roma(roma_sd, None, n_decoder_blocks=1)
    v["params"]["dino"] = jport.port_dinov2(dino_sd, depth=1)["params"]
    return v


def _port_model(variables, cfg=None):
    model = RoMaMatcher(cfg or RoMaConfig(**TINY))
    roma_sd, dino_sd = tport.roma_state_dict_from_jax(variables)
    model.load_state_dict(tport.roma_model_state_dict(roma_sd, dino_sd),
                          strict=True)
    return model.eval()


def _images(seed, masked=False):
    rng = np.random.default_rng(seed)
    img0 = rng.random((1, 3, 56, 56)).astype(np.float32)
    img1 = np.roll(img0, (3, 5), axis=(2, 3)).copy()
    img1[:, :, :6] = 0.0                     # a black band: cert -> 0 there
    m = None
    if masked:
        m = np.zeros((1, 56, 56), bool)
        m[:, :, :42] = True
        img0 = img0 * m[:, None]
        img1 = img1 * m[:, None]
    return img0, img1, m


@pytest.fixture(scope="module")
def jax_forward(variables):
    """JAX RoMaMatcher warp and certainty at its default graph."""
    img0, img1, _ = _images(1)
    with HIGH:
        warp, cert = jr.RoMaMatcher(JRoMaConfig(**TINY)).apply(
            _to_jax_tree(variables), jnp.asarray(img0), jnp.asarray(img1))
    return img0, img1, np.asarray(warp), np.asarray(cert)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("switches", ["0", "1"])
def test_roma_matcher_matches_jax(variables, jax_forward, monkeypatch,
                                  switches):
    """warp and certainty against the JAX package's default graph, with
    the port's kernel rule as on the CPU ("0": its default graph) and
    forced on ("1": K2 and K3's plain versions on the CPU)."""
    _kernels(monkeypatch, switches == "1")
    img0, img1, want_w, want_c = jax_forward
    with torch.inference_mode():
        warp, cert = _port_model(variables)(torch.from_numpy(img0),
                                            torch.from_numpy(img1))
    assert warp.shape == (1, 112, 224, 4) and cert.shape == (1, 112, 224)
    dw = np.abs(warp.numpy() - want_w).max(-1)
    dc = np.abs(cert.numpy() - want_c)
    assert (dw <= 1e-4).mean() >= 0.999, dw.max()
    assert (dc <= 1e-4).mean() >= 0.999, dc.max()
    assert want_c.max() > 0.0 and (want_c == 0.0).any()


def test_roma_matcher_matches_jax_kernels(variables, jax_forward,
                                          monkeypatch):
    """The JAX package with its two kernels on (the Pallas refiner block
    forced, flash attention in interpret mode) against the port with its
    kernel rule forced on."""
    _kernels(monkeypatch, True)
    monkeypatch.setenv("GIM_TPU_FLASH_VIT", "1")             # JAX's side
    monkeypatch.setenv("GIM_TPU_FUSED_REFINER", "force")
    img0, img1, _, _ = jax_forward
    with HIGH:
        want_w, want_c = (np.asarray(t) for t in jr.RoMaMatcher(
            JRoMaConfig(**TINY)).apply(_to_jax_tree(variables),
                                       jnp.asarray(img0), jnp.asarray(img1)))
    with torch.inference_mode():
        warp, cert = _port_model(variables)(torch.from_numpy(img0),
                                            torch.from_numpy(img1))
    assert (np.abs(warp.numpy() - want_w).max(-1) <= 1e-4).mean() >= 0.999
    assert (np.abs(cert.numpy() - want_c) <= 1e-4).mean() >= 0.999


def _jax_noise(B, n_cells, n_grab):
    """The Gumbel draws of gim_tpu/api.py:_match_roma (PRNGKey(11) split
    per pair, then split in two inside sample_matches)."""
    out = []
    for key in jax.random.split(jax.random.PRNGKey(11), B):
        k1, k2 = jax.random.split(key)
        out.append((torch.from_numpy(np.array(jax.random.gumbel(
            k1, (n_cells,)))), torch.from_numpy(np.array(
                jax.random.gumbel(k2, (n_grab,))))))
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_match_fn_with_jax_noise_matches_jax(variables, masked):
    """match_fn end to end: the same sampled matches (cells of the warp)
    as the JAX package's match_fn, given its Gumbel draws; keypoints
    within 1e-3 px, including the content-mask (distort_aspect) path."""
    img0, img1, m = _images(2, masked)
    scale = np.array([[1.5, 2.0]], np.float32)
    jcfg = JGimConfig(roma=JRoMaConfig(**TINY))
    with HIGH:
        want = j_match_fn("gim_roma", jcfg, _to_jax_tree(variables),
                          jnp.asarray(img0), jnp.asarray(img1),
                          jnp.asarray(scale), jnp.asarray(scale),
                          None if m is None else jnp.asarray(m),
                          None if m is None else jnp.asarray(m))
    cfg = GimConfig(roma=RoMaConfig(**TINY))
    noise = _jax_noise(1, 112 * 224, 4 * cfg.roma.num_samples)
    t = (None if m is None else torch.from_numpy(m))
    got = match_fn("gim_roma", cfg, _port_model(variables),
                   torch.from_numpy(img0), torch.from_numpy(img1),
                   torch.from_numpy(scale), torch.from_numpy(scale), t, t,
                   device="cpu", sample_noise=noise)
    assert got.kpts0.shape == (1, 32, 2) and got.valid.shape == (1, 32)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for g, w in ((got.kpts0, want.kpts0), (got.kpts1, want.kpts1)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-3)
    np.testing.assert_allclose(got.conf.numpy(), np.asarray(want.conf),
                               rtol=0, atol=1e-4)


def test_matcher_seeded_and_bf16(variables):
    """Seeded random weights are reproducible, and the bf16 graph gives
    finite results of the right shapes, near the float32 ones."""
    cfg = GimConfig(roma=RoMaConfig(**TINY))
    a = Matcher("gim_roma", cfg, generator=torch.Generator().manual_seed(3),
                device="cpu")
    b = Matcher("gim_roma", cfg, generator=torch.Generator().manual_seed(3),
                device="cpu")
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    img0, img1, _ = _images(3)
    x0, x1 = torch.from_numpy(img0), torch.from_numpy(img1)
    r = a.match(x0, x1)
    assert r.kpts0.shape == (1, 32, 2) and torch.isfinite(r.kpts1).all()
    sd = _port_model(variables).state_dict()
    f32 = Matcher("gim_roma", cfg, state_dict=sd, device="cpu")
    bf16 = Matcher("gim_roma", GimConfig(roma=RoMaConfig(
        **TINY, dtype="bfloat16")), state_dict=sd, device="cpu")
    with torch.inference_mode():
        w32, c32 = f32.model(x0, x1)
        w16, c16 = bf16.model(x0, x1)
    assert w16.dtype == torch.float32 and torch.isfinite(w16).all()
    assert float((w16 - w32).abs().amax(-1).le(0.05).float().mean()) > 0.9
    assert float((c16 - c32).abs().le(0.05).float().mean()) > 0.9
