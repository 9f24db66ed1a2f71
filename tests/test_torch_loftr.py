"""gim_loftr in gim_tpu_torch against gim_tpu on the CPU, float32.

The JAX package's `init_params` gives the weights (BatchNorm scales, biases
and running statistics randomised so they are exercised); the port loads
them through `loftr_state_dict_from_jax` with strict=True. The coarse
output conv and every coarse layer's norm2 scale are halved, which keeps
the dual-softmax logits |sim/T| in the range where float32 determines
conf to 1e-4: at full scale they reach ~100, and the float32 rounding of
~1e-6 relative feature differences then moves log conf by up to 2.3e-4.

Tolerances:
- backbone and coarse transformer features: within 1e-4 of the largest
  magnitude of the reference output — 16 bottlenecks of float32
  convolutions (or 4 transformer pairs) summed in another order by XLA and
  by PyTorch's CPU kernels;
- the whole matcher: (i, j) sets agree on >= 99 % of valid slots; on the
  agreed slots mconf within rtol 1e-4 and mkpts1_f within 1e-3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.api import match_fn as j_match_fn
from gim_tpu.config import GimConfig as JGimConfig
from gim_tpu.config import LoFTRConfig as JLoFTRConfig
from gim_tpu.models.loftr import model as jmodel
from gim_tpu.models.loftr.backbone import ResNetFPN as JResNetFPN
from gim_tpu.models.loftr.transformer import (
    LocalFeatureTransformer as JTransformer)
from gim_tpu.weights import port as jport
from gim_tpu_torch.api import Matcher, match_fn
from gim_tpu_torch.config import GimConfig, LoFTRConfig
from gim_tpu_torch.models.loftr import LoFTRMatcher
from gim_tpu_torch.models.loftr.transformer import sine_pos_encoding
from gim_tpu_torch.weights.port import loftr_state_dict_from_jax

HIGH = jax.default_matmul_precision("highest")
MAXM = 64


def _randomize_bn(tree, rng):
    """Random BN scale/bias and running stats, in place on a numpy tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomize_bn(v, rng)
    if "mean" in tree:
        tree["mean"] = (0.1 * rng.standard_normal(tree["mean"].shape)
                        ).astype(np.float32)
        tree["var"] = rng.uniform(0.5, 1.5, tree["var"].shape
                                  ).astype(np.float32)


def _to_numpy(tree):
    return {k: _to_numpy(v) if hasattr(v, "items") else np.array(v)
            for k, v in tree.items()}


def make_variables():
    v = _to_numpy(jmodel.init_params(jax.random.PRNGKey(0), JLoFTRConfig()))
    rng = np.random.default_rng(0)
    _randomize_bn(v["batch_stats"], rng)
    for path in _bn_param_paths(v["params"]):
        node = v["params"]
        for p in path:
            node = node[p]
        node["scale"] = rng.uniform(0.5, 1.5, node["scale"].shape
                                    ).astype(np.float32)
        node["bias"] = (0.1 * rng.standard_normal(node["bias"].shape)
                        ).astype(np.float32)
    v["params"]["backbone"]["layer3_outconv"]["kernel"] *= 0.5
    for layer in v["params"]["loftr_coarse"].values():
        layer["norm2"]["scale"] *= 0.5
    return v


@pytest.fixture(scope="module")
def variables():
    return make_variables()


def _bn_param_paths(params, prefix=()):
    for k, v in params.items():
        if isinstance(v, dict):
            if "scale" in v and "kernel" not in v and k.endswith(
                    ("bn", "bn1", "bn2", "bn3", "down_bn")):
                yield prefix + (k,)
            else:
                yield from _bn_param_paths(v, prefix + (k,))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _port_model(variables, cfg=None):
    model = LoFTRMatcher(cfg or LoFTRConfig())
    model.load_state_dict(loftr_state_dict_from_jax(variables), strict=True)
    return model.eval()


def _assert_features_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_state_dict_round_trip(variables):
    """port_loftr(port state dict) gives back the JAX tree exactly."""
    sd = _port_model(variables).state_dict()
    back = jport.port_loftr({k: v.numpy() for k, v in sd.items()})
    a, b = _flat(variables), _flat(back)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), a[k], err_msg=k)


def test_state_dict_from_jax_rejects_leftover_leaves(variables):
    extra = dict(variables)
    extra["params"] = dict(variables["params"],
                           stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray/kernel"):
        loftr_state_dict_from_jax(extra)


def test_backbone_and_coarse_transformer(variables):
    model = _port_model(variables)
    rng = np.random.default_rng(1)
    x = rng.random((2, 3, 64, 96)).astype(np.float32)
    with torch.no_grad():
        t_c, t_f = model.backbone(torch.from_numpy(x))
    bb = {"params": variables["params"]["backbone"],
          "batch_stats": variables["batch_stats"]["backbone"]}
    with HIGH:
        j_c, j_f = JResNetFPN().apply(bb, jnp.transpose(jnp.asarray(x),
                                                        (0, 2, 3, 1)))
    _assert_features_close(t_c.permute(0, 2, 3, 1).numpy(), j_c)
    _assert_features_close(t_f.permute(0, 2, 3, 1).numpy(), j_f)

    # coarse transformer on the same (masked) sequences
    hc, wc = 8, 12
    feat = (np.asarray(j_c).reshape(2, hc * wc, 256)
            + sine_pos_encoding(256, hc, wc)[None]).astype(np.float32)
    f0, f1 = feat[:1], feat[1:]
    mask = np.ones((1, hc * wc), bool)
    mask[:, -wc:] = False                      # last coarse row padded
    with HIGH:
        j0, j1 = JTransformer(256, 8, 4, "linear").apply(
            {"params": variables["params"]["loftr_coarse"]},
            jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(mask),
            jnp.asarray(mask))
    with torch.no_grad():
        t0, t1 = model.loftr_coarse(torch.from_numpy(f0), torch.from_numpy(f1),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(mask))
    _assert_features_close(t0.numpy(), j0)
    _assert_features_close(t1.numpy(), j1)


def _pair(masked):
    """An identical pair of 96 x 96 images (random weights match an image
    with itself, so many slots are valid); with `masked`, 96 x 72 content
    on the canvas."""
    rng = np.random.default_rng(2)
    img0 = rng.random((1, 3, 96, 96)).astype(np.float32)
    img1 = img0.copy()
    m0 = m1 = None
    if masked:
        m0 = np.zeros((1, 96, 96), bool)
        m0[:, :, :72] = True
        m1 = m0.copy()
        img0 = img0 * m0[:, None]
        img1 = img1 * m1[:, None]
    return img0, img1, m0, m1


@pytest.mark.parametrize("fused,masked", [
    (False, False), (True, False), (False, True), (True, True)])
def test_match_fn_matches_jax(variables, fused, masked):
    kw = dict(max_matches=MAXM, match_threshold=0.0, fused_matching=fused)
    img0, img1, m0, m1 = _pair(masked)
    scale = np.array([[1.5, 2.0]], np.float32)

    jcfg = JGimConfig(loftr=JLoFTRConfig(**kw))

    def jax_side(v, *args):
        # match_fn's result, plus the matcher's coarse ids (one compile)
        return (j_match_fn("gim_loftr", jcfg, v, *args),
                jmodel.LoFTRMatcher(jcfg.loftr).apply(v, *args))

    with HIGH:
        want, want_out = jax.jit(jax_side)(
            jax.tree_util.tree_map(jnp.asarray, variables),
            jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(scale),
            jnp.asarray(scale), None if m0 is None else jnp.asarray(m0),
            None if m1 is None else jnp.asarray(m1))

    cfg = GimConfig(loftr=LoFTRConfig(**kw))
    model = _port_model(variables, cfg.loftr)
    got = match_fn("gim_loftr", cfg, model, torch.from_numpy(img0),
                   torch.from_numpy(img1), torch.from_numpy(scale),
                   torch.from_numpy(scale),
                   None if m0 is None else torch.from_numpy(m0),
                   None if m1 is None else torch.from_numpy(m1),
                   device="cpu")
    with torch.inference_mode():
        got_out = model(torch.from_numpy(img0), torch.from_numpy(img1),
                        torch.from_numpy(scale), torch.from_numpy(scale),
                        None if m0 is None else torch.from_numpy(m0),
                        None if m1 is None else torch.from_numpy(m1))

    assert got.kpts0.shape == (1, MAXM, 2) and got.valid.shape == (1, MAXM)
    jv = np.asarray(want.valid[0])
    tv = got.valid[0].numpy()
    ji = np.asarray(want_out["i_ids"][0])
    jj = np.asarray(want_out["j_ids"][0])
    ti = got_out["i_ids"][0].numpy()
    tj = got_out["j_ids"][0].numpy()
    jset = {(a, b): s for s, (a, b, v) in enumerate(zip(ji, jj, jv)) if v}
    tset = {(a, b): s for s, (a, b, v) in enumerate(zip(ti, tj, tv)) if v}
    assert len(jset) >= 8, "too few valid matches for a meaningful check"
    agreed = set(jset) & set(tset)
    assert len(agreed) >= 0.99 * len(set(jset) | set(tset))

    js = [jset[p] for p in sorted(agreed)]
    ts = [tset[p] for p in sorted(agreed)]
    np.testing.assert_allclose(got.conf[0].numpy()[ts],
                               np.asarray(want.conf[0])[js], rtol=1e-4)
    np.testing.assert_allclose(got.kpts1[0].numpy()[ts],
                               np.asarray(want.kpts1[0])[js], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got.kpts0[0].numpy()[ts],
                               np.asarray(want.kpts0[0])[js], rtol=0,
                               atol=1e-3)


def test_matcher_seeded_weights_are_reproducible():
    cfg = GimConfig(loftr=LoFTRConfig(max_matches=16, layer_names_c=1))
    a = Matcher("gim_loftr", cfg, generator=torch.Generator().manual_seed(3),
                device="cpu")
    b = Matcher("gim_loftr", cfg, generator=torch.Generator().manual_seed(3),
                device="cpu")
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    r = a.match(x, x)
    assert r.kpts0.shape == (1, 16, 2) and torch.isfinite(r.kpts1).all()
