"""SuperPoint in gim_tpu_torch against gim_tpu on the CPU, float32: the
dense heads, NMS, borders, the top-k, descriptor sampling and the whole
extraction. LightGlue and the gim_lightglue slice are in
tests/test_torch_lightglue.py.

Both packages run on the same weights: seeded numpy values (biases away
from zero) go into the port's SuperPointNet, the JAX variables come from
its state dict through the JAX package's `port_superpoint`, and the port
loads them back through `superpoint_state_dict_from_jax`. The JAX side
runs under `jax.jit`, as the JAX package's Matcher runs it, at full
float32 matmul precision. Images are 96 x 128, with 64 keypoints, and
512 for the whole extraction (about 480 NMS maxima an image: both valid
and padded slots).

Tolerances: the dense heads within 2e-5 (tests/test_weight_port.py's
bound for the same heads against a torch replica); NMS, borders and the
top-k exactly equal on the same score maps, planted ties included;
descriptor sampling within 1e-5; the extraction's keypoints and valid
flags equal and its descriptors within 1e-5, given JAX's pad uniforms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.config import SuperPointConfig as JSuperPointConfig
from gim_tpu.models import superpoint as jsp
from gim_tpu.ops import detect as jdet
from gim_tpu.ops import sampling as jsam
from gim_tpu.weights import port as jport
from gim_tpu_torch.config import SuperPointConfig
from gim_tpu_torch.models import superpoint as tsp
from gim_tpu_torch.ops import detect as tdet
from gim_tpu_torch.ops import sampling as tsam
from gim_tpu_torch.weights import port as tport
from tests.test_torch_roma import HIGH, _randomize

H, W, K = 96, 128, 64
K_EXTRACT = 512


@pytest.fixture(scope="module")
def variables():
    """The JAX package's SuperPointNet variables, from seeded values
    through its own port_superpoint."""
    return jport.port_superpoint(_randomize(tsp.SuperPointNet(), 0))


def port_net(variables) -> tsp.SuperPointNet:
    net = tsp.SuperPointNet()
    net.load_state_dict(tport.superpoint_state_dict_from_jax(variables),
                        strict=True)
    return net.eval()


def _gray(seed, B=2):
    """Blocky gray images (4 x 4 blocks), so that the score map has
    structure at the cell scale."""
    rng = np.random.default_rng(seed)
    blocks = rng.random((B, 1, H // 4, W // 4)).astype(np.float32)
    return np.repeat(np.repeat(blocks, 4, 2), 4, 3)


def _jit(fn, *args):
    with HIGH:
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def test_dense_heads_match_jax(variables):
    img = _gray(1)
    want_s, want_d = _jit(
        lambda v, x: jsp.SuperPointNet().apply(v, x), variables,
        jnp.asarray(img.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got_s, got_d = port_net(variables)(torch.from_numpy(img))
    assert got_s.shape == (2, H, W) and got_d.shape == (2, 256, H // 8,
                                                        W // 8)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_d.numpy(), want_d.transpose(0, 3, 1, 2),
                               rtol=0, atol=2e-5)


def _tied_scores(seed, B=2, h=H, w=W):
    """Score maps of few distinct values: flat plateaus and equal maxima
    far apart, the ties NMS keeps and the top-k must order."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 6, (B, h, w)).astype(np.float32) / 8.0
    s[:, 10:13, 20:23] = 0.875                 # a 3 x 3 plateau
    s[:, 40, 60] = s[:, 70, 100] = 0.875       # equal isolated maxima
    return s


@pytest.mark.parametrize("radius", [1, 3])
def test_simple_nms_matches_jax_exactly(radius):
    s = _tied_scores(2)
    want = np.asarray(jdet.simple_nms(jnp.asarray(s), radius))
    got = tdet.simple_nms(torch.from_numpy(s), radius).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0.875).sum() > 3 * 2        # plateau pixels survive


@pytest.mark.parametrize("with_hw", [False, True])
def test_remove_borders_matches_jax_exactly(with_hw):
    s = _tied_scores(3)
    hw = np.array([[80, 120], [96, 100]], np.float32) if with_hw else None
    want = np.asarray(jdet.remove_borders(
        jnp.asarray(s), 4, None if hw is None else jnp.asarray(hw)))
    got = tdet.remove_borders(torch.from_numpy(s), 4,
                              None if hw is None else torch.from_numpy(hw))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["pad_noise", "zeros", "few_positive"])
def test_topk_keypoints_matches_jax_exactly(case):
    """Planted ties among the kept scores order by flat index, as
    jax.lax.top_k does; empty slots take JAX's uniforms times the
    smaller side of the bounds (or sit at 0)."""
    s = np.array(jdet.simple_nms(jnp.asarray(_tied_scores(4)), 3))
    if case == "few_positive":            # fewer maxima than slots
        s = np.where(s >= 0.75, s, 0.0).astype(np.float32)
    hw = np.array([[80, 120], [96, 100]], np.float32)
    key = jax.random.PRNGKey(97) if case != "zeros" else None
    want = jdet.topk_keypoints(jnp.asarray(s), K, 0.0, pad_rng=key,
                               bounds_hw=jnp.asarray(hw))
    noise = (None if key is None else
             torch.tensor(np.asarray(jax.random.uniform(key, (2, K, 2)))))
    got = tdet.topk_keypoints(torch.from_numpy(s), K, 0.0, pad_noise=noise,
                              bounds_hw=torch.from_numpy(hw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    valid = got[2].numpy()
    vals = got[1].numpy()
    assert (vals[valid] == 0.875).sum() >= 2 * 11   # ties were ranked
    if case == "few_positive":
        assert not valid.all() and valid.any()


@pytest.mark.parametrize("legacy", [True, False])
def test_sample_descriptors_matches_jax(legacy):
    rng = np.random.default_rng(5)
    desc = rng.standard_normal((2, 32, H // 8, W // 8)).astype(np.float32)
    kpts = np.stack([rng.integers(0, W, (2, K)), rng.integers(0, H, (2, K))],
                    -1).astype(np.float32)
    kpts[:, :4] = [[0, 0], [W - 1, H - 1], [3.5, 90.25], [127.0, 0.0]]
    want = np.asarray(jsam.sample_descriptors(
        jnp.asarray(kpts), jnp.asarray(desc), 8, legacy=legacy))
    got = tsam.sample_descriptors(torch.from_numpy(kpts),
                                  torch.from_numpy(desc), 8, legacy=legacy)
    assert got.shape == (2, K, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_safe_l2_normalize_matches_jax_and_is_finite_at_zero():
    x = np.random.default_rng(6).standard_normal((3, 5, 16)).astype(
        np.float32)
    x[1, 2] = 0.0
    want = np.asarray(jsam.safe_l2_normalize(jnp.asarray(x), axis=-1))
    got = tsam.safe_l2_normalize(torch.from_numpy(x), dim=-1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.isfinite(got).all() and (got[1, 2] == 0).all()


@pytest.mark.parametrize("rgb", [True, False])
def test_extract_matches_jax(variables, rgb):
    """The whole extraction on a padded canvas (true (h, w) 80 x 120 and
    96 x 100), with JAX's pad uniforms handed to the port."""
    img = _gray(7)
    if rgb:
        img = np.concatenate([img, img[:, :, ::-1], img[:, :, :, ::-1]], 1)
    hw = np.array([[80, 120], [96, 100]], np.float32)
    cfg = JSuperPointConfig(max_num_keypoints=K_EXTRACT)
    key = jax.random.PRNGKey(97)
    want = _jit(lambda v, x, b: jsp.extract(v, x, cfg, image_hw=b,
                                            pad_rng=key),
                variables, jnp.asarray(img), jnp.asarray(hw))
    noise = torch.tensor(np.asarray(jax.random.uniform(key, (2, K_EXTRACT,
                                                             2))))
    with torch.no_grad():
        got = tsp.extract(port_net(variables), torch.from_numpy(img),
                          SuperPointConfig(max_num_keypoints=K_EXTRACT),
                          torch.from_numpy(hw), noise)
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["keypoints"].numpy(),
                                  want["keypoints"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["descriptors"].numpy(),
                               want["descriptors"], rtol=0, atol=1e-5)
    v = got["valid"].numpy()
    assert v.sum() >= 400 and not v.all()    # both kinds of slot
    kp = got["keypoints"].numpy()
    assert (kp[..., 0] < hw[:, None, 1] + 0.5).all()
    assert (kp[..., 1] < hw[:, None, 0] + 0.5).all()


def test_superpoint_from_jax_refuses_leftover_leaves(variables):
    extra = {"params": dict(variables["params"],
                            convX={"kernel": np.zeros((1, 1, 1, 1))})}
    with pytest.raises(ValueError, match="convX"):
        tport.superpoint_state_dict_from_jax(extra)
