"""LightGlue and the gim_lightglue slice in gim_tpu_torch against gim_tpu
on the CPU, float32. SuperPoint's modules are in
tests/test_torch_superpoint.py (whose weights this file shares).

LightGlue runs at width 64 with 4 heads and 3 layers on 64 keypoints.
Both packages run on the same weights: seeded numpy values go into the
port's LightGlue, the JAX variables come from its state dict through the
JAX package's `port_lightglue`, and the port loads them back through
`lightglue_state_dict_from_jax`. The JAX side runs under `jax.jit` at
full float32 matmul precision.

Tolerances: rotary ops within 1e-6; the log-assignment within 1e-5 for
the op and 1e-4 for the whole LightGlue; matches and filter decisions
exactly equal, ties included (every argmax takes the first maximum); the
slice (`match_fn("gim_lightglue")` on 2 masked pairs of 96 x 128
canvases, 64 keypoints, filter threshold 0, LightGlue from SuperPoint's
256-d descriptors through its input projection, JAX's pad uniforms):
`valid` equal, keypoints and confidences within 1e-4, slot by slot once
each pair's slots are put in the order of their image-0 keypoints.

Why that order: two keypoint scores that agree to float32 rounding can
rank the other way round in the two packages (their convolutions sum in
another order). Here two slots of pair 1 have scores 2e-9 apart (1e-7
relative) and trade places. LightGlue is equivariant under a permutation
of the slots, so the match sets are the same; the slot order is held
equal on all but 2 % of the slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.api import match_fn as j_match_fn
from gim_tpu.config import GimConfig as JGimConfig
from gim_tpu.config import LightGlueConfig as JLightGlueConfig
from gim_tpu.config import SuperPointConfig as JSuperPointConfig
from gim_tpu.models import lightglue as jlg
from gim_tpu.ops import attention as jatt
from gim_tpu.ops import matching as jmat
from gim_tpu.weights import port as jport
from gim_tpu_torch import api
from gim_tpu_torch.config import GimConfig, LightGlueConfig, SuperPointConfig
from gim_tpu_torch.models import lightglue as tlg
from gim_tpu_torch.ops import attention as tatt
from gim_tpu_torch.ops import matching as tmat
from gim_tpu_torch.weights import port as tport
from tests.test_torch_roma import HIGH, _randomize
from tests.test_torch_superpoint import variables as sp_variables  # noqa: F401
from tests.torch_ref import TorchLightGlue, TorchSuperPointNet

DIM, HEADS, LAYERS, K = 64, 4, 3, 64
LG = dict(descriptor_dim=DIM, num_heads=HEADS, n_layers=LAYERS,
          filter_threshold=0.0)


def _jit(fn, *args):
    with HIGH:
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def _t(a):
    return torch.tensor(np.asarray(a))


def _lg_variables(input_dim: int, seed: int):
    cfg = LightGlueConfig(input_dim=input_dim, **LG)
    return jport.port_lightglue(_randomize(tlg.LightGlue(cfg), seed),
                                n_layers=LAYERS)


@pytest.fixture(scope="module")
def variables():
    """The JAX package's LightGlue variables, from seeded values through
    its own port_lightglue."""
    return _lg_variables(DIM, 1)


def port_lightglue(variables, input_dim: int = DIM) -> tlg.LightGlue:
    model = tlg.LightGlue(LightGlueConfig(input_dim=input_dim, **LG))
    model.load_state_dict(tport.lightglue_state_dict_from_jax(
        variables, LAYERS), strict=True)
    return model.eval()


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_rotate_half_and_apply_rotary_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, HEADS, K, 16)).astype(np.float32)
    enc = rng.standard_normal((2, 2, 1, K, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        tatt.rotate_half(torch.from_numpy(x)).numpy(),
        np.asarray(jatt.rotate_half(jnp.asarray(x))))
    np.testing.assert_allclose(
        tatt.apply_rotary(torch.from_numpy(x), torch.from_numpy(enc)).numpy(),
        np.asarray(jatt.apply_rotary(jnp.asarray(x), jnp.asarray(enc))),
        rtol=0, atol=1e-6)


def test_sigmoid_log_double_softmax_matches_jax():
    rng = np.random.default_rng(1)
    sim = 3 * rng.standard_normal((2, 40, 50)).astype(np.float32)
    z0 = rng.standard_normal((2, 40)).astype(np.float32)
    z1 = rng.standard_normal((2, 50)).astype(np.float32)
    z1[1, :5] = -1e9                       # padded slots
    want = np.asarray(jmat.sigmoid_log_double_softmax(
        *map(jnp.asarray, (sim, z0, z1))))
    got = tmat.sigmoid_log_double_softmax(*map(torch.from_numpy,
                                                (sim, z0, z1)))
    assert got.shape == (2, 41, 51)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("threshold", [0.0, 0.1, 0.5])
def test_filter_matches_matches_jax_ties_included(threshold):
    """Log-assignments of a few distinct values: rows and columns with
    several equal maxima take the first, in both packages."""
    rng = np.random.default_rng(2)
    p = rng.integers(1, 5, (2, 33, 41)).astype(np.float32) / 4.0
    p[:, 3, [7, 9, 30]] = 2.0              # a row tied three ways
    p[:, [5, 20], 11] = 2.0                # a column tied twice
    scores = np.log(p)
    want = jmat.filter_matches(jnp.asarray(scores), threshold)
    got = tmat.filter_matches(torch.from_numpy(scores), threshold)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    m0 = got[0].numpy()
    assert m0[:, 3].tolist() == [7, 7] and (m0 >= 0).any()


# ---------------------------------------------------------------------------
# LightGlue
# ---------------------------------------------------------------------------

def _lg_inputs(seed, padded: bool):
    rng = np.random.default_rng(seed)
    size = np.array([[128.0, 96.0], [120.0, 80.0]], np.float32)
    kpts = (rng.random((2, 2, K, 2)) * size[None, :, None]).astype(
        np.float32) + 0.5
    desc = rng.standard_normal((2, 2, K, DIM)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    valid = np.ones((2, 2, K), bool)
    if padded:
        valid[0, 1, 50:] = False           # image 0 of pair 1
        valid[1, 0, 40:] = False           # image 1 of pair 0
    return kpts[0], kpts[1], desc[0], desc[1], size, size, valid[0], valid[1]


@pytest.mark.parametrize("padded", [False, True])
def test_lightglue_matches_jax(variables, padded):
    args = _lg_inputs(3, padded)
    if not padded:
        args = args[:6]
    jcfg = JLightGlueConfig(input_dim=DIM, **LG)
    want = _jit(lambda v, *a: jlg.LightGlue(jcfg).apply(v, *a), variables,
                *map(jnp.asarray, args))
    with torch.no_grad():
        got = port_lightglue(variables)(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got["log_assignment"].numpy(),
                               want["log_assignment"], rtol=0, atol=1e-4)
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for k in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-4)
    m0 = got["matches0"].numpy()
    assert (m0 >= 0).sum() >= 20
    if padded:
        assert (m0[1, 50:] == -1).all() and not np.isin(
            np.arange(40, K), m0[0]).any()


def test_lightglue_from_jax_refuses_leftover_leaves(variables):
    extra = {"params": dict(variables["params"],
                            token_9={"kernel": np.zeros((DIM, 1))})}
    with pytest.raises(ValueError, match="token_9"):
        tport.lightglue_state_dict_from_jax(extra, LAYERS)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

SLICE_H, SLICE_W = 96, 128


def _slice_cfgs():
    sp = dict(max_num_keypoints=K)
    lg = dict(LG, input_dim=256)
    return (GimConfig(superpoint=SuperPointConfig(**sp),
                      lightglue=LightGlueConfig(**lg)),
            JGimConfig(superpoint=JSuperPointConfig(**sp),
                       lightglue=JLightGlueConfig(**lg)))


def _slice_inputs():
    """2 pairs on 96 x 128 canvases, zero outside content masks of
    120 x 80 and 100 x 96 (w x h); image 1 is image 0 moved (3, 5) px."""
    rng = np.random.default_rng(4)
    blocks = rng.random((2, 3, SLICE_H // 4, SLICE_W // 4)).astype(
        np.float32)
    img0 = np.repeat(np.repeat(blocks, 4, 2), 4, 3)
    img1 = np.roll(img0, (3, 5), axis=(2, 3))
    mask = np.zeros((2, SLICE_H, SLICE_W), bool)
    mask[0, :80, :120] = True
    mask[1, :, :100] = True
    scale0 = np.array([[1.5, 2.0], [1.0, 1.0]], np.float32)
    scale1 = np.array([[2.0, 1.5], [0.5, 0.5]], np.float32)
    return (img0 * mask[:, None], img1 * mask[:, None], scale0, scale1,
            mask, mask)


@pytest.fixture(scope="module")
def slice_variables(sp_variables):  # noqa: F811
    return {"superpoint": sp_variables,
            "lightglue": _lg_variables(256, 5)}


def _slice_model(slice_variables):
    cfg, _ = _slice_cfgs()
    model = api.build_model("gim_lightglue", cfg)
    sd = {f"superpoint.{k}": v for k, v in
          tport.superpoint_state_dict_from_jax(
              slice_variables["superpoint"]).items()}
    sd.update({f"lightglue.{k}": v for k, v in
               tport.lightglue_state_dict_from_jax(
                   slice_variables["lightglue"], LAYERS).items()})
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_match_fn_matches_jax(slice_variables):
    cfg, jcfg = _slice_cfgs()
    args = _slice_inputs()
    want = _jit(lambda v, *a: j_match_fn("gim_lightglue", jcfg, v, *a),
                slice_variables, *map(jnp.asarray, args))
    noise = [_t(jax.random.uniform(jax.random.PRNGKey(s), (2, K, 2)))
             for s in api.PAD_SEEDS]
    got = api.match_fn("gim_lightglue", cfg, _slice_model(slice_variables),
                       *map(torch.from_numpy, args), device="cpu",
                       pad_noise=noise)
    same_slot = (got.kpts0.numpy() == want.kpts0).all(-1)
    assert same_slot.mean() >= 0.98, same_slot.mean()

    def by_kpts0(r):
        """Each pair's slots in the order of their image-0 keypoints."""
        k0 = np.asarray(r.kpts0)
        order = np.stack([np.lexsort((k[:, 1], k[:, 0])) for k in k0])
        return [np.take_along_axis(np.asarray(t), order.reshape(
            order.shape + (1,) * (np.ndim(t) - 2)), 1)
            for t in (r.kpts0, r.kpts1, r.conf, r.valid)]

    g0, g1, gc, gv = by_kpts0(got)
    w0, w1, wc, wv = by_kpts0(want)
    np.testing.assert_array_equal(gv, wv)
    for g, w in ((g0, w0), (g1, w1), (gc, wc)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    # random SuperPoint weights give descriptors that share a dominant
    # direction, so few slots are mutual nearest neighbours
    v = got.valid.numpy()
    assert v.sum(1).min() >= 1
    k0 = got.kpts0.numpy() / args[2][:, None]
    assert (k0[v][:, 0] < 120.5).all() and (k0[v][:, 1] < 96.5).all()


def test_matcher_draws_pad_noise_from_seeded_generators(slice_variables):
    """Without pad_noise, each call draws the pad uniforms from
    generators on the device seeded 97 and 131: Matcher.match gives what
    match_fn gives with those draws, call after call."""
    cfg, _ = _slice_cfgs()
    model = _slice_model(slice_variables)
    m = api.Matcher("gim_lightglue", cfg, state_dict=model.state_dict(),
                    device="cpu")
    args = list(map(torch.from_numpy, _slice_inputs()))
    noise = [torch.rand((2, K, 2), generator=torch.Generator()
                        .manual_seed(s)) for s in api.PAD_SEEDS]
    want = api.match_fn("gim_lightglue", cfg, model, *args, device="cpu",
                        pad_noise=noise)
    for _ in range(2):
        got = m.match(*args)
        for f in ("kpts0", "kpts1", "conf", "valid"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_checkpoint_loads_strictly(tmp_path):
    """A reference-layout gim_lightglue checkpoint (`superpoint.` and
    `model.` prefixes, every layer's log_assignment head, token
    confidence heads and thresholds) loads through from_checkpoint with
    strict keys; the early-exit heads are dropped."""
    torch.manual_seed(6)
    sp, lg = TorchSuperPointNet(descriptor_dim=DIM), TorchLightGlue(
        dim=DIM, heads=HEADS, n_layers=LAYERS)
    sd = {f"superpoint.{k}": v for k, v in sp.state_dict().items()}
    sd.update({f"model.{k}": v for k, v in lg.state_dict().items()})
    for i in range(LAYERS - 1):
        sd[f"model.token_confidence.{i}.token.0.weight"] = torch.zeros(1, DIM)
        sd[f"model.token_confidence.{i}.token.0.bias"] = torch.zeros(1)
    sd["model.confidence_thresholds"] = torch.zeros(LAYERS)
    path = tmp_path / "gim_lightglue.ckpt"
    torch.save({"state_dict": sd}, path)
    cfg = GimConfig(superpoint=SuperPointConfig(descriptor_dim=DIM,
                                                max_num_keypoints=K),
                    lightglue=LightGlueConfig(input_dim=DIM, **LG))
    m = api.Matcher.from_checkpoint("gim_lightglue", str(path), cfg,
                                    device="cpu")
    got = m.model.state_dict()
    last = f"log_assignment.{LAYERS - 1}."
    want = {f"superpoint.{k}": v for k, v in sp.state_dict().items()}
    want.update({f"lightglue.{k}": v for k, v in lg.state_dict().items()
                 if not k.startswith("log_assignment.")
                 or k.startswith(last)})
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    r = m.match(*map(torch.from_numpy, _slice_inputs()))
    assert r.kpts0.shape == (2, K, 2) and bool(torch.isfinite(r.conf).all())
