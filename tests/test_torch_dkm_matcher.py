"""gim_dkm in gim_tpu_torch against gim_tpu on the CPU, float32: the whole
slice here, its modules in tests/test_torch_dkm.py (whose weights and
tolerances this file shares).

The matcher is the tiny configuration of the JAX package's own DKM test
(tests/test_dkm.py:222: 48 x 64, upsample 96 x 128) at full width, on
a 64 x 64 canvas in both input modes: distort-aspect (content masks, the
ZEB protocol: the valid rectangle is resampled to 48 x 64) and aspect-pad
(no masks: the canvas is right-padded to 64 x 85 and resized whole). The
JAX side runs once per mode and module: the JAX package's match_fn
under jax.jit, as its Matcher runs it, returning the DKMMatcher output
that it samples from beside its result.

Tolerances (float32): warp within 1e-4 (normalized coordinates) and
certainty within 1e-4 on >= 99.9 % of pixels; the sampled matches
identical given JAX's Gumbel draws, keypoints within 1e-3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.api import match_fn as j_match_fn
from gim_tpu.config import DKMConfig as JDKMConfig
from gim_tpu.config import GimConfig as JGimConfig
from gim_tpu.models.dkm import model as jm
from gim_tpu.weights import port as jport
from gim_tpu_torch import api
from gim_tpu_torch.api import Matcher, match_fn
from gim_tpu_torch.config import DKMConfig, GimConfig
from gim_tpu_torch.weights import port as tport
from tests.test_torch_dkm import (TINY, jit_apply,  # noqa: F401
                                  port, variables)
from tests.test_torch_roma import _flat, _to_jax_tree

S = 64                                     # square canvas
PAD_W = round(S * 64 / 48) - S             # aspect-pad: 64 x 85


def _images(seed, masked: bool):
    """A pair on the canvas with a black band (certainty 0 there); with
    `masked`, content masks of 64 x 48 and 40 x 60 (w x h) and the canvas
    zero outside them."""
    rng = np.random.default_rng(seed)
    img0 = rng.random((1, 3, S, S)).astype(np.float32)
    img1 = np.roll(img0, (3, 5), axis=(2, 3)).copy()
    img1[:, :, :6] = 0.0
    if not masked:
        return img0, img1, None, None
    m0 = np.zeros((1, S, S), bool)
    m0[:, :48, :] = True
    m1 = np.zeros((1, S, S), bool)
    m1[:, :40, :60] = True
    return img0 * m0[:, None], img1 * m1[:, None], m0, m1


def _extent(m):
    h = m.sum(1).max(-1)
    w = m.sum(2).max(-1)
    return np.stack([w / S, h / S], -1).astype(np.float32)


def _model_inputs(masked: bool):
    """What match_fn hands the model in each mode: (im0, im1, e0, e1)."""
    img0, img1, m0, m1 = _images(1, masked)
    if masked:
        return img0, img1, _extent(m0), _extent(m1)
    pad = ((0, 0), (0, 0), (0, 0), (0, PAD_W))
    return np.pad(img0, pad), np.pad(img1, pad), None, None


SCALE = np.array([[1.5, 2.0]], np.float32)


@pytest.fixture(scope="module")
def jax_forward(variables):  # noqa: F811
    """The JAX package's match_fn on the pair of `_images(1, masked)` in
    both modes, and the warp and certainty that its DKMMatcher returned
    inside it (on the inputs of `_model_inputs(masked)`)."""
    apply = jm.DKMMatcher.apply
    seen = []

    def spy(self, *args, **kw):
        seen.append(apply(self, *args, **kw))
        return seen[-1]

    class MatchFn:
        """match_fn with the DKMMatcher output it sampled from."""

        def apply(self, variables, *args):
            res = j_match_fn("gim_dkm", JGimConfig(dkm=JDKMConfig(**TINY)),
                             variables, *args)
            return res, seen.pop()

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm.DKMMatcher, "apply", spy)
        for masked in (True, False):
            img0, img1, m0, m1 = (None if a is None else jnp.asarray(a)
                                  for a in _images(1, masked))
            res, (warp, cert) = jit_apply(
                MatchFn(), _to_jax_tree(variables), img0, img1,
                jnp.asarray(SCALE), jnp.asarray(SCALE), m0, m1)
            out[masked] = (np.asarray(warp), np.asarray(cert),
                           jax.tree_util.tree_map(np.asarray, res))
    return out


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("switch", ["0", "1"])
@pytest.mark.parametrize("masked", [True, False])
def test_dkm_matcher_matches_jax(port, jax_forward,  # noqa: F811
                                 monkeypatch, masked, switch):
    """warp and certainty against the JAX package's default graph, in
    both input modes, with GIM_TPU_FUSED_REFINER off and on (the hidden
    blocks of scales 2 and 1 then take K2's plain version on the CPU)."""
    monkeypatch.setenv("GIM_TPU_FUSED_REFINER", switch)
    want_w, want_c, _ = jax_forward[masked]
    args = [None if a is None else torch.from_numpy(a)
            for a in _model_inputs(masked)]
    with torch.inference_mode():
        warp, cert = port(*args)
    assert warp.shape == (1, 96, 256, 4) and cert.shape == (1, 96, 256)
    dw = np.abs(warp.numpy() - want_w).max(-1)
    dc = np.abs(cert.numpy() - want_c)
    assert (dw <= 1e-4).mean() >= 0.999, dw.max()
    assert (dc <= 1e-4).mean() >= 0.999, dc.max()
    assert want_c.max() > 0.0 and (want_c == 0.0).any()


def _jax_noise(B, n_cells, n_grab):
    """The Gumbel draws of gim_tpu/api.py:_match_dkm (PRNGKey(7) split per
    pair, then split in two inside sample_matches)."""
    out = []
    for key in jax.random.split(jax.random.PRNGKey(7), B):
        k1, k2 = jax.random.split(key)
        out.append((torch.from_numpy(np.array(jax.random.gumbel(
            k1, (n_cells,)))), torch.from_numpy(np.array(
                jax.random.gumbel(k2, (n_grab,))))))
    return out


@pytest.mark.parametrize("masked", [True, False])
def test_match_fn_with_jax_noise_matches_jax(port, jax_forward,  # noqa: F811
                                            masked):
    """match_fn end to end: the same sampled matches as the JAX package's
    match_fn, given its Gumbel draws; keypoints in the original frame
    within 1e-3 px, in both input modes."""
    img0, img1, m0, m1 = _images(1, masked)
    scale = SCALE
    want = jax_forward[masked][2]
    cfg = GimConfig(dkm=DKMConfig(**TINY))
    noise = _jax_noise(1, 96 * 256, 4 * cfg.dkm.num_samples)
    got = match_fn("gim_dkm", cfg, port,
                   torch.from_numpy(img0), torch.from_numpy(img1),
                   torch.from_numpy(scale), torch.from_numpy(scale),
                   None if m0 is None else torch.from_numpy(m0),
                   None if m1 is None else torch.from_numpy(m1),
                   device="cpu", sample_noise=noise)
    assert got.kpts0.shape == (1, 64, 2) and got.valid.shape == (1, 64)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any()
    for g, w in ((got.kpts0, want.kpts0), (got.kpts1, want.kpts1)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-3)
    np.testing.assert_allclose(got.conf.numpy(), np.asarray(want.conf),
                               rtol=0, atol=1e-4)
    if masked:                  # inside each content rectangle (w, h)
        for k, (w, h) in ((got.kpts0, (64, 48)), (got.kpts1, (60, 40))):
            k = k[got.valid] / torch.from_numpy(scale)
            assert bool((k >= 0).all() and (k[:, 0] <= w).all()
                        and (k[:, 1] <= h).all())


# ---------------------------------------------------------------------------
# weights and entry points
# ---------------------------------------------------------------------------

def test_state_dict_round_trip(variables, port):  # noqa: F811
    """port_dkm of the port's state dict gives back the JAX tree exactly,
    with no key left over (port_dkm asserts that)."""
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = jport.port_dkm(sd)
    a, b = _flat(variables), _flat(back)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), a[k], err_msg=k)


def test_state_dict_from_jax_rejects_leftover_leaves(variables):  # noqa: F811
    extra = dict(variables)
    extra["params"] = dict(variables["params"],
                           stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray/kernel"):
        tport.dkm_state_dict_from_jax(extra)


def test_matcher_from_checkpoint(tmp_path, port):  # noqa: F811
    """A reference-layout gim_dkm checkpoint ('model.' prefixes, the
    unused torchvision `encoder.net.fc`) loads through from_checkpoint."""
    cfg = GimConfig(dkm=DKMConfig(**TINY))
    src = port.state_dict()
    ckpt = dict({f"model.{k}": v for k, v in src.items()})
    ckpt["model.encoder.net.fc.weight"] = torch.zeros(1000, 2048)
    ckpt["model.encoder.net.fc.bias"] = torch.zeros(1000)
    torch.save({"state_dict": ckpt}, tmp_path / "gim_dkm_100h.ckpt")
    m = Matcher.from_checkpoint("gim_dkm", str(tmp_path / "gim_dkm_100h.ckpt"),
                                cfg, device="cpu")
    got = m.model.state_dict()
    assert set(got) == set(src)
    for k, v in src.items():
        assert torch.equal(got[k], v), k
    assert all(v.dtype == torch.float32 for v in m.model.parameters())


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["Matcher", "from_checkpoint", "match_fn"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry,
                                                           tmp_path):
    cfg = GimConfig(dkm=DKMConfig(**TINY))
    x = torch.zeros(1, 3, S, S)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "Matcher":
            Matcher("gim_dkm", cfg)
        elif entry == "from_checkpoint":
            Matcher.from_checkpoint("gim_dkm", str(tmp_path / "none.ckpt"),
                                    cfg)
        else:
            match_fn("gim_dkm", cfg, api.build_model("gim_dkm", cfg), x, x)


def test_matcher_default_sampling_and_bf16(port):  # noqa: F811
    """match() samples with its default generator (seed 7) reproducibly,
    and the bf16 graph gives finite results of the right shapes, near the
    float32 ones, on the same weights."""
    cfg = GimConfig(dkm=DKMConfig(**TINY))
    bf16 = Matcher("gim_dkm", GimConfig(dkm=DKMConfig(
        **TINY, dtype="bfloat16")), state_dict=port.state_dict(),
        device="cpu")
    assert all(v.dtype == torch.float32 for v in bf16.model.parameters())
    img0, img1, _, _ = _images(2, False)
    x0, x1 = torch.from_numpy(img0), torch.from_numpy(img1)
    r, r2 = (match_fn("gim_dkm", cfg, port, x0, x1, device="cpu")
             for _ in range(2))
    assert r.kpts0.shape == (1, 64, 2) and torch.isfinite(r.kpts1).all()
    assert torch.equal(r.kpts0, r2.kpts0) and torch.equal(r.valid, r2.valid)
    with torch.inference_mode():
        w32, c32 = port(x0, x1)
        w16, c16 = bf16.model(x0, x1)
    assert w16.dtype == torch.float32 and torch.isfinite(w16).all()
    assert float((w16 - w32).abs().amax(-1).le(0.05).float().mean()) > 0.9
    assert float((c16 - c32).abs().le(0.05).float().mean()) > 0.9
