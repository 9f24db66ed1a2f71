"""gim_loftr's bf16 graph in gim_tpu_torch against the JAX package's bf16
graph on the CPU, at test_torch_loftr's weights and sizes.

The port stores every gim_loftr parameter in bf16 (`api._model_dtype`),
BatchNorm statistics and norm affines included, where flax keeps those in
float32; each layer computes in bf16 in both. The tolerances are tied to
the JAX package's own bf16 error against its float32 graph on the same
inputs (the backbone's coarse output: 1.05 % of its largest magnitude):
- the backbone's coarse output: max abs difference at most 2.1 % of the
  output's largest magnitude, twice JAX's own bf16 gap (1.27 % measured,
  so the norm parameters need no float32 copy in the port);
- the whole matcher on an identical pair: (i, j) sets agree on >= 90 %
  of valid slots; on the agreed slots mconf within 0.05 and the fine
  keypoints within 0.5 px (a 2 px fine cell: bf16 moves the expectation
  by a fraction of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gim_tpu.api import match_fn as j_match_fn
from gim_tpu.config import GimConfig as JGimConfig
from gim_tpu.config import LoFTRConfig as JLoFTRConfig
from gim_tpu.models.loftr import model as jmodel
from gim_tpu.models.loftr.backbone import ResNetFPN as JResNetFPN
from gim_tpu_torch.api import match_fn
from gim_tpu_torch.config import GimConfig, LoFTRConfig
from tests.test_torch_loftr import MAXM, _pair, _port_model, make_variables

HIGH = jax.default_matmul_precision("highest")


def test_backbone_bf16_against_jax_bf16():
    variables = make_variables()
    model = _port_model(variables, LoFTRConfig(dtype="bfloat16")).to(
        torch.bfloat16)
    x = np.random.default_rng(1).random((2, 3, 64, 96)).astype(np.float32)
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x).bfloat16())[0]
    got = got.float().permute(0, 2, 3, 1).numpy()
    bb = {"params": variables["params"]["backbone"],
          "batch_stats": variables["batch_stats"]["backbone"]}
    xj = jnp.transpose(jnp.asarray(x), (0, 2, 3, 1))
    with HIGH:
        want = np.asarray(JResNetFPN(dtype="bfloat16").apply(bb, xj)[0],
                          np.float32)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 0.021, err            # twice JAX's bf16-to-f32 gap


def test_match_fn_bf16_against_jax_bf16():
    variables = make_variables()
    kw = dict(max_matches=MAXM, match_threshold=0.0, dtype="bfloat16")
    img0, img1, _, _ = _pair(False)
    scale = np.array([[1.5, 2.0]], np.float32)
    jcfg = JGimConfig(loftr=JLoFTRConfig(**kw))

    def jax_side(v, *args):
        return (j_match_fn("gim_loftr", jcfg, v, *args),
                jmodel.LoFTRMatcher(jcfg.loftr).apply(v, *args))

    with HIGH:
        want, want_out = jax.jit(jax_side)(
            jax.tree_util.tree_map(jnp.asarray, variables),
            jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(scale),
            jnp.asarray(scale))
    cfg = GimConfig(loftr=LoFTRConfig(**kw))
    model = _port_model(variables, cfg.loftr).to(torch.bfloat16)
    args = (torch.from_numpy(img0), torch.from_numpy(img1),
            torch.from_numpy(scale), torch.from_numpy(scale))
    got = match_fn("gim_loftr", cfg, model, *args, device="cpu")
    with torch.inference_mode():
        got_out = model(*(a.float() for a in args))

    def slots(valid, i, j):
        return {(a, b): s for s, (a, b, v) in enumerate(zip(i, j, valid))
                if v}

    jset = slots(np.asarray(want.valid[0]), np.asarray(want_out["i_ids"][0]),
                 np.asarray(want_out["j_ids"][0]))
    tset = slots(got.valid[0].numpy(), got_out["i_ids"][0].numpy(),
                 got_out["j_ids"][0].numpy())
    assert len(jset) >= 8
    agreed = sorted(set(jset) & set(tset))
    assert len(agreed) >= 0.9 * len(set(jset) | set(tset))
    js = [jset[p] for p in agreed]
    ts = [tset[p] for p in agreed]
    np.testing.assert_allclose(got.conf[0].numpy()[ts],
                               np.asarray(want.conf[0])[js], rtol=0,
                               atol=0.05)
    for k in ("kpts0", "kpts1"):
        np.testing.assert_allclose(getattr(got, k)[0].numpy()[ts],
                                   np.asarray(getattr(want, k)[0])[js],
                                   rtol=0, atol=0.5, err_msg=k)
