"""gim_dkm's bf16 graph in gim_tpu_torch against the JAX package's bf16
graph on the CPU, at test_torch_dkm's tiny configuration and seeded
weights, in the ZEB protocol's input mode (content masks: the valid
rectangle resampled to 48 x 64).

Both sides run the same weights (the JAX package's tree from `port_dkm`,
loaded into the port), the port through `Matcher(...,
DKMConfig(dtype="bfloat16"))` as a user calls it, the JAX side under
`jax.jit` at highest matmul precision. bf16 rounds at other places in the
two frameworks, so the port is held to the JAX package's own
bf16-to-float32 gap on the same inputs, measured here: at the median,
the 90th and 99th percentile and the largest of the per-pixel
differences (warp: the largest over its 4 coordinates; certainty),
- the port's bf16 warp and certainty against the JAX package's bf16
  ones: at most twice JAX's gap (two graphs that each round away from
  the float32 one by that gap can lie twice as far apart);
- the port's bf16 graph against the JAX package's float32 one: at most
  1.5 times JAX's gap (the port is no less accurate than the JAX
  package's bf16 graph, beyond rounding noise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.config import DKMConfig as JDKMConfig
from gim_tpu.models.dkm import model as jm
from gim_tpu_torch.api import Matcher
from gim_tpu_torch.config import DKMConfig, GimConfig
from tests.test_torch_dkm import (TINY, jit_apply, port,  # noqa: F401
                                  variables)
from tests.test_torch_dkm_matcher import _model_inputs
from tests.test_torch_roma import _to_jax_tree

QUANTILES = (0.5, 0.9, 0.99, 1.0)


def _gaps(a, b):
    """Quantiles of the per-pixel differences of (warp, certainty)."""
    dw = np.abs(a[0] - b[0]).max(-1)
    dc = np.abs(a[1] - b[1])
    return np.quantile(dw, QUANTILES), np.quantile(dc, QUANTILES)


@pytest.fixture(scope="module")
def outputs(variables, port):  # noqa: F811
    inputs = _model_inputs(True)
    out = {}
    for dt in ("float32", "bfloat16"):
        w, c = jit_apply(jm.DKMMatcher(JDKMConfig(**TINY, dtype=dt)),
                         _to_jax_tree(variables),
                         *(jnp.asarray(a) for a in inputs))
        out["jax", dt] = (np.asarray(w, np.float32),
                          np.asarray(c, np.float32))
    bf16 = Matcher("gim_dkm", GimConfig(dkm=DKMConfig(
        **TINY, dtype="bfloat16")), state_dict=port.state_dict(),
        device="cpu")
    with torch.inference_mode():
        w, c = bf16.model(*(torch.from_numpy(a) for a in inputs))
    assert w.dtype == torch.float32 and w.shape == (1, 96, 256, 4)
    out["port", "bfloat16"] = (w.numpy(), c.numpy())
    return out


@pytest.mark.parametrize("ref,factor", [("bfloat16", 2.0),
                                        ("float32", 1.5)])
def test_dkm_bf16_within_jax_bf16_gap(outputs, ref, factor):
    jax_gap = _gaps(outputs["jax", "bfloat16"], outputs["jax", "float32"])
    got = _gaps(outputs["port", "bfloat16"], outputs["jax", ref])
    assert jax_gap[0][0] > 0 and jax_gap[1][0] > 0   # bf16 did round
    for name, g, j in zip(("warp", "certainty"), got, jax_gap):
        assert (g <= factor * j).all(), (name, ref, g, j)
