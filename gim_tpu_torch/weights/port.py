"""Checkpoint loading for the PyTorch port.

Counterpart of `gim_tpu/weights/port.py`. The port's parameter names are
the reference torch state-dict keys, so a reference checkpoint loads with
`load_state_dict` after the same prefix stripping (`normalize_gim_loftr`,
port.py:152-161). `loftr_state_dict_from_jax` is the exact inverse of the
JAX package's `port_loftr`: it turns a `{"params", "batch_stats"}` tree of
numpy arrays into the port's state dict, so both packages can run on the
same weights.
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import Mapping

import numpy as np
import torch

# keys of a gim_loftr checkpoint that hold no weights of the model
LOFTR_DROP = ("coarse_matching.", "fine_matching.", "pos_encoding.")


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference checkpoint's tensors on the CPU ('state_dict' unwrapped)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def normalize_gim_loftr(sd: dict) -> dict:
    """Strip the ckpt's 'model.'/'matcher.' prefixes
    (ref networks/loftr/loftr.py:93-99)."""
    out = {}
    for k, v in sd.items():
        for p in ("model.", "matcher."):
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def loftr_checkpoint_state_dict(sd: dict) -> dict:
    """A reference gim_loftr checkpoint's state dict, as the port's
    LoFTRMatcher loads it with strict=True."""
    return {k: v for k, v in normalize_gim_loftr(sd).items()
            if not k.startswith(LOFTR_DROP)}


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


class _FromJax:
    """Pops flax leaves by path into torch keys; tracks leftovers."""

    def __init__(self, variables: Mapping):
        self.params = _flatten(variables.get("params", {}))
        self.stats = _flatten(variables.get("batch_stats", {}))
        self.sd: OrderedDict[str, torch.Tensor] = OrderedDict()

    def _put(self, key: str, arr: np.ndarray):
        self.sd[key] = torch.from_numpy(np.ascontiguousarray(arr))

    def has(self, path: str) -> bool:
        return path in self.params

    def conv(self, fpath: str, tkey: str):
        # flax HWIO -> torch OIHW
        self._put(f"{tkey}.weight",
                  np.transpose(self.params.pop(f"{fpath}/kernel"), (3, 2, 0, 1)))
        if f"{fpath}/bias" in self.params:
            self._put(f"{tkey}.bias", self.params.pop(f"{fpath}/bias"))

    def dense(self, fpath: str, tkey: str):
        # flax (in, out) -> torch (out, in)
        self._put(f"{tkey}.weight", self.params.pop(f"{fpath}/kernel").T)
        if f"{fpath}/bias" in self.params:
            self._put(f"{tkey}.bias", self.params.pop(f"{fpath}/bias"))

    def layernorm(self, fpath: str, tkey: str):
        self._put(f"{tkey}.weight", self.params.pop(f"{fpath}/scale"))
        self._put(f"{tkey}.bias", self.params.pop(f"{fpath}/bias"))

    def batchnorm(self, fpath: str, tkey: str):
        self._put(f"{tkey}.weight", self.params.pop(f"{fpath}/scale"))
        self._put(f"{tkey}.bias", self.params.pop(f"{fpath}/bias"))
        self._put(f"{tkey}.running_mean", self.stats.pop(f"{fpath}/mean"))
        self._put(f"{tkey}.running_var", self.stats.pop(f"{fpath}/var"))
        self.sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0)


def _trunk_from_jax(u: _FromJax, fprefix: str, tprefix: str):
    u.conv(f"{fprefix}/conv1", f"{tprefix}.conv1")
    u.batchnorm(f"{fprefix}/bn1", f"{tprefix}.bn1")
    for li, blocks in (("1", 3), ("2", 4), ("3", 6)):
        for b in range(blocks):
            f = f"{fprefix}/layer{li}_{b}"
            t = f"{tprefix}.layer{li}.{b}"
            for c in ("1", "2", "3"):
                u.conv(f"{f}/conv{c}", f"{t}.conv{c}")
                u.batchnorm(f"{f}/bn{c}", f"{t}.bn{c}")
            if u.has(f"{f}/down_conv/kernel"):
                u.conv(f"{f}/down_conv", f"{t}.downsample.0")
                u.batchnorm(f"{f}/down_bn", f"{t}.downsample.1")


def _transformer_from_jax(u: _FromJax, fprefix: str, tprefix: str,
                          n_pairs: int):
    for i in range(n_pairs):
        for which, idx in (("self", 2 * i), ("cross", 2 * i + 1)):
            f = f"{fprefix}/{which}_{i}"
            t = f"{tprefix}.layers.{idx}"
            for p in ("q_proj", "k_proj", "v_proj", "merge"):
                u.dense(f"{f}/{p}", f"{t}.{p}")
            u.dense(f"{f}/mlp1", f"{t}.mlp.0")
            u.dense(f"{f}/mlp2", f"{t}.mlp.2")
            u.layernorm(f"{f}/norm1", f"{t}.norm1")
            u.layernorm(f"{f}/norm2", f"{t}.norm2")


def loftr_state_dict_from_jax(variables: Mapping, n_pairs_coarse: int = 4,
                              n_pairs_fine: int = 1
                              ) -> OrderedDict[str, torch.Tensor]:
    """JAX LoFTRMatcher variables -> the port's LoFTRMatcher state dict
    (the inverse of `gim_tpu.weights.port.port_loftr`). Raises if a leaf
    of the tree is left over."""
    u = _FromJax(variables)
    _trunk_from_jax(u, "backbone/encode", "backbone.encode")
    for name in ("layer3_outconv", "layer2_outconv", "layer1_outconv"):
        u.conv(f"backbone/{name}", f"backbone.{name}")
    for lo in ("layer2_outconv2", "layer1_outconv2"):
        u.conv(f"backbone/{lo}_0", f"backbone.{lo}.0")
        u.batchnorm(f"backbone/{lo}_bn", f"backbone.{lo}.1")
        u.conv(f"backbone/{lo}_1", f"backbone.{lo}.3")
    _transformer_from_jax(u, "loftr_coarse", "loftr_coarse", n_pairs_coarse)
    _transformer_from_jax(u, "loftr_fine", "loftr_fine", n_pairs_fine)
    if u.has("fine_preprocess/down_proj/kernel"):
        u.dense("fine_preprocess/down_proj", "fine_preprocess.down_proj")
        u.dense("fine_preprocess/merge_feat", "fine_preprocess.merge_feat")
    left = list(u.params) + [f"batch_stats/{k}" for k in u.stats]
    if left:
        raise ValueError(f"unmapped loftr leaves: {left[:8]}")
    return u.sd
