"""Checkpoint loading for the PyTorch port.

Counterpart of `gim_tpu/weights/port.py`. The port's parameter names are
the reference torch state-dict keys, so a reference checkpoint loads with
`load_state_dict` after the same prefix stripping (`normalize_gim_loftr`,
port.py:152-161; `normalize_gim_roma`, port.py:328-329). gim_roma's
DINOv2 trunk is not in its checkpoint: it loads from the hub file
`dinov2_vitl14_pretrain.pth` beside it (`gim_tpu/api.py:103-110`) and
sits under `dinov2.` in the port's model.

`loftr_state_dict_from_jax` and `roma_state_dict_from_jax` are the exact
inverses of the JAX package's `port_loftr` and `port_roma` +
`port_dinov2`: they turn a `{"params", "batch_stats"}` tree of numpy
arrays into the port's state dicts, so both packages can run on the same
weights.
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

    def raw(self, fpath: str, tkey: str):
        self._put(tkey, self.params.pop(fpath))

    def count(self, path_fmt: str) -> int:
        """How many of path_fmt.format(0), .format(1), ... the tree holds."""
        n = 0
        while path_fmt.format(n) in self.params:
            n += 1
        return n

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


# ---------------------------------------------------------------------------
# gim_roma + DINOv2
# ---------------------------------------------------------------------------

DINOV2_PREFIX = "dinov2."
# torchvision vgg19_bn conv layer indices within features[:40]
VGG19_CONV_IDX = (0, 3, 7, 10, 14, 17, 20, 23, 27, 30, 33, 36)
ROMA_SCALES = ("16", "8", "4", "2", "1")


def normalize_gim_roma(sd: dict) -> dict:
    """Strip a gim_roma checkpoint's 'model.' prefix
    (gim_tpu/weights/port.py:328-329, ref trainer/lightning.py:68-99)."""
    return {k[len("model."):] if k.startswith("model.") else k: v
            for k, v in sd.items()}


def load_dinov2_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The DINOv2 hub checkpoint's tensors, without `mask_token` (unused
    at inference; `port_dinov2` drops it too)."""
    return {k: v for k, v in load_torch_state_dict(path).items()
            if k != "mask_token"}


def roma_model_state_dict(roma_sd: Mapping, dinov2_sd: Mapping | None
                          ) -> dict[str, torch.Tensor]:
    """The port's RoMaMatcher state dict from a gim_roma checkpoint's state
    dict and the DINOv2 one (None: the trunk's keys are left out)."""
    out = dict(normalize_gim_roma(dict(roma_sd)))
    for k, v in (dinov2_sd or {}).items():
        out[DINOV2_PREFIX + k] = v
    return out


def split_roma_state_dict(sd: Mapping) -> tuple[dict, dict]:
    """The port's RoMaMatcher state dict -> (the gim_roma checkpoint's
    keys, the DINOv2 hub checkpoint's keys)."""
    roma = {k: v for k, v in sd.items() if not k.startswith(DINOV2_PREFIX)}
    dino = {k[len(DINOV2_PREFIX):]: v for k, v in sd.items()
            if k.startswith(DINOV2_PREFIX)}
    return roma, dino


def _vit_block_from_jax(u: _FromJax, f: str, t: str, layerscale: bool):
    u.layernorm(f"{f}/norm1", f"{t}.norm1")
    u.dense(f"{f}/attn/qkv", f"{t}.attn.qkv")
    u.dense(f"{f}/attn/proj", f"{t}.attn.proj")
    if layerscale:
        u.raw(f"{f}/ls1/gamma", f"{t}.ls1.gamma")
    u.layernorm(f"{f}/norm2", f"{t}.norm2")
    u.dense(f"{f}/mlp/fc1", f"{t}.mlp.fc1")
    u.dense(f"{f}/mlp/fc2", f"{t}.mlp.fc2")
    if layerscale:
        u.raw(f"{f}/ls2/gamma", f"{t}.ls2.gamma")


def _refiner_from_jax(u: _FromJax, f: str, t: str, hidden_blocks: int):
    for fb, tb in [("block1", "block1")] + [
            (f"hidden_{i}", f"hidden_blocks.{i}") for i in range(hidden_blocks)]:
        u.conv(f"{f}/{fb}_conv1", f"{t}.{tb}.0")
        u.batchnorm(f"{f}/{fb}_bn", f"{t}.{tb}.1")
        u.conv(f"{f}/{fb}_conv2", f"{t}.{tb}.3")
    u.conv(f"{f}/out_conv", f"{t}.out_conv")
    u.conv(f"{f}/disp_emb", f"{t}.disp_emb")


def roma_state_dict_from_jax(variables: Mapping
                             ) -> tuple[OrderedDict, OrderedDict]:
    """JAX RoMaMatcher variables -> (gim_roma state dict, DINOv2 state
    dict), the inverse of `gim_tpu.weights.port.port_roma` +
    `port_dinov2`. The decoder's and the trunk's depths are read off the
    tree. Raises if a leaf of the tree is left over."""
    u = _FromJax(variables)
    for j, idx in enumerate(VGG19_CONV_IDX):
        u.conv(f"vgg/conv_{j}", f"encoder.cnn.layers.{idx}")
        u.batchnorm(f"vgg/bn_{j}", f"encoder.cnn.layers.{idx + 1}")
    dec = "decoder/coordinate_decoder"
    for i in range(u.count(dec + "/block_{}/norm1/scale")):
        _vit_block_from_jax(u, f"{dec}/block_{i}",
                            f"decoder.embedding_decoder.blocks.{i}", False)
    u.dense(f"{dec}/to_out", "decoder.embedding_decoder.to_out")
    u.conv("decoder/gp_16/pos_conv", "decoder.gps.16.pos_conv")
    for s in ROMA_SCALES:
        u.conv(f"decoder/proj_{s}_conv", f"decoder.proj.{s}.0")
        u.batchnorm(f"decoder/proj_{s}_bn", f"decoder.proj.{s}.1")
        _refiner_from_jax(u, f"decoder/refiner_{s}",
                          f"decoder.conv_refiner.{s}",
                          u.count(f"decoder/refiner_{s}/hidden_"
                                  + "{}_conv1/kernel"))
    roma_sd, u.sd = u.sd, OrderedDict()
    u.raw("dino/cls_token", "cls_token")
    u.raw("dino/pos_embed", "pos_embed")
    u.conv("dino/patch_embed", "patch_embed.proj")
    for i in range(u.count("dino/block_{}/norm1/scale")):
        _vit_block_from_jax(u, f"dino/block_{i}", f"blocks.{i}", True)
    u.layernorm("dino/norm", "norm")
    left = list(u.params) + [f"batch_stats/{k}" for k in u.stats]
    if left:
        raise ValueError(f"unmapped roma leaves: {left[:8]}")
    return roma_sd, u.sd
