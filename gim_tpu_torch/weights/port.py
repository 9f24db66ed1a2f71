"""Checkpoint loading for the PyTorch port.

Counterpart of `gim_tpu/weights/port.py`. The port's parameter names are
the reference torch state-dict keys, so a reference checkpoint loads with
`load_state_dict` after the same prefix stripping (`normalize_gim_loftr`,
port.py:152-161; `normalize_gim_roma`, port.py:328-329). gim_roma's
DINOv2 trunk is not in its checkpoint: it loads from the hub file
`dinov2_vitl14_pretrain.pth` beside it (`gim_tpu/api.py:103-110`) and
sits under `dinov2.` in the port's model. A gim_dkm checkpoint's keys
carry `model.`, and it holds torchvision's unused `encoder.net.fc`
(`port.py:258-261`).

A gim_lightglue checkpoint holds SuperPoint under `superpoint.` and
LightGlue under `model.`, with the reference's early-exit heads, which
are dropped (`port.py:99-145`).

`loftr_state_dict_from_jax`, `roma_state_dict_from_jax`,
`dkm_state_dict_from_jax`, `superpoint_state_dict_from_jax` and
`lightglue_state_dict_from_jax` are the exact inverses of the JAX
package's `port_loftr`, `port_roma` + `port_dinov2`, `port_dkm`,
`port_superpoint` and `port_lightglue`: they turn a
`{"params", "batch_stats"}` tree of numpy arrays into the port's state
dicts, so both packages can run on the same weights.
"""

from __future__ import annotations

import os
import re
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


def reference_state_dict(name: str, model: torch.nn.Module
                         ) -> dict[str, torch.Tensor]:
    """A head's model state dict in the reference checkpoint layout, on the
    CPU: gim_lightglue's SuperPoint under 'superpoint.' and its LightGlue
    under 'model.' (ref demo.py:378-395); every other head's keys under
    'model.', as the reference's Lightning checkpoints hold them (gim_roma
    keeps its DINOv2 trunk under 'model.dinov2.')."""
    out = {}
    for k, v in model.state_dict().items():
        if name == "gim_lightglue":
            head, _, rest = k.partition(".")
            k = f"superpoint.{rest}" if head == "superpoint" else \
                f"model.{rest}"
        else:
            k = f"model.{k}"
        out[k] = v.detach().cpu()
    return out


def checkpoint_state_dict(name: str, sd: Mapping, n_layers: int = 9,
                          dinov2_sd: Mapping | None = None) -> dict:
    """A reference-layout checkpoint's state dict of head `name` as the
    port's model of that head loads it (`n_layers`: gim_lightglue's depth;
    `dinov2_sd`: gim_roma's hub trunk, which replaces the checkpoint's)."""
    if name == "gim_roma":
        return roma_model_state_dict(sd, dinov2_sd)
    if name == "gim_dkm":
        return dkm_checkpoint_state_dict(sd)
    if name == "gim_lightglue":
        return lightglue_checkpoint_state_dict(sd, n_layers)
    return loftr_checkpoint_state_dict(sd)


def write_training_checkpoint(path: str, model: torch.nn.Module,
                              optimizer, scheduler, step: int,
                              name: str = "gim_loftr") -> None:
    """A training checkpoint of head `name`: the model's state dict in the
    reference layout under 'state_dict' (`reference_state_dict`, so that
    `checkpoint_state_dict` and `Matcher.from_checkpoint` read it), plus
    the optimizer's and scheduler's state and the step count. Written to a
    temporary file and renamed, so a cut run leaves no partial
    checkpoint."""
    sd = reference_state_dict(name, model)
    tmp = f"{path}.tmp"
    torch.save({"state_dict": sd, "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict(), "step": step}, tmp)
    os.replace(tmp, path)


CKPT_PATTERN = re.compile(r"step_(\d+)\.ckpt$")


def checkpoint_name(step: int) -> str:
    return f"step_{step:08d}.ckpt"


def latest_checkpoint(path: str) -> str | None:
    """`path` if it is a file, else the checkpoint of the largest step in
    the directory `path` (None if it holds none)."""
    if os.path.isfile(path):
        return path
    if not os.path.isdir(path):
        return None
    steps = [(int(m.group(1)), f) for f in os.listdir(path)
             if (m := CKPT_PATTERN.search(f))]
    return os.path.join(path, max(steps)[1]) if steps else None


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
        self.has_stats = "batch_stats" in variables
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
        if not self.has_stats:          # a params-shaped tree
            return
        self._put(f"{tkey}.running_mean", self.stats.pop(f"{fpath}/mean"))
        self._put(f"{tkey}.running_var", self.stats.pop(f"{fpath}/var"))
        self.sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0)


def _trunk_from_jax(u: _FromJax, fprefix: str, tprefix: str,
                    num_layers: int = 3):
    u.conv(f"{fprefix}/conv1", f"{tprefix}.conv1")
    u.batchnorm(f"{fprefix}/bn1", f"{tprefix}.bn1")
    for li, blocks in (("1", 3), ("2", 4), ("3", 6), ("4", 3))[:num_layers]:
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
    of the tree is left over.

    Any params-shaped tree maps too (gradients, optax's `mu` and `nu`):
    pass `{"params": tree}`; without "batch_stats" the state dict holds
    no running statistics, and each leaf sits under its parameter's
    name."""
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
    dict and the DINOv2 one, whose keys replace any trunk keys the
    checkpoint holds (a training checkpoint's 'model.dinov2.'); None: the
    trunk's keys are the checkpoint's, if it has them."""
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


# ---------------------------------------------------------------------------
# gim_dkm
# ---------------------------------------------------------------------------

DKM_DROP = "encoder.net.fc."
DKM_SCALES = ("16", "8", "4", "2", "1")


def dkm_checkpoint_state_dict(sd: Mapping) -> dict[str, torch.Tensor]:
    """A reference gim_dkm checkpoint's state dict as the port's DKMMatcher
    loads it: 'model.' stripped, `encoder.net.fc.*` dropped
    (gim_tpu/weights/port.py:258-261)."""
    out = {}
    for k, v in sd.items():
        k = k[len("model."):] if k.startswith("model.") else k
        if not k.startswith(DKM_DROP):
            out[k] = v
    return out


def dkm_state_dict_from_jax(variables: Mapping
                            ) -> OrderedDict[str, torch.Tensor]:
    """JAX DKMMatcher variables -> the port's DKMMatcher state dict (the
    inverse of `gim_tpu.weights.port.port_dkm`). Raises if a leaf of the
    tree is left over."""
    u = _FromJax(variables)
    _trunk_from_jax(u, "encoder", "encoder.net", num_layers=4)
    emb = "decoder.embedding_decoder"
    for s in ("32", "16"):
        f = f"decoder/dfn_{s}"
        u.conv(f"decoder/proj_{s}", f"decoder.proj.{s}")
        u.conv(f"decoder/gp_{s}/pos_conv", f"decoder.gps.{s}.pos_conv")
        u.conv(f"{f}/feat_input", f"{emb}.feat_input_modules.{s}")
        for rrb in ("rrb_d", "rrb_u"):
            u.conv(f"{f}/{rrb}/conv1", f"{emb}.{rrb}.{s}.conv1")
            u.conv(f"{f}/{rrb}/conv2", f"{emb}.{rrb}.{s}.conv2")
            u.batchnorm(f"{f}/{rrb}/bn", f"{emb}.{rrb}.{s}.bn")
            u.conv(f"{f}/{rrb}/conv3", f"{emb}.{rrb}.{s}.conv3")
        u.conv(f"{f}/cab/conv1", f"{emb}.cab.{s}.conv1")
        u.conv(f"{f}/cab/conv2", f"{emb}.cab.{s}.conv2")
        u.conv(f"{f}/terminal", f"{emb}.terminal_module.{s}")
    for s in DKM_SCALES:
        _refiner_from_jax(u, f"decoder/refiner_{s}",
                          f"decoder.conv_refiner.{s}",
                          u.count(f"decoder/refiner_{s}/hidden_"
                                  + "{}_conv1/kernel"))
    left = list(u.params) + [f"batch_stats/{k}" for k in u.stats]
    if left:
        raise ValueError(f"unmapped dkm leaves: {left[:8]}")
    return u.sd


# ---------------------------------------------------------------------------
# gim_lightglue
# ---------------------------------------------------------------------------

SUPERPOINT_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a",
                    "conv3b", "conv4a", "conv4b", "convPa", "convPb",
                    "convDa", "convDb")
# the reference's early-exit heads, which the static-depth forward never
# runs (gim_tpu/weights/port.py:116-145 drops them; the final
# log_assignment head is kept)
LIGHTGLUE_DROP = ("log_assignment.", "token_confidence.",
                  "confidence_thresholds")


def split_gim_lightglue(sd: Mapping) -> tuple[dict, dict]:
    """A gim_lightglue checkpoint -> (SuperPoint's, LightGlue's) state
    dicts, by their `superpoint.` and `model.` prefixes
    (gim_tpu/weights/port.py:99-102; ref demo.py:378-395)."""
    def strip(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}

    return strip("superpoint."), strip("model.")


def lightglue_checkpoint_state_dict(sd: Mapping, n_layers: int = 9
                                    ) -> dict[str, torch.Tensor]:
    """A reference gim_lightglue checkpoint's state dict as the port's
    gim_lightglue module (`superpoint.*`, `lightglue.*`) loads it
    strictly: the early-exit heads (`token_confidence.*`, every
    `log_assignment.*` but the last layer's, `confidence_thresholds`)
    dropped, as `port_lightglue` drops them."""
    sp_sd, lg_sd = split_gim_lightglue(sd)
    last = f"log_assignment.{n_layers - 1}."
    out = {f"superpoint.{k}": v for k, v in sp_sd.items()}
    out.update({f"lightglue.{k}": v for k, v in lg_sd.items()
                if k.startswith(last)
                or not any(p in k for p in LIGHTGLUE_DROP)})
    return out


def superpoint_state_dict_from_jax(variables: Mapping
                                   ) -> OrderedDict[str, torch.Tensor]:
    """JAX SuperPointNet variables -> the port's SuperPointNet state dict
    (the inverse of `gim_tpu.weights.port.port_superpoint`). Raises if a
    leaf of the tree is left over."""
    u = _FromJax(variables)
    for name in SUPERPOINT_CONVS:
        u.conv(name, name)
    if u.params:
        raise ValueError(f"unmapped superpoint leaves: {list(u.params)[:8]}")
    return u.sd


def lightglue_state_dict_from_jax(variables: Mapping, n_layers: int
                                  ) -> OrderedDict[str, torch.Tensor]:
    """JAX LightGlue variables -> the port's LightGlue state dict (the
    inverse of `gim_tpu.weights.port.port_lightglue`). Raises if a leaf of
    the tree is left over."""
    u = _FromJax(variables)
    u.dense("posenc/Wr", "posenc.Wr")
    if u.has("input_proj/kernel"):
        u.dense("input_proj", "input_proj")
    for i in range(n_layers):
        for f, t, projs in ((f"self_{i}", f"transformers.{i}.self_attn",
                             ("Wqkv", "out_proj")),
                            (f"cross_{i}", f"transformers.{i}.cross_attn",
                             ("to_qk", "to_v", "to_out"))):
            for p in projs:
                u.dense(f"{f}/{p}", f"{t}.{p}")
            u.dense(f"{f}/ffn/fc1", f"{t}.ffn.0")
            u.layernorm(f"{f}/ffn/norm", f"{t}.ffn.1")
            u.dense(f"{f}/ffn/fc2", f"{t}.ffn.3")
    la = f"log_assignment.{n_layers - 1}"
    u.dense("assign_final/final_proj", f"{la}.final_proj")
    u.dense("assign_final/matchability", f"{la}.matchability")
    if u.params:
        raise ValueError(f"unmapped lightglue leaves: {list(u.params)[:8]}")
    return u.sd
