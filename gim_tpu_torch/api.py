"""High-level matcher API of the PyTorch port.

Port of `gim_tpu/api.py:27-140` and `:198-263`: build a matcher by name,
feed a batch of image pairs, get a `MatchResult` of fixed-shape tensors
with a validity mask. `gim_loftr` and `gim_roma` are ported; the other
heads raise `NotImplementedError` naming the slice of the port
(ROADMAP.md) that brings them.

Entry points run on the GPU (`device="cuda"`, the default) unless the
caller passes `device="cpu"`, and raise if CUDA is asked for and absent.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from gim_tpu_torch import config as C
from gim_tpu_torch.models.common import init_weights
from gim_tpu_torch.models.dkm.model import sample_matches
from gim_tpu_torch.models.loftr import LoFTRMatcher
from gim_tpu_torch.models.roma import RoMaMatcher
from gim_tpu_torch.utils.device import resolve_device, set_tf32, torch_dtype
from gim_tpu_torch.weights import port


@dataclass
class MatchResult:
    """Fixed-shape match set for a batch of pairs."""

    kpts0: torch.Tensor   # (B, M, 2) pixels in image0 (resized frame)
    kpts1: torch.Tensor   # (B, M, 2)
    conf: torch.Tensor    # (B, M)
    valid: torch.Tensor   # (B, M) bool

    def numpy_pair(self, b: int = 0):
        v = self.valid[b].cpu().numpy()
        return (self.kpts0[b].cpu().numpy()[v], self.kpts1[b].cpu().numpy()[v],
                self.conf[b].cpu().numpy()[v])


MODEL_ZOO = ("gim_lightglue", "gim_loftr", "gim_dkm", "gim_roma", "root_sift")
_LATER_SLICE = {"gim_dkm": 3, "gim_lightglue": 5, "root_sift": 6}
ROMA_SAMPLE_SEED = 11   # gim_tpu/api.py:247 samples from PRNGKey(11)


def _check_name(name: str):
    if name not in MODEL_ZOO:
        raise ValueError(f"unknown model {name}; choose from {MODEL_ZOO}")
    if name in _LATER_SLICE:
        raise NotImplementedError(
            f"{name} is not ported to gim_tpu_torch yet; it comes with "
            f"slice {_LATER_SLICE[name]} of the port (ROADMAP.md)")


def build_model(name: str, cfg: C.GimConfig) -> torch.nn.Module:
    _check_name(name)
    if name == "gim_roma":
        return RoMaMatcher(cfg.roma)
    return LoFTRMatcher(cfg.loftr)


def _model_dtype(name: str, cfg: C.GimConfig) -> torch.dtype:
    """The dtype the parameters are stored in: gim_loftr stores them in
    its compute dtype; gim_roma keeps them float32 and casts at each
    layer, as the JAX package does (models/common.py)."""
    return torch.float32 if name == "gim_roma" else torch_dtype(
        cfg.loftr.dtype)


def _load(model: torch.nn.Module, name: str, state_dict: dict):
    """Load `state_dict` strictly; for gim_roma the DINOv2 keys may be
    absent (a checkpoint without its side file), and the trunk then keeps
    the weights it has."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    if name == "gim_roma":
        missing = [k for k in missing
                   if not k.startswith(port.DINOV2_PREFIX)]
    if missing or unexpected:
        raise RuntimeError(f"{name} state dict: missing {missing[:8]}, "
                           f"unexpected {unexpected[:8]}")


class Matcher:
    """Holds a model on its device; `match` runs it on a batch of pairs.

    Weights: seeded random weights from `generator` (default: a CPU
    generator seeded 0), then `state_dict` (the reference key layout) if
    given. Turns TF32 off for float32 matmuls and convolutions
    (utils/device.py).
    """

    def __init__(self, name: str, cfg: C.GimConfig | None = None,
                 state_dict: dict | None = None,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.name = name
        self.cfg = cfg or C.GimConfig()
        set_tf32(False)
        model = build_model(name, self.cfg)
        init_weights(model, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        if state_dict is not None:
            _load(model, name, state_dict)
        self.model = model.to(device=self.device,
                              dtype=_model_dtype(name, self.cfg)).eval()

    @classmethod
    def from_checkpoint(cls, name: str, ckpt_path: str,
                        cfg: C.GimConfig | None = None,
                        device: str | torch.device = "cuda") -> "Matcher":
        """Build from a reference-layout torch checkpoint (key prefixes
        stripped as ref trainer/lightning.py:68-99 does). gim_roma also
        loads `dinov2_vitl14_pretrain.pth` from the checkpoint's directory
        where it is (gim_tpu/api.py:103-110); without it the trunk keeps
        seeded random weights."""
        _check_name(name)
        resolve_device(device)
        raw = port.load_torch_state_dict(ckpt_path)
        if name == "gim_roma":
            side = os.path.join(os.path.dirname(ckpt_path),
                                "dinov2_vitl14_pretrain.pth")
            dino = (port.load_dinov2_state_dict(side)
                    if os.path.exists(side) else None)
            sd = port.roma_model_state_dict(raw, dino)
        else:
            sd = port.loftr_checkpoint_state_dict(raw)
        return cls(name, cfg, state_dict=sd, device=device)

    def match(self, image0, image1, scale0=None, scale1=None, mask0=None,
              mask1=None, generator: torch.Generator | None = None
              ) -> MatchResult:
        """image0/1: (B, 3, H, W) float [0,1] (resized/padded frame).
        scale: (B, 2) [w/w', h/h'] to map back to original pixels;
        mask: (B, H, W) bool content masks; generator: gim_roma's match
        sampling (see `match_fn`)."""
        return match_fn(self.name, self.cfg, self.model, image0, image1,
                        scale0, scale1, mask0, mask1, device=self.device,
                        generator=generator)


def match_fn(name: str, cfg: C.GimConfig, model: torch.nn.Module, image0,
             image1, scale0=None, scale1=None, mask0=None, mask1=None, *,
             device: str | torch.device = "cuda",
             generator: torch.Generator | None = None,
             sample_noise=None) -> MatchResult:
    """Run `model` (built by `build_model`, on `device`) on a batch of
    pairs. Inputs are moved to `device`; missing scales are ones.

    gim_roma samples its matches at random: from `generator` (default: a
    generator on `device` seeded 11 at each call, so a call is
    reproducible as the JAX package's is), or from `sample_noise`, one
    (g1, g2) pair of Gumbel draws per pair of images
    (`models/dkm/model.py:sample_matches`)."""
    _check_name(name)
    dev = resolve_device(device)
    B = image0.shape[0]

    def put(t, dtype=None):
        return None if t is None else torch.as_tensor(t).to(dev, dtype)

    scale0 = (put(scale0, torch.float32) if scale0 is not None
              else torch.ones((B, 2), device=dev))
    scale1 = (put(scale1, torch.float32) if scale1 is not None
              else torch.ones((B, 2), device=dev))
    image0 = put(image0, torch.float32)
    image1 = put(image1, torch.float32)
    mask0 = put(mask0, torch.bool)
    mask1 = put(mask1, torch.bool)
    with torch.inference_mode():
        if name == "gim_roma":
            if generator is None and sample_noise is None:
                generator = torch.Generator(dev).manual_seed(ROMA_SAMPLE_SEED)
            return _match_roma(cfg, model, image0, image1, scale0, scale1,
                               mask0, mask1, generator, sample_noise)
        out = model(image0, image1, scale0, scale1, mask0, mask1)
    return MatchResult(out["mkpts0_f"], out["mkpts1_f"], out["mconf"],
                       out["valid"])


def _mask_extent(mask, H: int, W: int):
    """(B, 2) (w_frac, h_frac) valid-content fraction of each canvas
    (gim_tpu/api.py:218-224)."""
    if mask is None:
        return None
    h = mask.sum(1).amax(-1).float()
    w = mask.sum(2).amax(-1).float()
    return torch.stack([w / W, h / H], dim=-1)


def _match_roma(cfg: C.GimConfig, model, image0, image1, scale0, scale1,
                mask0, mask1, generator, sample_noise) -> MatchResult:
    """RoMa dense warp -> balanced sampling -> original-frame keypoints
    (gim_tpu/api.py:227-263). With `distort_aspect` (the reference ZEB
    protocol) the valid canvas rectangle is resampled straight to RoMa's
    square model resolution and the normalized output coordinates map
    back to the rectangle; otherwise the whole square canvas is used."""
    c = cfg.roma
    B, _, S, _ = image0.shape
    distort = c.distort_aspect and mask0 is not None
    e0 = _mask_extent(mask0, S, S) if distort else None
    e1 = _mask_extent(mask1, S, S) if distort else None
    warp, cert = model(image0, image1, e0, e1)
    samples = [sample_matches(
        warp[b], cert[b], c.num_samples, c.sample_thresh, c.sample_mode,
        generator=generator,
        noise=None if sample_noise is None else sample_noise[b])
        for b in range(B)]
    matches, conf, valid = (torch.stack(t) for t in zip(*samples))
    if distort:
        wh0 = e0[:, None, :] * S        # (B, 1, 2) valid rect (w, h)
        wh1 = e1[:, None, :] * S
    else:
        wh0 = wh1 = torch.full((B, 1, 2), float(S), device=warp.device)
    k0 = wh0 * (matches[..., 0:2] + 1) / 2 * scale0[:, None, :]
    k1 = wh1 * (matches[..., 2:4] + 1) / 2 * scale1[:, None, :]
    valid = valid & (conf > 0)
    return MatchResult(k0, k1, torch.where(valid, conf, 0.0), valid)
