"""High-level matcher API of the PyTorch port.

Port of `gim_tpu/api.py:27-353`: build a matcher by name, feed a batch
of image pairs, get a `MatchResult` of fixed-shape tensors with a
validity mask. Every head of the JAX package's `MODEL_ZOO` is here:
`gim_lightglue` (SuperPoint and LightGlue), `gim_loftr`, `gim_dkm`,
`gim_roma` and `root_sift` (`gim_tpu/api.py:129-132`, `:143-176`: SIFT
on the host with cv2, the match on the device).

Entry points run on the GPU (`device="cuda"`, the default) unless the
caller passes `device="cpu"`, and raise if CUDA is asked for and absent.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from gim_tpu_torch import config as C
from gim_tpu_torch.models.common import init_weights
from gim_tpu_torch.models.dkm.model import (DKMMatcher, sample_matches,
                                            warp_to_pixels)
from gim_tpu_torch.models.lightglue import LightGlue
from gim_tpu_torch.models.loftr import LoFTRMatcher
from gim_tpu_torch.models.roma import RoMaMatcher
from gim_tpu_torch.models.superpoint import SuperPointNet, extract
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
# the JAX package samples from PRNGKey(11) (gim_roma, gim_tpu/api.py:250)
# and PRNGKey(7) (gim_dkm, :301), and places gim_lightglue's empty
# keypoint slots from PRNGKey(97) and PRNGKey(131) (:336-339)
SAMPLE_SEED = {"gim_roma": 11, "gim_dkm": 7}
PAD_SEEDS = (97, 131)


def _check_name(name: str):
    if name not in MODEL_ZOO:
        raise ValueError(f"unknown model {name}; choose from {MODEL_ZOO}")


def build_model(name: str, cfg: C.GimConfig) -> torch.nn.Module | None:
    """The head's module; None for root_sift, which has no weights."""
    _check_name(name)
    if name == "root_sift":
        return None
    if name == "gim_roma":
        return RoMaMatcher(cfg.roma)
    if name == "gim_dkm":
        return DKMMatcher(cfg.dkm)
    if name == "gim_lightglue":
        return torch.nn.ModuleDict({
            "superpoint": SuperPointNet(cfg.superpoint.descriptor_dim),
            "lightglue": LightGlue(cfg.lightglue)})
    return LoFTRMatcher(cfg.loftr)


def _model_dtype(name: str, cfg: C.GimConfig) -> torch.dtype:
    """The dtype the parameters are stored in: gim_loftr stores them in
    its compute dtype; gim_dkm and gim_roma keep them float32 and cast at
    each layer, as the JAX package does (models/common.py); gim_lightglue
    runs in float32 (the JAX package gives it no dtype)."""
    if name == "gim_loftr":
        return torch_dtype(cfg.loftr.dtype)
    return torch.float32


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
        if model is not None:
            init_weights(model, generator if generator is not None
                         else torch.Generator().manual_seed(0))
            if state_dict is not None:
                _load(model, name, state_dict)
            model = model.to(device=self.device,
                             dtype=_model_dtype(name, self.cfg)).eval()
        self.model = model

    @classmethod
    def from_checkpoint(cls, name: str, ckpt_path: str,
                        cfg: C.GimConfig | None = None,
                        device: str | torch.device = "cuda") -> "Matcher":
        """Build from a reference-layout torch checkpoint (key prefixes
        stripped as ref trainer/lightning.py:68-99 does; gim_lightglue's
        early-exit heads dropped, `weights/port.py`). gim_roma also
        loads `dinov2_vitl14_pretrain.pth` from the checkpoint's directory
        where it is (gim_tpu/api.py:103-110); without it the trunk keeps
        the checkpoint's weights (a training checkpoint holds them) or else
        seeded random ones. `ckpt_path` may also be a directory of the
        training CLI's checkpoints (`cli/train.py`, every head), of which
        the latest step loads, or a file of `cli/convert_ckpt.py`, which
        holds the model's state dict as it is."""
        _check_name(name)
        resolve_device(device)
        if name == "root_sift":
            raise NotImplementedError(f"{name} has no checkpoint")
        path = port.latest_checkpoint(ckpt_path)
        if path is None:
            raise FileNotFoundError(f"no checkpoint at {ckpt_path}")
        ckpt_path = path
        kind, raw = port.load_checkpoint(ckpt_path)
        if kind is not None:                  # cli/convert_ckpt.py's output
            if kind != name:
                raise ValueError(f"{ckpt_path} holds {kind}, not {name}")
            return cls(name, cfg, state_dict=raw, device=device)
        side = os.path.join(os.path.dirname(ckpt_path),
                            "dinov2_vitl14_pretrain.pth")
        dino = (port.load_dinov2_state_dict(side)
                if name == "gim_roma" and os.path.exists(side) else None)
        sd = port.checkpoint_state_dict(
            name, raw, (cfg or C.GimConfig()).lightglue.n_layers, dino)
        return cls(name, cfg, state_dict=sd, device=device)

    def match(self, image0, image1, scale0=None, scale1=None, mask0=None,
              mask1=None, generator: torch.Generator | None = None
              ) -> MatchResult:
        """image0/1: (B, 3, H, W) float [0,1] (resized/padded frame).
        scale: (B, 2) [w/w', h/h'] to map back to original pixels;
        mask: (B, H, W) bool content masks; generator: the match sampling
        of gim_dkm and gim_roma (see `match_fn`)."""
        return match_fn(self.name, self.cfg, self.model, image0, image1,
                        scale0, scale1, mask0, mask1, device=self.device,
                        generator=generator)


def match_fn(name: str, cfg: C.GimConfig, model: torch.nn.Module, image0,
             image1, scale0=None, scale1=None, mask0=None, mask1=None, *,
             device: str | torch.device = "cuda",
             generator: torch.Generator | None = None,
             sample_noise=None, pad_noise=None) -> MatchResult:
    """Run `model` (built by `build_model`, on `device`; None for
    root_sift) on a batch of pairs. Inputs are moved to `device`; missing
    scales are ones.

    gim_dkm and gim_roma sample their matches at random: from `generator`
    (default: a generator on `device` seeded at each call, 7 for gim_dkm
    and 11 for gim_roma, so a call is reproducible as the JAX package's
    is), or from `sample_noise`, one (g1, g2) pair of Gumbel draws per
    pair of images (`models/dkm/model.py:sample_matches`).

    gim_lightglue places the keypoint slots that SuperPoint leaves empty
    at random: from `pad_noise`, one (B, K, 2) tensor of uniforms in
    [0, 1) per image, or else from generators on `device` seeded 97 and
    131 at each call."""
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
    if name == "root_sift":
        return _match_root_sift(image0, image1, scale0, scale1)
    mask0 = put(mask0, torch.bool)
    mask1 = put(mask1, torch.bool)
    with torch.inference_mode():
        if name in SAMPLE_SEED:
            if generator is None and sample_noise is None:
                generator = torch.Generator(dev).manual_seed(SAMPLE_SEED[name])
            dense = _match_roma if name == "gim_roma" else _match_dkm
            return dense(cfg, model, image0, image1, scale0, scale1, mask0,
                         mask1, generator, sample_noise)
        if name == "gim_lightglue":
            return _match_lightglue(cfg, model, image0, image1, scale0,
                                    scale1, mask0, mask1, pad_noise)
        out = model(image0, image1, scale0, scale1, mask0, mask1)
    return MatchResult(out["mkpts0_f"], out["mkpts1_f"], out["mconf"],
                       out["valid"])


def _match_root_sift(image0, image1, scale0, scale1,
                     max_kpts: int = 6144) -> MatchResult:
    """Host cv2 SIFT + RootSIFT, then mutual-NN + ratio 0.8 on the images'
    device (`gim_tpu/api.py:143-176`); keypoints scaled to the original
    frame, one (max_kpts,) slot per keypoint of image0."""
    from gim_tpu_torch.models.root_sift import (detect_rootsift,
                                                match_rootsift, pad_to)

    dev = image0.device
    k0s, k1s, cs, vs = [], [], [], []
    for b in range(image0.shape[0]):
        rgb0, rgb1 = ((img[b].permute(1, 2, 0).cpu().numpy() * 255)
                      .astype(np.uint8) for img in (image0, image1))
        kp0, d0 = detect_rootsift(rgb0)
        kp1, d1 = detect_rootsift(rgb1)
        kp0p, v0 = pad_to(kp0, max_kpts)
        d0p, _ = pad_to(d0, max_kpts)
        kp1p, v1 = pad_to(kp1, max_kpts)
        d1p, _ = pad_to(d1, max_kpts)
        m, conf = match_rootsift(*(torch.from_numpy(a).to(dev) for a in (
            kp0p, d0p, v0, kp1p, d1p, v1)))
        kp0t = torch.from_numpy(kp0p).to(dev)
        kp1t = torch.from_numpy(kp1p).to(dev)
        sel = m >= 0
        k0s.append(kp0t * scale0[b][None])
        k1s.append(kp1t[m.clamp_min(0)] * scale1[b][None])
        cs.append(torch.where(sel, conf, 0.0))
        vs.append(sel)
    return MatchResult(torch.stack(k0s), torch.stack(k1s), torch.stack(cs),
                       torch.stack(vs))


def _content_wh(mask) -> torch.Tensor:
    """(B, 2) float (w, h) of the content of each (B, H, W) mask: its
    longest row and its longest column."""
    h = mask.sum(1).amax(-1).float()
    w = mask.sum(2).amax(-1).float()
    return torch.stack([w, h], dim=-1)


def _mask_extent(mask, H: int, W: int):
    """(B, 2) (w_frac, h_frac) valid-content fraction of each canvas
    (gim_tpu/api.py:218-224)."""
    if mask is None:
        return None
    wh = _content_wh(mask)
    return torch.stack([wh[:, 0] / W, wh[:, 1] / H], dim=-1)


def _match_lightglue(cfg: C.GimConfig, model, image0, image1, scale0,
                     scale1, mask0, mask1, pad_noise) -> MatchResult:
    """SuperPoint on both images, LightGlue, and each keypoint of image 0
    with its partner (gim_tpu/api.py:318-353; ref demo.py:472-511): one
    slot per keypoint of image 0, keypoints in the original frame."""
    B, _, H, W = image0.shape
    dev = image0.device

    def true_wh(mask):
        if mask is None:
            return torch.stack([torch.full((B,), float(W), device=dev),
                                torch.full((B,), float(H), device=dev)], -1)
        return _content_wh(mask)

    wh0, wh1 = true_wh(mask0), true_wh(mask1)
    if pad_noise is None:
        K = cfg.superpoint.max_num_keypoints
        pad_noise = [torch.rand((B, K, 2), device=dev,
                                generator=torch.Generator(dev).manual_seed(s))
                     for s in PAD_SEEDS]
    sp = model.superpoint
    p0 = extract(sp, image0, cfg.superpoint, wh0.flip(-1), pad_noise[0])
    p1 = extract(sp, image1, cfg.superpoint, wh1.flip(-1), pad_noise[1])
    out = model.lightglue(p0["keypoints"], p1["keypoints"],
                          p0["descriptors"], p1["descriptors"], wh0, wh1,
                          p0["valid"], p1["valid"])
    m0 = out["matches0"]                          # (B, K) partner or -1
    valid = m0 >= 0
    k0 = p0["keypoints"] * scale0[:, None, :]
    k1 = p1["keypoints"] * scale1[:, None, :]
    k1_m = torch.gather(k1, 1, m0.clamp_min(0)[..., None].expand(-1, -1, 2))
    conf = torch.where(valid, out["matching_scores0"], 0.0)
    return MatchResult(k0, k1_m, conf, valid)


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
    matches, conf, valid = _sample(c, warp, cert, generator, sample_noise)
    if distort:
        wh0 = e0[:, None, :] * S        # (B, 1, 2) valid rect (w, h)
        wh1 = e1[:, None, :] * S
    else:
        wh0 = wh1 = torch.full((B, 1, 2), float(S), device=warp.device)
    k0 = wh0 * (matches[..., 0:2] + 1) / 2 * scale0[:, None, :]
    k1 = wh1 * (matches[..., 2:4] + 1) / 2 * scale1[:, None, :]
    valid = valid & (conf > 0)
    return MatchResult(k0, k1, torch.where(valid, conf, 0.0), valid)


def _sample(c, warp, cert, generator, sample_noise):
    """Balanced sampling of each pair's dense warp; (matches (B, M, 4),
    conf (B, M), valid (B, M))."""
    samples = [sample_matches(
        warp[b], cert[b], c.num_samples, c.sample_thresh, c.sample_mode,
        generator=generator,
        noise=None if sample_noise is None else sample_noise[b])
        for b in range(warp.shape[0])]
    return (torch.stack(t) for t in zip(*samples))


def _match_dkm(cfg: C.GimConfig, model, image0, image1, scale0, scale1,
               mask0, mask1, generator, sample_noise) -> MatchResult:
    """DKM dense warp -> balanced sampling -> original-frame keypoints
    (gim_tpu/api.py:266-315). With `distort_aspect` and content masks (the
    reference ZEB protocol, ref trainer/lightning.py:134-156) the valid
    canvas rectangle is resampled to the model's (h_resized, w_resized),
    distorting its aspect; otherwise the square canvas is right-padded
    with zeros to the model's w:h aspect (the demo's approach, ref
    demo.py:420-428) and resized whole."""
    c = cfg.dkm
    B, _, S, _ = image0.shape
    distort = c.distort_aspect and mask0 is not None
    if distort:
        e0 = _mask_extent(mask0, S, S)
        e1 = _mask_extent(mask1, S, S)
        warp, cert = model(image0, image1, e0, e1)
    else:
        pad_w = max(int(round(S * c.w_resized / c.h_resized)) - S, 0)
        warp, cert = model(F.pad(image0, (0, pad_w)),
                           F.pad(image1, (0, pad_w)))
    matches, conf, valid = _sample(c, warp, cert, generator, sample_noise)
    if distort:
        k0 = e0[:, None, :] * S * (matches[..., 0:2] + 1) / 2
        k1 = e1[:, None, :] * S * (matches[..., 2:4] + 1) / 2
    else:
        k0, k1 = warp_to_pixels(matches, S, S + pad_w)
    k0 = k0 * scale0[:, None, :]
    k1 = k1 * scale1[:, None, :]
    valid = valid & (conf > 0)
    return MatchResult(k0, k1, torch.where(valid, conf, 0.0), valid)
