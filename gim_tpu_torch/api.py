"""High-level matcher API of the PyTorch port.

Port of `gim_tpu/api.py:27-140` and `:198-208`: build a matcher by name,
feed a batch of image pairs, get a `MatchResult` of fixed-shape tensors
with a validity mask. `gim_loftr` is ported; the other heads raise
`NotImplementedError` naming the slice of the port (ROADMAP.md) that
brings them.

Entry points run on the GPU (`device="cuda"`, the default) unless the
caller passes `device="cpu"`, and raise if CUDA is asked for and absent.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gim_tpu_torch import config as C
from gim_tpu_torch.models.loftr import LoFTRMatcher, init_weights
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
_LATER_SLICE = {"gim_lightglue": 3, "gim_dkm": 4, "gim_roma": 5,
                "root_sift": 6}


def _check_name(name: str):
    if name not in MODEL_ZOO:
        raise ValueError(f"unknown model {name}; choose from {MODEL_ZOO}")
    if name in _LATER_SLICE:
        raise NotImplementedError(
            f"{name} is not ported to gim_tpu_torch yet; it comes with "
            f"slice {_LATER_SLICE[name]} of the port (ROADMAP.md)")


def build_model(name: str, cfg: C.GimConfig) -> torch.nn.Module:
    _check_name(name)
    return LoFTRMatcher(cfg.loftr)


class Matcher:
    """Holds a model on its device; `match` runs it on a batch of pairs.

    Weights: `state_dict` (the reference key layout) if given, else seeded
    random weights from `generator` (default: a CPU generator seeded 0).
    Turns TF32 off for float32 matmuls and convolutions (utils/device.py).
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
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        else:
            init_weights(model, generator if generator is not None
                         else torch.Generator().manual_seed(0))
        self.model = model.to(device=self.device,
                              dtype=torch_dtype(self.cfg.loftr.dtype)).eval()

    @classmethod
    def from_checkpoint(cls, name: str, ckpt_path: str,
                        cfg: C.GimConfig | None = None,
                        device: str | torch.device = "cuda") -> "Matcher":
        """Build from a reference-layout torch checkpoint (key prefixes
        stripped as ref trainer/lightning.py:68-99 does)."""
        _check_name(name)
        resolve_device(device)
        sd = port.loftr_checkpoint_state_dict(port.load_torch_state_dict(
            ckpt_path))
        return cls(name, cfg, state_dict=sd, device=device)

    def match(self, image0, image1, scale0=None, scale1=None, mask0=None,
              mask1=None) -> MatchResult:
        """image0/1: (B, 3, H, W) float [0,1] (resized/padded frame).
        scale: (B, 2) [w/w', h/h'] to map back to original pixels;
        mask: (B, H, W) bool content masks."""
        return match_fn(self.name, self.cfg, self.model, image0, image1,
                        scale0, scale1, mask0, mask1, device=self.device)


def match_fn(name: str, cfg: C.GimConfig, model: torch.nn.Module, image0,
             image1, scale0=None, scale1=None, mask0=None, mask1=None, *,
             device: str | torch.device = "cuda") -> MatchResult:
    """Run `model` (built by `build_model`, on `device`) on a batch of
    pairs. Inputs are moved to `device`; missing scales are ones."""
    _check_name(name)
    dev = resolve_device(device)
    B = image0.shape[0]

    def put(t, dtype=None):
        return None if t is None else torch.as_tensor(t).to(dev, dtype)

    scale0 = (put(scale0, torch.float32) if scale0 is not None
              else torch.ones((B, 2), device=dev))
    scale1 = (put(scale1, torch.float32) if scale1 is not None
              else torch.ones((B, 2), device=dev))
    with torch.inference_mode():
        out = model(put(image0, torch.float32), put(image1, torch.float32),
                    scale0, scale1, put(mask0, torch.bool),
                    put(mask1, torch.bool))
    return MatchResult(out["mkpts0_f"], out["mkpts1_f"], out["mconf"],
                       out["valid"])
