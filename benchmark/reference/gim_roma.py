"""The plain reference of `configs/gim_roma.json`: RoMa as GIM ships it, in
plain PyTorch, float32 with TF32 off, and the judge of what the port's
timed path produced.

The model is the frozen copy under `frozen/` (`roma_model.py`: VGG19-BN,
DINOv2 ViT-L/14 from `dinov2.py` with the plain `attention.sdpa`, the GP,
the anchor-classifying transformer decoder, ConvRefiners whose hidden
blocks are plain depthwise conv, BatchNorm, ReLU and 1x1 conv), then the
balanced sampling of the matches (`draws`: the pixels
`dkm_model.sample_matches` draws) with the Gumbel draws of a device
generator seeded 11, as the port's `match_fn` draws them for gim_roma,
and the matches mapped to the original frame (the ZEB protocol's resize
of the content rectangle to the square model resolution).

Weights. The benchmark draws every convolution, linear and normalisation
layer (`harness/weights.seeded_state_dict`); it has no rule for DINOv2's
raw parameters, the class token, the position table and the layer scales,
so `skeleton` leaves them out of the state dict, and the port and this
reference both keep the values their modules are built with (zeros,
zeros, ones). A state dict that holds them loads into both.

The coarse pass picks each pixel's anchor by argmax over 64 x 64 classes,
which flips wherever two logits tie to rounding, so any sound float32
reordering moves some anchors. The judge therefore runs the reference
with the port's anchors imposed, holds the warp there, and holds each
anchor on its own to "the reference's argmax or a tie".

The sampling is as brittle: it ranks the pixels by a certainty
thresholded at `sample_thresh` and hands out its second Gumbel draws by
rank, so one certainty that rounds to the other side of the threshold
(or one KDE density to the other side of 10) moves one pixel far in the
ranking and shifts every match slot between. The judge therefore draws
the pixels once, with the reference's sampling on the port's own warp
and certainty, and reads both sides' matches at those pixels.

Judged, for each pair the check reads (all "lower is better"):

- `warp_gap`, `cert_gap`, `match_miss`: as gim_dkm's judge reads them
  (`gim_dkm._quantile_gap`, `gim_dkm.match_miss`), the reference run
  with the port's anchors and its matches read at the pixels drawn from
  the port's warp and certainty; `warp_gap` is read, not limited: with the
  anchors pinned, the reference in TF32 reads below the sound port's
  highest on some seeds, so no limit separates the two;
- `cls_gap`: the 99.9th percentile over the coarse anchor logits of
  |port - reference|;
- `anchor_miss`: the share of the coarse pixels (both directions) where
  the reference's logit at the anchor the port picked
  (`pick_anchors`, read by the head) falls short of the reference's
  largest by more than TIE_MARGIN;
- `anchor_gap` (read, not limited): the largest such shortfall.
"""

from __future__ import annotations

import torch

from benchmark.reference.frozen import config as C
from benchmark.reference.frozen.device import set_tf32
from benchmark.reference.frozen.dkm_blocks import kde_density
from benchmark.reference.frozen.dkm_model import gumbel
from benchmark.reference.frozen.precision import tf32_everywhere
from benchmark.reference.frozen.roma_model import RoMaMatcher
from benchmark.reference.gim_dkm import _extent, _quantile_gap, match_miss

SAMPLE_SEED = 11
# Two anchors whose reference logits lie within TIE_MARGIN are a tie: a
# port within float32 rounding of the reference may pick either. At full
# width the port's logits move by at most 3.1e-3 at the 99.9th percentile
# and its anchors fall short of the reference's best by at most 3.2e-3
# (38 runs); TF32's fall short by 0.20 to 0.54 where they flip (PERF.md
# section 2).
TIE_MARGIN = 0.02

# the parameters `seeded_state_dict` has no rule for: left at their built
# values in the port and the reference alike
RAW = ("dinov2.cls_token", "dinov2.pos_embed")
RAW_SUFFIXES = (".ls1.gamma", ".ls2.gamma")


def raw(key: str) -> bool:
    return key in RAW or key.endswith(RAW_SUFFIXES)


def roma_config(cfg: dict) -> C.RoMaConfig:
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg["gim_config"]["roma"].items()}
    return C.replace(C.RoMaConfig(), **fields)


class _Drawn(RoMaMatcher):
    """The model whose state dict holds the drawn parameters only."""

    def state_dict(self, *args, **kwargs):
        sd = super().state_dict(*args, **kwargs)
        for k in [k for k in sd if raw(k)]:
            del sd[k]
        return sd


def skeleton(cfg: dict) -> torch.nn.Module:
    """The model on the meta device: the state dict's keys and shapes,
    without the raw parameters (module docstring)."""
    with torch.device("meta"):
        return _Drawn(roma_config(cfg))


class Reference:
    def __init__(self, cfg: dict, state_dict: dict, device):
        self.cfg = roma_config(cfg)
        self.device = torch.device(device)
        # built on the device: the raw parameters' built values, and no
        # random initialisation of 300 M parameters on the host
        with self.device:
            model = RoMaMatcher(self.cfg)
        missing, unexpected = model.load_state_dict(state_dict, strict=False)
        if unexpected or not all(raw(k) for k in missing):
            raise RuntimeError(f"gim_roma reference state dict: missing "
                               f"{[k for k in missing if not raw(k)][:8]}, "
                               f"unexpected {unexpected[:8]}")
        self.model = model.eval()

    def _put(self, b, k, dtype=torch.float32):
        return torch.as_tensor(b[k]).to(self.device, dtype)

    @torch.inference_mode()
    def outputs(self, b: dict, control: bool = False,
                mode: torch.Tensor | None = None,
                drawn: tuple | None = None) -> dict:
        """The reference in the port's place: warp, certainty, the coarse
        logits and anchors, and the match result; `mode` imposes coarse
        anchors (2B, h16, w16); `drawn`, a (warp, certainty) pair, is
        what the matches' pixels are drawn from in place of the
        reference's own; `control` computes it in TF32 throughout."""
        set_tf32(False)
        if control:
            with tf32_everywhere():
                return self._outputs(b, mode, drawn)
        return self._outputs(b, mode, drawn)

    def _outputs(self, b, mode, drawn):
        c = self.cfg
        im0, im1 = self._put(b, "color0"), self._put(b, "color1")
        m0, m1 = self._put(b, "mask0", torch.bool), self._put(b, "mask1",
                                                             torch.bool)
        scale0, scale1 = self._put(b, "scale0"), self._put(b, "scale1")
        B, _, S, _ = im0.shape
        if not c.distort_aspect:
            raise NotImplementedError("the reference follows the ZEB "
                                      "protocol (distort_aspect)")
        if mode is not None:
            mode = torch.as_tensor(mode).to(self.device, torch.long)
        e0, e1 = _extent(m0, S), _extent(m1, S)
        warp, cert, cls = self.model(im0, im1, e0, e1, mode)
        src_warp, src_cert = (warp, cert) if drawn is None else (
            torch.as_tensor(t).to(self.device, torch.float32) for t in drawn)
        gen = torch.Generator(self.device).manual_seed(SAMPLE_SEED)
        rows = []
        for i in range(B):
            idx, valid = draws(src_warp[i], src_cert[i], c.num_samples,
                               c.sample_thresh, c.sample_mode, gen)
            rows.append((warp[i].reshape(-1, 4)[idx],
                         cert[i].reshape(-1)[idx], valid))
        matches, conf, valid = (torch.stack(t) for t in zip(*rows))
        k0 = e0[:, None, :] * S * (matches[..., 0:2] + 1) / 2
        k1 = e1[:, None, :] * S * (matches[..., 2:4] + 1) / 2
        valid = valid & (conf > 0)
        return {"warp": warp, "cert": cert, "cls": cls,
                "anchors": anchors(cls),
                "kpts0": k0 * scale0[:, None, :],
                "kpts1": k1 * scale1[:, None, :],
                "conf": torch.where(valid, conf, 0.0), "valid": valid}

    def judge(self, b: dict, got: dict, zeb: dict | None = None) -> dict:
        if zeb is not None:
            raise NotImplementedError("gim_roma has no ZEB cell")
        ref = self.outputs(b, mode=got["anchors"],
                           drawn=(got["warp"], got["cert"]))
        short = anchor_shortfall(ref["cls"], got["anchors"])
        return {
            "warp_gap": _quantile_gap(got["warp"], ref["warp"]),
            "cert_gap": _quantile_gap(got["cert"], ref["cert"]),
            "match_miss": match_miss(got, ref),
            "cls_gap": _quantile_gap(got["cls"], ref["cls"]),
            "anchor_miss": float((short > TIE_MARGIN).float().mean()),
            "anchor_gap": float(short.max()),
        }

    def flops_per_pair(self, b: dict) -> float:
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as fc:
            self.outputs(b)
        return fc.get_total_flops() / len(b["identifier"])


def draws(warp: torch.Tensor, certainty: torch.Tensor, num: int,
          sample_thresh: float, mode: str, generator: torch.Generator):
    """The pixels `dkm_model.sample_matches` draws from one pair's dense
    warp (hs, ws2, 4) and certainty (hs, ws2), in its order and with its
    Gumbel draws from `generator`: flat indices (num,), and whether each
    holds weight (its `valid`)."""
    cert_raw = certainty.reshape(-1)
    if "threshold" in mode:
        cert = torch.where(cert_raw > sample_thresh, 1.0, cert_raw)
    else:
        cert = cert_raw
    expansion = 4 if "balanced" in mode else 1
    n_grab = min(expansion * num, cert.shape[0])
    num = min(num, n_grab)
    g1 = gumbel(cert.shape[0], generator, cert.device)
    g2 = gumbel(n_grab, generator, cert.device)
    idx = torch.topk(torch.log(cert.clamp_min(1e-12)) + g1, n_grab).indices
    if "balanced" in mode:
        density = kde_density(warp.reshape(-1, 4)[idx], std=0.1)
        p = 1.0 / (density + 1.0)
        p = torch.where(density < 10, 1e-7, p)
        idx = idx[torch.topk(torch.log(p.clamp_min(1e-30)) + g2, num).indices]
    else:
        idx = idx[:num]
    return idx, cert[idx] > 0


def anchors(cls_logits: torch.Tensor) -> torch.Tensor:
    """The anchors `cls_to_flow_refine` picks: the argmax of the softmax,
    first index on ties."""
    return torch.softmax(cls_logits, dim=-1).argmax(dim=-1)


def anchor_shortfall(ref_cls: torch.Tensor, mode) -> torch.Tensor:
    """(2B, h, w): how far the reference's logit at each imposed anchor
    falls short of the reference's largest."""
    mode = torch.as_tensor(mode).to(ref_cls.device, torch.long)
    at = ref_cls.gather(-1, mode[..., None])[..., 0]
    return ref_cls.amax(-1) - at
