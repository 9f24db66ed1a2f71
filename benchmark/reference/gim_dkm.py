"""The plain reference of `configs/gim_dkm.json`: DKMv3 outdoor as GIM
ships it, in plain PyTorch, float32 with TF32 off, and the judge of what
the port's timed path produced.

The model is the frozen copy under `frozen/` (ResNet-50 pyramid, GP, DFN,
ConvRefiners whose hidden blocks are plain depthwise conv, BatchNorm,
ReLU and 1x1 conv), then the balanced sampling of 5000 matches with the
Gumbel draws of a device generator seeded 7, as the port's `match_fn`
draws them, and the matches mapped to the original frame (the ZEB
protocol's aspect-distorting resize of the content rectangle).

Judged, for each pair the check reads (all "lower is better"):

- `warp_gap`: the 99.9th percentile over the symmetric warp's entries
  (normalized coordinates) of |port - reference|;
- `cert_gap`: the same of the certainty;
- `match_miss`: the share of the 5000 match slots where the port's match
  and the reference's differ: validity, or either end by more than half
  a pixel, or the confidence by more than 1e-3 of the reference's;
- with ZEB rows, the rows' numbers (`zeb_rows.judge`).
"""

from __future__ import annotations

import torch

from benchmark.reference import zeb_rows
from benchmark.reference.frozen import config as C
from benchmark.reference.frozen.device import set_tf32
from benchmark.reference.frozen.dkm_model import DKMMatcher, sample_matches
from benchmark.reference.frozen.precision import tf32_everywhere

SAMPLE_SEED = 7
HALF_PIXEL, CONF_TOL, QUANTILE = 0.5, 1e-3, 0.999


def dkm_config(cfg: dict) -> C.DKMConfig:
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg["gim_config"]["dkm"].items()}
    return C.replace(C.DKMConfig(), **fields)


def skeleton(cfg: dict) -> torch.nn.Module:
    """The model on the meta device: the state dict's keys and shapes."""
    with torch.device("meta"):
        return DKMMatcher(dkm_config(cfg))


def _content_wh(mask):
    h = mask.sum(1).amax(-1).float()
    w = mask.sum(2).amax(-1).float()
    return torch.stack([w, h], dim=-1)


def _extent(mask, S: int):
    return _content_wh(mask) / S


class Reference:
    def __init__(self, cfg: dict, state_dict: dict, device):
        self.cfg = dkm_config(cfg)
        self.device = torch.device(device)
        model = DKMMatcher(self.cfg)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    def _put(self, b, k, dtype=torch.float32):
        return torch.as_tensor(b[k]).to(self.device, dtype)

    @torch.inference_mode()
    def outputs(self, b: dict, control: bool = False) -> dict:
        """The reference in the port's place: warp, certainty and the
        match result; `control` computes it in TF32 throughout."""
        set_tf32(False)
        if control:
            with tf32_everywhere():
                return self._outputs(b)
        return self._outputs(b)

    def _outputs(self, b):
        c = self.cfg
        im0, im1 = self._put(b, "color0"), self._put(b, "color1")
        m0, m1 = self._put(b, "mask0", torch.bool), self._put(b, "mask1",
                                                             torch.bool)
        scale0, scale1 = self._put(b, "scale0"), self._put(b, "scale1")
        B, _, S, _ = im0.shape
        if not c.distort_aspect:
            raise NotImplementedError("the reference follows the ZEB "
                                      "protocol (distort_aspect)")
        e0, e1 = _extent(m0, S), _extent(m1, S)
        warp, cert = self.model(im0, im1, e0, e1)
        gen = torch.Generator(self.device).manual_seed(SAMPLE_SEED)
        rows = [sample_matches(warp[i], cert[i], c.num_samples,
                               c.sample_thresh, c.sample_mode, generator=gen)
                for i in range(B)]
        matches, conf, valid = (torch.stack(t) for t in zip(*rows))
        k0 = e0[:, None, :] * S * (matches[..., 0:2] + 1) / 2
        k1 = e1[:, None, :] * S * (matches[..., 2:4] + 1) / 2
        valid = valid & (conf > 0)
        return {"warp": warp, "cert": cert,
                "kpts0": k0 * scale0[:, None, :],
                "kpts1": k1 * scale1[:, None, :],
                "conf": torch.where(valid, conf, 0.0), "valid": valid}

    def judge(self, b: dict, got: dict, zeb: dict | None = None) -> dict:
        ref = self.outputs(b)
        out = {
            "warp_gap": _quantile_gap(got["warp"], ref["warp"]),
            "cert_gap": _quantile_gap(got["cert"], ref["cert"]),
            "match_miss": match_miss(got, ref),
        }
        if zeb is not None:
            out.update(zeb_rows.judge(b, got, zeb, self.device))
        return out

    def flops_per_pair(self, b: dict) -> float:
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as fc:
            self.outputs(b)
        return fc.get_total_flops() / len(b["identifier"])


def _quantile_gap(a, b) -> float:
    d = (torch.as_tensor(a).to(b.device).float() - b.float()).abs()
    d = d.flatten()
    k = max(1, int(round(QUANTILE * d.numel())))
    return float(d.kthvalue(k).values)


def match_miss(got: dict, ref: dict) -> float:
    """Share of match slots where `got` and `ref` differ (validity, an
    end by more than half a pixel, or the confidence by more than
    CONF_TOL of the reference's)."""
    dev = ref["kpts0"].device
    g = {k: torch.as_tensor(got[k]).to(dev) for k in
         ("kpts0", "kpts1", "conf", "valid")}
    ends = torch.maximum((g["kpts0"] - ref["kpts0"]).abs().amax(-1),
                         (g["kpts1"] - ref["kpts1"]).abs().amax(-1))
    both = g["valid"] & ref["valid"]
    conf = (g["conf"] - ref["conf"]).abs() > CONF_TOL * ref["conf"].abs()
    differ = (g["valid"] != ref["valid"]) | (both & ((ends > HALF_PIXEL)
                                                     | conf))
    return float(differ.float().mean())
