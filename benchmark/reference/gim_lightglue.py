"""The plain reference of `configs/gim_lightglue.json`: SuperPoint and the
9-layer LightGlue as GIM's demo runs them, in plain PyTorch, float32
with TF32 off, and the judge of what the port's timed path produced.

The models are the frozen copies under `frozen/`; the keypoint slots
SuperPoint leaves empty are placed with uniforms from device generators
seeded 97 and 131, as the port's `match_fn` draws them; each keypoint of
image 0 is paired with its partner, keypoints in the original frame.

Judged, for each batch the check reads (all "lower is better"):

- `kpt_miss`: the keypoints that only one side holds valid, the port's
  that the reference's SuperPoint does not detect at the same pixel and
  the reference's that the port misses, as a share of both sides' valid
  keypoints (both images);
- `desc_gap`: the largest |port - reference| of a descriptor entry at the
  keypoints both detect;
- `score_gap`: the 99.9th percentile over image-0 slots of the relative
  gap |port - reference| / |reference| of LightGlue's matching score, the
  reference's LightGlue run on the port's keypoints and descriptors;
- `match_miss`: the share of image-0 slots where the port's match result
  and the one the reference's LightGlue gives differ: validity, either
  end by more than half a pixel, or the confidence by more than 1e-3 of
  the reference's;
- with ZEB rows, the rows' numbers (`zeb_rows.judge`).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import zeb_rows
from benchmark.reference.frozen import config as C
from benchmark.reference.frozen.device import set_tf32
from benchmark.reference.frozen.lightglue import LightGlue
from benchmark.reference.frozen.precision import tf32_everywhere
from benchmark.reference.frozen.superpoint import SuperPointNet, extract

PAD_SEEDS = (97, 131)
HALF_PIXEL, CONF_TOL, QUANTILE = 0.5, 1e-3, 0.999


def configs(cfg: dict):
    g = cfg["gim_config"]
    return (C.replace(C.SuperPointConfig(), **g["superpoint"]),
            C.replace(C.LightGlueConfig(), **g["lightglue"]))


def build(cfg: dict) -> torch.nn.Module:
    sp, lg = configs(cfg)
    return torch.nn.ModuleDict({"superpoint": SuperPointNet(sp.descriptor_dim),
                                "lightglue": LightGlue(lg)})


def skeleton(cfg: dict) -> torch.nn.Module:
    with torch.device("meta"):
        return build(cfg)


def _content_wh(mask):
    h = mask.sum(1).amax(-1).float()
    w = mask.sum(2).amax(-1).float()
    return torch.stack([w, h], dim=-1)


class Reference:
    def __init__(self, cfg: dict, state_dict: dict, device):
        self.sp_cfg, self.lg_cfg = configs(cfg)
        self.device = torch.device(device)
        model = build(cfg)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    def _put(self, b, k, dtype=torch.float32):
        return torch.as_tensor(b[k]).to(self.device, dtype)

    def _inputs(self, b):
        im = [self._put(b, "color0"), self._put(b, "color1")]
        wh = [_content_wh(self._put(b, k, torch.bool))
              for k in ("mask0", "mask1")]
        return im, wh

    def _extract(self, im, wh):
        B = im[0].shape[0]
        K = self.sp_cfg.max_num_keypoints
        out = []
        for i in range(2):
            g = torch.Generator(self.device).manual_seed(PAD_SEEDS[i])
            noise = torch.rand((B, K, 2), device=self.device, generator=g)
            out.append(extract(self.model.superpoint, im[i], self.sp_cfg,
                               wh[i].flip(-1), noise))
        return out

    def _glue(self, b, sp, wh):
        lg = self.model.lightglue(sp[0]["keypoints"], sp[1]["keypoints"],
                                  sp[0]["descriptors"], sp[1]["descriptors"],
                                  wh[0], wh[1], sp[0]["valid"],
                                  sp[1]["valid"])
        m0 = lg["matches0"]
        valid = m0 >= 0
        k0 = sp[0]["keypoints"] * self._put(b, "scale0")[:, None, :]
        k1 = sp[1]["keypoints"] * self._put(b, "scale1")[:, None, :]
        k1 = torch.gather(k1, 1, m0.clamp_min(0)[..., None].expand(-1, -1, 2))
        conf = torch.where(valid, lg["matching_scores0"], 0.0)
        return {"matches0": m0, "scores0": lg["matching_scores0"],
                "kpts0": k0, "kpts1": k1, "conf": conf, "valid": valid}

    @torch.inference_mode()
    def outputs(self, b: dict, control: bool = False) -> dict:
        """The reference in the port's place; `control` computes it in
        TF32 throughout."""
        set_tf32(False)
        if control:
            with tf32_everywhere():
                return self._outputs(b)
        return self._outputs(b)

    def _outputs(self, b):
        im, wh = self._inputs(b)
        sp = self._extract(im, wh)
        out = self._glue(b, sp, wh)
        for i in range(2):
            out.update({f"sp{i}_{k}": sp[i][k]
                        for k in ("keypoints", "valid", "descriptors")})
        return out

    @torch.inference_mode()
    def judge(self, b: dict, got: dict, zeb: dict | None = None) -> dict:
        set_tf32(False)
        im, wh = self._inputs(b)
        ref_sp = self._extract(im, wh)
        miss, seen, desc = 0, 0, 0.0
        for i in range(2):
            m, n, d = _keypoints_vs(got, i, ref_sp[i], im[i].shape[-1])
            miss, seen, desc = miss + m, seen + n, max(desc, d)
        put = {k: torch.as_tensor(v).to(self.device) for k, v in got.items()
               if k.startswith("sp")}
        sp = [{k: put[f"sp{i}_{k}"] for k in ("keypoints", "valid",
                                              "descriptors")}
              for i in range(2)]
        ref = self._glue(b, sp, wh)
        out = {
            "kpt_miss": miss / max(seen, 1),
            "desc_gap": desc,
            "score_gap": score_gap(got["scores0"], ref["scores0"]),
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


def _keypoints_vs(got: dict, i: int, ref: dict, W: int):
    """(pixels holding a valid keypoint on one side only, pixels holding
    one on each side, summed; the largest descriptor gap at the pixels
    both hold) of image i against the reference's."""
    gk = np.asarray(torch.as_tensor(got[f"sp{i}_keypoints"]).cpu())
    gv = np.asarray(torch.as_tensor(got[f"sp{i}_valid"]).cpu())
    gd = torch.as_tensor(got[f"sp{i}_descriptors"]).to(ref["descriptors"])
    rk, rv = ref["keypoints"].cpu().numpy(), ref["valid"].cpu().numpy()
    missed, seen, gap = 0, 0, 0.0
    for b in range(gk.shape[0]):
        key = lambda k: (np.floor(k[:, 1]) * W + np.floor(k[:, 0])).astype(
            np.int64)
        where = {int(x): j for j, x in enumerate(key(rk[b])) if rv[b, j]}
        gkeys = key(gk[b])
        pairs = [(j, where[int(x)]) for j, x in enumerate(gkeys)
                 if gv[b, j] and int(x) in where]
        mine = {int(x) for j, x in enumerate(gkeys) if gv[b, j]}
        seen += len(mine) + len(where)
        missed += len(mine ^ where.keys())
        if pairs:
            a, r = (torch.as_tensor(ix, device=gd.device)
                    for ix in zip(*pairs))
            gap = max(gap, float((gd[b, a] - ref["descriptors"][b, r])
                                 .abs().max()))
    return missed, seen, gap


def score_gap(got, ref) -> float:
    """The 99.9th percentile over image-0 slots of |port - reference| /
    |reference| of the matching score (a slot the reference scores 0 and
    the port does not reads infinity)."""
    g = torch.as_tensor(got).to(ref.device, ref.dtype)
    d = ((g - ref).abs() / ref.abs()).nan_to_num(0.0).flatten()
    return float(d.kthvalue(max(1, int(round(QUANTILE * d.numel())))).values)


def match_miss(got: dict, ref: dict) -> float:
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
