"""gim_dkm matcher and the match sampling it shares with gim_roma
(PyTorch port).

Port of `gim_tpu/models/dkm/model.py`: `REFINER_SPECS` (:29-37),
`DKMDecoder` (:40-106), `DKMMatcher` (:109-218), `sample_matches`
(:221-263) and `warp_to_pixels` (:266-273); reference networks/dkm/models/
dkm.py Decoder (:403-534) and RegressionMatcher (:537-753), wired per
model_zoo/DKMv3.py:5-145 -- ResNet-50 pyramid, GP regression (gp_dim 256)
and the DFN embedding decoder (dfn_dim 384) at 1/32 and 1/16, 1x1
projections 2048 -> 512 and 1024 -> 512, ConvRefiners at 1/16 .. 1 (radii
7, 3, 2), symmetric two-pass matching with the upsample pass at (1152,
1536), certainty attenuation (:688-693) and black-pixel masking
(:726-731).

Parameter names are the reference checkpoint's (`encoder.net.layer1.0.
conv1`, `decoder.proj.16`, `decoder.gps.16.pos_conv`, `decoder.
embedding_decoder.rrb_d.16.conv1`, `decoder.conv_refiner.2.block1.0`, ...).
Features are NCHW; flows and certainties NHWC (blocks.py). Both images of
a pair go through the encoder as one batch [q; s], and the decoder sees
the support features with the halves swapped, so one pass matches both
directions.

Training (`train_mode`, decided at construction, `:40-147`): the DFN's
and the refiners' BatchNorms take the batch's statistics, the GP solves
every row (no `bug_compat`), each refiner is recomputed in backward
(`common.recomputed`, JAX's `nn.remat`) and the kernel K2 stays off;
`train_corresps` is the single symmetric pass at (h_resized, w_resized).
The encoder keeps its running statistics in both modes (`:116`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gim_tpu_torch.config import DKMConfig
from gim_tpu_torch.models.common import conv, recomputed
from gim_tpu_torch.models.dkm.blocks import (DFN, GP, ConvRefiner,
                                             coords_grid, kde_density,
                                             resize_nhwc, resize_region_nhwc)
from gim_tpu_torch.models.dkm.encoder import ResNet50Pyramid
from gim_tpu_torch.ops.resize import nearest_indices, resize_bilinear
from gim_tpu_torch.utils.device import torch_dtype
from gim_tpu_torch.utils.profiling import span

REFINER_SPECS = {
    # scale: (in_dim, hidden_dim, disp_emb_dim, local_corr_radius)
    # ref DKMv3.py:52-111
    "16": (2 * 512 + 128 + 225, 2 * 512 + 128 + 225, 128, 7),
    "8": (2 * 512 + 64 + 49, 2 * 512 + 64 + 49, 64, 3),
    "4": (2 * 256 + 32 + 25, 2 * 256 + 32 + 25, 32, 2),
    "2": (2 * 64 + 16, 128 + 16, 16, None),
    "1": (2 * 3 + 6, 24, 6, None),
}

# the GP and DFN scales and the width of their 1x1 projections' inputs
PROJ_IN = {"32": 2048, "16": 1024}

# the decoder's spans: one stride of its loop, and the refiner at it
SCALE_SPANS = {s: f"gim.dkm.scale.{s}" for s in ("32", "16", *REFINER_SPECS)}
REFINER_SPANS = {s: f"gim.dkm.refiner.{s}" for s in REFINER_SPECS}


class DKMDecoder(nn.Module):
    def __init__(self, cfg: DKMConfig, train_mode: bool = False):
        super().__init__()
        self.cfg = cfg
        self.train_mode = train_mode
        self.dtype = torch_dtype(cfg.dtype)
        self.proj = nn.ModuleDict({s: nn.Conv2d(cin, 512, 1)
                                   for s, cin in PROJ_IN.items()})
        # the eval graph replicates the reference's batched-inverse bug
        # (blocks.GP); training solves every row (model.py:74-77)
        self.gps = nn.ModuleDict({
            s: GP(cfg.gp_dim,
                  bug_compat=cfg.gp_inv_bug_compat and not train_mode)
            for s in PROJ_IN})
        self.embedding_decoder = DFN(tuple(PROJ_IN), 512, cfg.feat_dim,
                                     cfg.gp_dim, cfg.dfn_dim, cfg.dtype,
                                     train_mode)
        self.conv_refiner = nn.ModuleDict({
            s: ConvRefiner(i, h, displacement_emb_dim=e, local_corr_radius=r,
                           dtype=cfg.dtype, train_mode=train_mode)
            for s, (i, h, e, r) in REFINER_SPECS.items()
            if s in cfg.refiner_scales})

    @span("gim.dkm.decoder")
    def forward(self, f1: dict, f2: dict, upsample: bool = False,
                flow: torch.Tensor | None = None,
                certainty: torch.Tensor | None = None) -> dict:
        """f1, f2: {stride: (B, C, H, W)}. Coarse pass (upsample=False) from
        stride 32, where the GP and the DFN set flow and certainty at
        strides 32 and 16; or upsample pass from stride 8, starting at
        `flow` (B, h, w, 2) and `certainty` (B, h, w, 1). Returns {stride:
        {"flow", "certainty"}}, float32 NHWC. The flow and certainty handed
        to the next stride carry no gradient (`model.py:104-105`)."""
        dt = self.dtype
        scales = ["8", "4", "2", "1"] if upsample else \
            ["32", "16", "8", "4", "2", "1"]
        sizes = {s: tuple(f1[s].shape[-2:]) for s in f1}
        H, W = sizes[1]
        B = f1[1].shape[0]
        dev = f1[1].device
        coarsest = int(scales[0])
        if not upsample:
            flow = coords_grid(B, *sizes[coarsest], dev)
            certainty = torch.zeros((B, *sizes[coarsest], 1), device=dev)
            context = torch.zeros((B, self.cfg.dfn_dim, *sizes[coarsest]),
                                  dtype=dt, device=dev)
        else:
            flow = resize_nhwc(flow, *sizes[coarsest])
            certainty = resize_nhwc(certainty, *sizes[coarsest])

        out = {}
        for s in scales:
            with span(SCALE_SPANS[s]):
                ins = int(s)
                f1_s, f2_s = f1[ins], f2[ins]
                if s in self.proj:
                    f1_s = conv(self.proj[s], f1_s, dt)
                    f2_s = conv(self.proj[s], f2_s, dt)
                if s in self.gps and not upsample:
                    context = resize_bilinear(context, sizes[ins])
                    post = self.gps[s](f1_s.permute(0, 2, 3, 1),
                                       f2_s.permute(0, 2, 3, 1))
                    # the DFN's prediction replaces flow and certainty
                    flow, certainty, context = self.embedding_decoder(
                        s, post, f1_s, context)
                if s in self.conv_refiner:
                    refiner = self.conv_refiner[s]
                    with span(REFINER_SPANS[s]):
                        if self.train_mode:
                            delta_cert, disp = recomputed(refiner, f1_s, f2_s,
                                                          flow)
                        else:
                            delta_cert, disp = refiner(f1_s, f2_s, flow)
                    # the displacement is in units of 4 px of this pass's
                    # full resolution
                    flow = torch.stack(
                        [flow[..., 0] + ins * disp[..., 0] / (4 * W),
                         flow[..., 1] + ins * disp[..., 1] / (4 * H)], dim=-1)
                    certainty = certainty + delta_cert
                out[ins] = {"flow": flow, "certainty": certainty}
                if s != "1":
                    nxt = sizes[ins // 2]
                    flow = resize_nhwc(flow, *nxt).detach()
                    certainty = resize_nhwc(certainty, *nxt).detach()
        return out


class DKMMatcher(nn.Module):
    """Symmetric two-pass dense matcher (ref dkm.py:655-753); in
    `train_mode` the decoder's training graph (module docstring)."""

    def __init__(self, cfg: DKMConfig, train_mode: bool = False):
        super().__init__()
        self.cfg = cfg
        self.train_mode = train_mode
        self.encoder = ResNet50Pyramid(cfg.dtype)
        self.decoder = DKMDecoder(cfg, train_mode)

    @span("gim.dkm.encoder")
    def pyramids(self, q: torch.Tensor, s: torch.Tensor):
        """q, s: (B, 3, h, w). Returns the query-side and support-side
        pyramids of the batch [q; s], {stride: (2B, C, H, W)}."""
        feats = self.encoder(torch.cat([q, s], dim=0))
        B = q.shape[0]
        f_s = {k: torch.cat([v[B:], v[:B]], dim=0) for k, v in feats.items()}
        return feats, f_s

    def train_corresps(self, im0: torch.Tensor, im1: torch.Tensor) -> dict:
        """The training pass (`model.py:132-147`): im0, im1 (B, 3, H, W)
        resized to (h_resized, w_resized), one symmetric decoder pass, no
        upsample pass. Returns {stride: {"dense_flow" (2B, h, w, 2),
        "dense_certainty" (2B, h, w, 1)}}; rows B..2B match image 1 to
        image 0."""
        c = self.cfg
        q = resize_nhwc(im0.float().permute(0, 2, 3, 1), c.h_resized,
                        c.w_resized)
        s = resize_nhwc(im1.float().permute(0, 2, 3, 1), c.h_resized,
                        c.w_resized)
        f_q, f_s = self.pyramids(q.permute(0, 3, 1, 2), s.permute(0, 3, 1, 2))
        return {k: {"dense_flow": d["flow"], "dense_certainty": d["certainty"]}
                for k, d in self.decoder(f_q, f_s).items()}

    def forward(self, im0: torch.Tensor, im1: torch.Tensor,
                extent0: torch.Tensor | None = None,
                extent1: torch.Tensor | None = None):
        """im0, im1: (B, 3, H, W) float [0, 1] canvases; extent0/1:
        optional (B, 2) (w_frac, h_frac) of valid content, of which only
        the top-left region is resampled to the model resolution (the
        reference ZEB protocol's aspect-distorting resize, ref
        dkm.py:668-671). Returns (warp (B, hs, 2 ws, 4), certainty (B, hs,
        2 ws)) in the reference's symmetric layout (:734-742)."""
        c = self.cfg
        B = im0.shape[0]
        q = im0.float().permute(0, 2, 3, 1)
        s = im1.float().permute(0, 2, 3, 1)
        hs, ws = c.h_resized, c.w_resized

        def rsz(x, h, w, extent):
            if extent is None:
                return resize_nhwc(x, h, w)
            return resize_region_nhwc(x, h, w, extent)

        def nchw(x):
            return x.permute(0, 3, 1, 2)

        f_q, f_s = self.pyramids(nchw(rsz(q, hs, ws, extent0)),
                                 nchw(rsz(s, hs, ws, extent1)))
        corresps = self.decoder(f_q, f_s)

        if c.upsample_preds:
            hs, ws = c.upsample_res
        lrc = resize_nhwc(corresps[16]["certainty"], hs, ws)
        low_res_certainty = 0.5 * lrc * (lrc < 0)

        if c.upsample_preds:
            f_q, f_s = self.pyramids(nchw(rsz(q, hs, ws, extent0)),
                                     nchw(rsz(s, hs, ws, extent1)))
            corresps = self.decoder(f_q, f_s, upsample=True,
                                    flow=corresps[1]["flow"],
                                    certainty=corresps[1]["certainty"])

        flow = corresps[1]["flow"]                         # (2B, hs, ws, 2)
        certainty = torch.sigmoid(corresps[1]["certainty"]
                                  - low_res_certainty)[..., 0]
        # |flow| > 1 is read before the clip below
        wrong = (flow.abs() > 1).any(dim=-1)
        certainty = torch.where(wrong, 0.0, certainty)

        def black(im, extent):
            if extent is None:
                # JAX's "nearest" resize indices, not torch's
                m = (im < 0.03125).all(dim=-1)                    # (B, H, W)
                iy = nearest_indices(m.shape[1], hs).to(m.device)
                ix = nearest_indices(m.shape[2], ws).to(m.device)
                return m[:, iy][:, :, ix]
            return (rsz(im, hs, ws, extent) < 0.03125).all(dim=-1)

        bm = torch.cat([black(q, extent0), black(s, extent1)], dim=0)
        certainty = torch.where(bm, 0.0, certainty)

        flow = flow.clamp(-1, 1)
        grid = coords_grid(B, hs, ws, flow.device)
        qts, stq = flow[:B], flow[B:]
        warp = torch.cat([torch.cat([grid, qts], dim=-1),
                          torch.cat([stq, grid], dim=-1)], dim=2)
        cert = torch.cat([certainty[:B], certainty[B:]], dim=2)
        return warp, cert


def gumbel(n: int, generator: torch.Generator,
           device: torch.device) -> torch.Tensor:
    """n standard Gumbel draws, -log(-log(u)) with u in [tiny, 1) as
    `jax.random.gumbel` draws them, from `generator` (on its device),
    returned on `device`."""
    u = torch.rand(n, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def sample_matches(warp: torch.Tensor, certainty: torch.Tensor,
                   num: int = 5000, sample_thresh: float = 0.05,
                   mode: str = "threshold_balanced", *,
                   generator: torch.Generator | None = None,
                   noise: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Certainty-weighted sampling with balanced KDE resampling.

    warp: (hs, ws2, 4); certainty: (hs, ws2). Returns (matches (num, 4)
    normalized, certainty (num,), valid (num,)). Sampling without
    replacement is the Gumbel-top-k trick: `noise` = (g1, g2), Gumbel
    draws of sizes (hs * ws2,) and (min(4 num, hs * ws2),) -- the JAX
    package draws them with `jax.random.gumbel` at `:240-242` and `:260`;
    without `noise` they come from `generator`.
    """
    matches = warp.reshape(-1, 4)
    cert_raw = certainty.reshape(-1)
    if "threshold" in mode:
        cert = torch.where(cert_raw > sample_thresh, 1.0, cert_raw)
    else:
        cert = cert_raw
    expansion = 4 if "balanced" in mode else 1
    # a small dense grid can hold fewer cells than the sample budget
    n_grab = min(expansion * num, cert.shape[0])
    num = min(num, n_grab)
    if noise is None:
        if generator is None:
            raise ValueError("sample_matches needs a generator or noise")
        g1 = gumbel(cert.shape[0], generator, cert.device)
        g2 = gumbel(n_grab, generator, cert.device)
    else:
        g1, g2 = (n.to(cert.device, torch.float32) for n in noise)

    logp = torch.log(cert.clamp_min(1e-12))
    idx = torch.topk(logp + g1, n_grab).indices
    good_matches = matches[idx]
    good_cert = cert_raw[idx]
    good_w = cert[idx]
    if "balanced" not in mode:
        return good_matches[:num], good_cert[:num], good_w[:num] > 0

    density = kde_density(good_matches, std=0.1)
    p = 1.0 / (density + 1.0)
    p = torch.where(density < 10, 1e-7, p)
    idx2 = torch.topk(torch.log(p.clamp_min(1e-30)) + g2, num).indices
    return good_matches[idx2], good_cert[idx2], good_w[idx2] > 0


def warp_to_pixels(matches: torch.Tensor, hs: float, ws: float):
    """Normalized warp rows (..., 4) -> pixel keypoints in both canvases
    of size (hs, ws) (ref demo.py:438-443). Returns (kpts0, kpts1), each
    (..., 2)."""
    k0 = torch.stack([ws * (matches[..., 0] + 1) / 2,
                      hs * (matches[..., 1] + 1) / 2], dim=-1)
    k1 = torch.stack([ws * (matches[..., 2] + 1) / 2,
                      hs * (matches[..., 3] + 1) / 2], dim=-1)
    return k0, k1
