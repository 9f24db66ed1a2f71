"""gim_roma matcher (PyTorch port).

Port of `gim_tpu/models/roma/model.py:42-314`: `VGG19`, the
`TransformerDecoder`, `cls_to_flow_refine`, `RoMaDecoder` and
`RoMaMatcher`; reference networks/roma/roma.py -- VGG19-bn fine pyramid
(:139-152), frozen DINOv2 ViT-L/14 coarse features at 1/14 labelled scale
"16" (:583-633), GP(16) with a 512-d fourier basis (:27-136), a 5-block
transformer match decoder classifying over a 64x64+1 anchor grid
(:952-1015), 5-neighbour flow refinement (:1091-1121), per-scale
ConvRefiners (:436-580) and 1x1+BN projections (:1230-1243), symmetric
two-pass matching with certainty attenuation (:815-917).

Parameter names are the reference checkpoint's (`encoder.cnn.layers.
{idx}`, `decoder.conv_refiner.{s}...`, `decoder.gps.16.pos_conv`,
`decoder.proj.{s}.{0,1}`, `decoder.embedding_decoder.blocks.{i}...`); the
DINOv2 trunk, which the reference checkpoint does not hold, sits under
`dinov2.` with the hub checkpoint's names.

Features are NCHW; flows and certainties NHWC (blocks.py). Both images of
a pair go through the encoders as one batch [q; s], and the decoder sees
the support features with the halves swapped, so one pass matches both
directions.

DINOv2 runs without gradient (JAX's stop_gradient, `:224`), and the flow
leaves `cls_to_flow_refine` and each scale without one (`:173`,
`:199-200`). Training (`train_mode`, decided at construction): each
projection's BatchNorm takes the batch's statistics, twice a scale (on
f1, then on f2, as the one flax module called twice moves its running
statistics twice, `:161-166`), so do the refiners', each refiner is
recomputed in backward (`common.recomputed`, JAX's `nn.remat`,
`:179-181`) and the kernel K2 stays off; `train_corresps` is the single
symmetric pass at coarse_res (`:234-246`). VGG19 keeps its running
statistics in both modes (`:211`).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from gim_tpu_torch.config import RoMaConfig
from gim_tpu_torch.models.common import batchnorm, conv, dense, recomputed
from gim_tpu_torch.models.dinov2 import Block, DinoViT
from gim_tpu_torch.models.dkm.blocks import (GP, ConvRefiner, coords_grid,
                                             resize_nhwc, resize_region_nhwc)
from gim_tpu_torch.ops.resize import nearest_indices
from gim_tpu_torch.utils.device import torch_dtype

ROMA_REFINER_SPECS = {
    # scale: (in_dim, hidden_dim, disp_emb_dim, radius)  ref roma.py:1144-1213
    "16": (2 * 512 + 128 + 225, 2 * 512 + 128 + 225, 128, 7),
    "8": (2 * 512 + 64 + 49, 2 * 512 + 64 + 49, 64, 3),
    "4": (2 * 256 + 32 + 25, 2 * 256 + 32 + 25, 32, 2),
    "2": (2 * 64 + 16, 128 + 16, 16, None),
    "1": (2 * 9 + 6, 24, 6, None),
}

PROJ_SPECS = {"16": (1024, 512), "8": (512, 512), "4": (256, 256),
              "2": (128, 64), "1": (64, 9)}

# torchvision vgg19_bn features up to conv4_4's ReLU (index 38)
_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
            512, 512, 512, 512)


class VGG19(nn.Module):
    """torchvision vgg19_bn features[:39] (ref roma.py:139-152). Returns
    the features right before each max-pool: scales 1, 2, 4, 8."""

    def __init__(self, dtype: str = "float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        layers: list[nn.Module] = []
        cin = 3
        for v in _VGG_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.BatchNorm2d(v),
                           nn.ReLU()]
                cin = v
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        dt = self.dtype
        x = x.to(dt)
        feats = {}
        scale = 1
        for layer in self.layers:
            if isinstance(layer, nn.MaxPool2d):
                feats[scale] = x
                scale *= 2
                x = layer(x)
            elif isinstance(layer, nn.Conv2d):
                x = conv(layer, x, dt)
            elif isinstance(layer, nn.BatchNorm2d):
                x = batchnorm(layer, x, dt)
            else:
                x = F.relu(x)
        feats[scale] = x
        return feats


class TransformerDecoder(nn.Module):
    """ViT blocks over [gp_posterior; features] tokens -> a classifier over
    the anchor grid plus a certainty (ref roma.py:952-1015)."""

    def __init__(self, hidden_dim: int = 1024, out_dim: int = 64 * 64 + 1,
                 num_blocks: int = 5, dtype: str = "float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.blocks = nn.ModuleList([
            Block(hidden_dim, 8, layerscale=False, qkv_bias=False,
                  dtype=dtype) for _ in range(num_blocks)])
        self.to_out = nn.Linear(hidden_dim, out_dim)

    def forward(self, gp_posterior: torch.Tensor, features: torch.Tensor):
        """gp_posterior, features: (B, H, W, C) NHWC. Returns float32
        (cls logits (B, H, W, out_dim - 1), certainty (B, H, W, 1))."""
        x = torch.cat([gp_posterior.float(), features.float()], dim=-1)
        B, H, W, C = x.shape
        tokens = x.reshape(B, H * W, C)
        for blk in self.blocks:
            tokens = blk(tokens)
        # logits bear geometry (argmax + neighbour softmax): float32
        out = dense(self.to_out, tokens, self.dtype).float().reshape(
            B, H, W, -1)
        return out[..., :-1], out[..., -1:]


def cls_to_flow_refine(cls_logits: torch.Tensor,
                       mode: torch.Tensor | None = None) -> torch.Tensor:
    """Anchor classifier -> flow: argmax (first index on ties) and its
    4 neighbours, clipped to the grid, averaged by their probabilities
    (ref roma.py:1091-1121). cls_logits: (B, H, W, res^2); `mode`, (B, H,
    W) anchor indices, takes the argmax's place where given (chip_smoke.py
    phase 31 pins one run's anchors in another). Returns (B, H, W, 2)
    normalized flow."""
    C = cls_logits.shape[-1]
    res = round(math.sqrt(C))
    lin = torch.linspace(-1 + 1 / res, 1 - 1 / res, res,
                         device=cls_logits.device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    G = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)      # (C, 2)
    probs = torch.softmax(cls_logits, dim=-1)
    if mode is None:
        mode = probs.argmax(dim=-1)
    idx = torch.stack([mode - 1, mode, mode + 1, mode - res, mode + res],
                      dim=-1).clamp(0, C - 1)
    neigh = probs.gather(-1, idx)                                  # (.., 5)
    flow = (neigh[..., None] * G[idx]).sum(-2)
    return flow / neigh.sum(-1, keepdim=True)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class RoMaDecoder(nn.Module):
    def __init__(self, cfg: RoMaConfig, train_mode: bool = False):
        super().__init__()
        self.train_mode = train_mode
        self.dtype = torch_dtype(cfg.dtype)
        self.embedding_decoder = TransformerDecoder(
            cfg.decoder_dim, cfg.cls_to_coord_res ** 2 + 1,
            cfg.num_decoder_blocks, cfg.dtype)
        self.gps = nn.ModuleDict({"16": GP(512)})
        self.proj = nn.ModuleDict({
            s: nn.Sequential(nn.Conv2d(cin, cout, 1), nn.BatchNorm2d(cout))
            for s, (cin, cout) in PROJ_SPECS.items()})
        self.conv_refiner = nn.ModuleDict({
            s: ConvRefiner(i, h, displacement_emb_dim=e, local_corr_radius=r,
                           disp_first=True, dtype=cfg.dtype,
                           train_mode=train_mode)
            for s, (i, h, e, r) in ROMA_REFINER_SPECS.items()})

    def forward(self, f1: dict, f2: dict, upsample: bool = False,
                flow: torch.Tensor | None = None,
                certainty: torch.Tensor | None = None,
                scale_factor: float = 1.0) -> dict:
        """f1, f2: {scale: (B, C, H, W)}. Coarse pass (upsample=False) from
        scale 16, or upsample pass from scale 8 starting at `flow` (B, h,
        w, 2) and `certainty` (B, h, w, 1). Returns {scale: {"flow",
        "certainty"[, "gm_cls", "gm_certainty"]}}."""
        dt = self.dtype
        scales = ["8", "4", "2", "1"] if upsample else \
            ["16", "8", "4", "2", "1"]
        sizes = {s: tuple(f1[s].shape[-2:]) for s in f1}
        H, W = sizes[1]
        B = f1[1].shape[0]
        dev = f1[1].device
        coarsest = int(scales[0])
        if not upsample:
            flow = coords_grid(B, *sizes[coarsest], dev)
            certainty = torch.zeros((B, *sizes[coarsest], 1), device=dev)
        else:
            flow = resize_nhwc(flow, *sizes[coarsest])
            certainty = resize_nhwc(certainty, *sizes[coarsest])

        out = {}
        refine_init = 4
        for s in scales:
            ins = int(s)
            proj = self.proj[s]
            train = self.train_mode
            f1_s = batchnorm(proj[1], conv(proj[0], f1[ins], dt), dt, train)
            f2_s = batchnorm(proj[1], conv(proj[0], f2[ins], dt), dt, train)
            if ins == 16 and not upsample:
                gp_post = self.gps["16"](_nhwc(f1_s), _nhwc(f2_s))
                cls_logits, certainty = self.embedding_decoder(gp_post,
                                                               _nhwc(f1_s))
                flow = cls_to_flow_refine(cls_logits).detach()
                out[ins] = {"gm_cls": cls_logits, "gm_certainty": certainty}
            else:
                out[ins] = {}
            refiner = functools.partial(self.conv_refiner[s],
                                        emb_scale=40.0 / 32.0 * scale_factor)
            if train:
                delta_cert, disp = recomputed(refiner, f1_s, f2_s, flow)
            else:
                delta_cert, disp = refiner(f1_s, f2_s, flow)
            displacement = torch.stack([
                ins * disp[..., 0] / (refine_init * W),
                ins * disp[..., 1] / (refine_init * H)], dim=-1)
            flow = flow + displacement
            certainty = certainty + delta_cert
            out[ins].update({"certainty": certainty, "flow": flow})
            if s != "1":
                nxt = sizes[ins // 2]
                flow = resize_nhwc(flow, *nxt).detach()
                certainty = resize_nhwc(certainty, *nxt).detach()
        return out


class RoMaMatcher(nn.Module):
    """Symmetric two-pass dense matcher (ref roma.py:815-917); in
    `train_mode` the decoder's training graph (module docstring)."""

    def __init__(self, cfg: RoMaConfig, train_mode: bool = False):
        super().__init__()
        self.cfg = cfg
        self.train_mode = train_mode
        self.encoder = nn.ModuleDict({"cnn": VGG19(cfg.dtype)})
        self.decoder = RoMaDecoder(cfg, train_mode)
        self.dinov2 = DinoViT(depth=cfg.dino_depth, dtype=cfg.dtype)

    def pyramids(self, q: torch.Tensor, s: torch.Tensor, upsample: bool):
        """q, s: (B, 3, h, w). Returns the query-side and support-side
        pyramids of the batch [q; s], {scale: (2B, C, H, W)}."""
        x = torch.cat([q, s], dim=0)
        feats = self.encoder["cnn"](x)
        if not upsample:
            with torch.no_grad():                       # the frozen trunk
                tokens = self.dinov2(x)                 # (2B, hp wp, 1024)
            B2, _, H, W = x.shape
            feats[16] = tokens.reshape(B2, H // 14, W // 14, -1).permute(
                0, 3, 1, 2)
        B = q.shape[0]
        f_s = {k: torch.cat([v[B:], v[:B]], dim=0) for k, v in feats.items()}
        return feats, f_s

    def train_corresps(self, im0: torch.Tensor, im1: torch.Tensor) -> dict:
        """The training pass (`model.py:234-246`): im0, im1 (B, 3, H, W)
        resized to coarse_res, one symmetric decoder pass, no upsample
        pass. Returns {scale: {"flow" (2B, h, w, 2), "certainty" (2B, h,
        w, 1)[, "gm_cls", "gm_certainty" at 16]}}; rows B..2B match image
        1 to image 0."""
        r = self.cfg.coarse_res
        q = resize_nhwc(_nhwc(im0.float()), r, r).permute(0, 3, 1, 2)
        s = resize_nhwc(_nhwc(im1.float()), r, r).permute(0, 3, 1, 2)
        return self.decoder(*self.pyramids(q, s, False))

    def forward(self, im0: torch.Tensor, im1: torch.Tensor,
                extent0: torch.Tensor | None = None,
                extent1: torch.Tensor | None = None):
        """im0, im1: (B, 3, H, W) float [0, 1] canvases; extent0/1:
        optional (B, 2) (w_frac, h_frac) of valid content, resampled
        straight to the square model resolution (the reference ZEB
        protocol). Returns (warp (B, hs, 2 ws, 4), certainty (B, hs, 2 ws)).
        """
        c = self.cfg
        B = im0.shape[0]
        q = _nhwc(im0.float())
        s = _nhwc(im1.float())
        hs = ws = c.coarse_res

        def rsz(x, h, w, extent):
            if extent is None:
                return resize_nhwc(x, h, w)
            return resize_region_nhwc(x, h, w, extent)

        def nchw(x):
            return x.permute(0, 3, 1, 2)

        f_q, f_s = self.pyramids(nchw(rsz(q, hs, ws, extent0)),
                                 nchw(rsz(s, hs, ws, extent1)), False)
        corresps = self.decoder(f_q, f_s)

        if c.upsample_preds:
            hs, ws = c.upsample_res
        low_res_certainty = 0.0
        if c.attenuate_cert:
            lrc = resize_nhwc(corresps[16]["certainty"], hs, ws)
            low_res_certainty = 0.5 * lrc * (lrc < 0)

        if c.upsample_preds:
            sf = math.sqrt(c.upsample_res[0] * c.upsample_res[1]
                           / (c.coarse_res * c.coarse_res))
            f_q, f_s = self.pyramids(nchw(rsz(q, hs, ws, extent0)),
                                     nchw(rsz(s, hs, ws, extent1)), True)
            corresps = self.decoder(f_q, f_s, upsample=True,
                                    flow=corresps[1]["flow"],
                                    certainty=corresps[1]["certainty"],
                                    scale_factor=sf)

        flow = corresps[1]["flow"]
        certainty = torch.sigmoid(corresps[1]["certainty"]
                                  - low_res_certainty)[..., 0]
        wrong = (flow.abs() > 1).any(dim=-1)
        certainty = torch.where(wrong, 0.0, certainty)

        def black(im, extent):
            if extent is None:
                m = (im < 0.03125).all(dim=-1)                    # (B, H, W)
                iy = nearest_indices(m.shape[1], hs).to(m.device)
                ix = nearest_indices(m.shape[2], ws).to(m.device)
                return m[:, iy][:, :, ix]
            return (rsz(im, hs, ws, extent) < 0.03125).all(dim=-1)

        bm = torch.cat([black(q, extent0), black(s, extent1)], dim=0)
        certainty = torch.where(bm, 0.0, certainty)

        flow = flow.clamp(-1, 1)
        grid = coords_grid(B, hs, ws, flow.device)
        a2b, b2a = flow[:B], flow[B:]
        warp = torch.cat([torch.cat([grid, a2b], dim=-1),
                          torch.cat([b2a, grid], dim=-1)], dim=2)
        cert = torch.cat([certainty[:B], certainty[B:]], dim=2)
        return warp, cert
