"""gim_loftr matcher: backbone -> coarse linear-attention transformer ->
dual-softmax mutual matching -> fine window refinement.

Port of `gim_tpu/models/loftr/model.py:34-63` (FinePreprocess), `:66-103`
(`_mix_gt_padding`) and `:106-219` (LoFTRMatcher, both branches);
reference: networks/loftr/loftr.py:43-91, utils/coarse_matching.py,
submodules/fine_preprocess.py, utils/fine_matching.py. Both images run
through the backbone as one batch; dynamic match selection is a static
`max_matches` cap with validity masks; fine windows are gathered only at
the selected matches.

Training (`train_mode=True`): every BatchNorm uses the batch's statistics,
the coarse matching is the dense float32 dual-softmax (the fused kernel
K1 has no backward, and the loss needs `conf_matrix` whole), and ground
truth pads the fine stage's slots (`_mix_gt_padding`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from gim_tpu_torch.config import LoFTRConfig
from gim_tpu_torch.models.loftr.backbone import ResNetFPN
from gim_tpu_torch.models.loftr.transformer import (LocalFeatureTransformer,
                                                    sine_pos_encoding)
from gim_tpu_torch.ops.matching import (cells_to_kpts, dual_softmax,
                                        fine_expectation, fused_mutual_topk,
                                        mutual_topk_matches)
from gim_tpu_torch.ops.windows import extract_windows_batch
from gim_tpu_torch.parallel import mesh


class FinePreprocess(nn.Module):
    """Window gather + optional coarse-context merge (ref fine_preprocess.py)."""

    def __init__(self, cfg: LoFTRConfig):
        super().__init__()
        self.window = cfg.fine_window_size
        self.concat = cfg.fine_concat_coarse_feat
        if self.concat:
            self.down_proj = nn.Linear(cfg.d_model_c, cfg.d_model_f)
            self.merge_feat = nn.Linear(2 * cfg.d_model_f, cfg.d_model_f)

    def forward(self, feat_f0, feat_f1, feat_c0, feat_c1, i_ids, j_ids,
                stride: int):
        """feat_f0/1: (B, Hf, Wf, Cf); feat_c0/1: (B, L, Cc); ids: (B, M).
        Returns window features (B, M, W*W, Cf) for both images."""
        W = self.window
        f0 = extract_windows_batch(feat_f0, i_ids, window=W, stride=stride)
        f1 = extract_windows_batch(feat_f1, j_ids, window=W, stride=stride)
        if self.concat:
            def coarse(feat_c, ids):
                idx = ids.long()[..., None].expand(-1, -1, feat_c.shape[-1])
                c = self.down_proj(torch.gather(feat_c, 1, idx))
                return c[:, :, None, :].expand(-1, -1, W * W, -1)

            f0 = self.merge_feat(torch.cat([f0, coarse(feat_c0, i_ids)], -1))
            f1 = self.merge_feat(torch.cat([f1, coarse(feat_c1, j_ids)], -1))
        return f0, f1


# the JAX train step passes no rngs, so its GT padding draws from
# PRNGKey(0) on every step (gim_tpu/models/loftr/model.py:75); the port
# draws from a generator seeded this, on every step
PAD_SEED = 0


def padding_draws(B: int, M: int, G: int, device):
    """The two draws of `_mix_gt_padding`, from a generator on `device`
    seeded PAD_SEED: uniforms (B, M) for the shuffle and standard Gumbel
    noise (B, M, G) for the categorical choice of GT pairs (the JAX
    package's `jax.random.uniform` and, inside `categorical`,
    `jax.random.gumbel`: -log(-log(u)), u in [tiny, 1)).

    Under a process group (`parallel.mesh.in_group`) they are the global
    batch's draws (every process holds B pairs), of which this process
    takes its B rows."""
    n, r = mesh.world_size(), mesh.rank()
    rows = slice(r * B, (r + 1) * B)
    g = torch.Generator(device=device).manual_seed(PAD_SEED)
    uniform = torch.rand((n * B, M), generator=g, device=device)[rows]
    u = torch.rand((n * B, M, G), generator=g, device=device)[rows]
    if n > 1:               # not a view holding the other processes' rows
        u = u.clone()
    tiny = torch.finfo(torch.float32).tiny
    return uniform, u.clamp_min_(tiny).log_().neg_().log_().neg_()


def _mix_gt_padding(m: dict, spv: dict, pad_min: int,
                    uniform: torch.Tensor, gumbel: torch.Tensor) -> dict:
    """Static-shape train-time coarse sampling (ref
    coarse_matching.py:199-234): the M fine-stage slots hold the predicted
    matches, shuffled with valid ones first, in the first M - pad_min
    slots (GT-backfilled where the prediction slot is invalid) and GT
    pairs in the last pad_min slots; GT-padded slots carry mconf 0.

    uniform: (B, M) in [0, 1), the shuffle's keys; gumbel: (B, M, G)
    standard Gumbel noise. The GT pair of each slot is
    argmax(log-uniform over valid GT + gumbel), which is what
    `jax.random.categorical` computes, so JAX's draws give its choice.
    """
    M = m["i_ids"].shape[-1]
    pad_min = min(pad_min, M // 2)
    n_keep = M - pad_min

    # shuffle predictions, valid first; ties keep jax.lax.top_k's
    # lower-index-first order (a stable descending sort)
    score = m["valid"].float() * 2.0 + uniform
    keep = torch.sort(score, dim=1, descending=True, stable=True)[1]
    i_p = torch.gather(m["i_ids"], 1, keep)
    j_p = torch.gather(m["j_ids"], 1, keep)
    c_p = torch.gather(m["mconf"], 1, keep)
    v_p = torch.gather(m["valid"], 1, keep)

    # a GT candidate for every slot, uniform over the valid GT pairs with
    # replacement (the reference's torch.randint)
    logits = torch.where(spv["valid"], 0.0, -1e9)
    gidx = (logits[:, None, :] + gumbel).argmax(-1)
    i_g = torch.gather(spv["i_ids"].to(i_p.dtype), 1, gidx)
    j_g = torch.gather(spv["j_ids"].to(j_p.dtype), 1, gidx)
    v_g = torch.gather(spv["valid"], 1, gidx)

    slot = torch.arange(M, device=score.device)[None, :]
    use_pred = (slot < n_keep) & v_p
    out = dict(m)
    out["i_ids"] = torch.where(use_pred, i_p, i_g)
    out["j_ids"] = torch.where(use_pred, j_p, j_g)
    out["mconf"] = torch.where(use_pred, c_p, 0.0)
    out["valid"] = use_pred | v_g
    return out


def _coarse_masks(mask: torch.Tensor, step: int):
    """(B, H, W) content mask -> flattened coarse mask (B, hc*wc) and the
    content extent in cells (B, 2) as (h, w) (model.py:149-157)."""
    mc = mask[:, ::step, ::step]
    true_hw = torch.stack([mc.sum(1).amax(-1), mc.sum(2).amax(-1)],
                          dim=-1).int()
    return mc.reshape(mc.shape[0], -1), true_hw


class LoFTRMatcher(nn.Module):
    def __init__(self, cfg: LoFTRConfig, train_mode: bool = False):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.train_mode = train_mode
        self.backbone = ResNetFPN(c.block_dims)
        self.loftr_coarse = LocalFeatureTransformer(
            c.d_model_c, c.nhead_c, c.layer_names_c, c.attention_c)
        self.fine_preprocess = FinePreprocess(c)
        self.loftr_fine = LocalFeatureTransformer(
            c.d_model_f, c.nhead_f, c.layer_names_f, c.attention_f)

    def forward(self, color0, color1, scale0=None, scale1=None,
                mask0=None, mask1=None, spv=None, uniform=None, gumbel=None):
        """color0/1: (B, 3, H, W) float [0,1]; scale0/1: (B, 2) [w/w', h/h'];
        mask0/1: (B, H, W) bool content masks for padded canvases.

        spv (train only): dict with i_ids/j_ids (B, G) ground-truth coarse
        cell pairs and valid (B, G), which enables the train-time GT
        padding of the fine slots (`_mix_gt_padding`); uniform (B, M) and
        gumbel (B, M, G) are its draws, by default `padding_draws` with
        the fixed seed on the input's device.

        Returns dict: mkpts0_f/mkpts1_f (B, M, 2) in ORIGINAL image pixels,
        mconf (B, M), valid (B, M), plus the coarse tensors (conf_matrix
        (B, L, S) on the dense path, which training always takes).
        """
        c = self.cfg
        dt = self.backbone.encode.conv1.weight.dtype
        B, _, H, W = color0.shape
        hc, wc = H // c.resolution[0], W // c.resolution[0]
        stride = c.resolution[0] // c.resolution[1]

        x = torch.cat([color0, color1], dim=0).to(dt)
        feat_c, feat_f = self.backbone(x, self.train_mode)
        feat_c = feat_c.flatten(2).transpose(1, 2)             # (2B, L, C)
        feat_f = feat_f.permute(0, 2, 3, 1).contiguous()       # NHWC

        pe = torch.from_numpy(sine_pos_encoding(c.d_model_c, hc, wc,
                                                c.temp_bug_fix))
        feat_c = feat_c + pe.to(device=feat_c.device, dtype=dt)[None]
        f0, f1 = feat_c[:B], feat_c[B:]

        mask_c0 = mask_c1 = true_hw0 = true_hw1 = None
        if mask0 is not None:
            mask_c0, true_hw0 = _coarse_masks(mask0, c.resolution[0])
            mask_c1, true_hw1 = _coarse_masks(mask1, c.resolution[0])

        f0, f1 = self.loftr_coarse(f0, f1, mask_c0, mask_c1)

        # coarse matching: the dense path runs float32; the fused kernel
        # keeps the model dtype for its products (float32 accumulation and
        # float32 softmax statistics inside)
        norm = math.sqrt(c.d_model_c)
        conf = None
        kw = dict(hw0_c=(hc, wc), hw1_c=(hc, wc), threshold=c.match_threshold,
                  border=c.border_rm, max_matches=c.max_matches,
                  true_hw0=true_hw0, true_hw1=true_hw1)
        if c.fused_matching and not self.train_mode:
            m = fused_mutual_topk(f0 / norm, f1 / norm, c.dsmax_temperature,
                                  mask_c0, mask_c1, **kw)
        else:
            n0 = f0.float() / norm
            n1 = f1.float() / norm
            sim = torch.einsum("nlc,nsc->nls", n0, n1)
            conf = dual_softmax(sim, c.dsmax_temperature, mask_c0, mask_c1)
            m = mutual_topk_matches(conf, **kw)

        if self.train_mode and spv is not None:
            if uniform is None:
                uniform, gumbel = padding_draws(
                    B, c.max_matches, spv["valid"].shape[1], color0.device)
            m = _mix_gt_padding(m, spv, c.train_pad_num_gt_min, uniform,
                                gumbel)

        # fine refinement
        ff0, ff1 = self.fine_preprocess(feat_f[:B], feat_f[B:], f0, f1,
                                        m["i_ids"], m["j_ids"], stride)
        M = c.max_matches
        WW = c.fine_window_size ** 2
        ff0 = ff0.reshape(B * M, WW, c.d_model_f)
        ff1 = ff1.reshape(B * M, WW, c.d_model_f)
        ff0, ff1 = self.loftr_fine(ff0, ff1)
        coords_n, std = fine_expectation(ff0.float(), ff1.float())
        coords_n = coords_n.reshape(B, M, 2)
        std = std.reshape(B, M)

        # pixel coordinates at original resolution
        scale_c = float(c.resolution[0])
        scale_f = float(c.resolution[1])
        s0 = scale_c if scale0 is None else scale_c * scale0[:, None, :]
        s1 = scale_c if scale1 is None else scale_c * scale1[:, None, :]
        s1f = scale_f if scale1 is None else scale_f * scale1[:, None, :]
        mkpts0_c = cells_to_kpts(m["i_ids"], wc, s0)
        mkpts1_c = cells_to_kpts(m["j_ids"], wc, s1)
        # fine correction: +/- (W//2) fine cells (ref fine_matching.py:63-69)
        mkpts1_f = mkpts1_c + coords_n * (c.fine_window_size // 2) * s1f

        return {
            "mkpts0_f": mkpts0_c,
            "mkpts1_f": mkpts1_f,
            "mkpts0_c": mkpts0_c,
            "mkpts1_c": mkpts1_c,
            "mconf": m["mconf"],
            "valid": m["valid"],
            "i_ids": m["i_ids"],
            "j_ids": m["j_ids"],
            "conf_matrix": conf,
            "expec_f": torch.cat([coords_n, std[..., None]], -1),
            "hw_c": (hc, wc),
        }
