"""gim_loftr matcher: backbone -> coarse linear-attention transformer ->
dual-softmax mutual matching -> fine window refinement (eval path).

Port of `gim_tpu/models/loftr/model.py:34-63` (FinePreprocess) and
`:106-229` (LoFTRMatcher, eval branch); reference: networks/loftr/
loftr.py:43-91, utils/coarse_matching.py, submodules/fine_preprocess.py,
utils/fine_matching.py. Both images run through the backbone as one
batch; dynamic match selection is a static `max_matches` cap with
validity masks; fine windows are gathered only at the selected matches.
The training branch (GT padding of the coarse matches) is not ported yet.
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


def _coarse_masks(mask: torch.Tensor, step: int):
    """(B, H, W) content mask -> flattened coarse mask (B, hc*wc) and the
    content extent in cells (B, 2) as (h, w) (model.py:149-157)."""
    mc = mask[:, ::step, ::step]
    true_hw = torch.stack([mc.sum(1).amax(-1), mc.sum(2).amax(-1)],
                          dim=-1).int()
    return mc.reshape(mc.shape[0], -1), true_hw


class LoFTRMatcher(nn.Module):
    def __init__(self, cfg: LoFTRConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.backbone = ResNetFPN(c.block_dims)
        self.loftr_coarse = LocalFeatureTransformer(
            c.d_model_c, c.nhead_c, c.layer_names_c, c.attention_c)
        self.fine_preprocess = FinePreprocess(c)
        self.loftr_fine = LocalFeatureTransformer(
            c.d_model_f, c.nhead_f, c.layer_names_f, c.attention_f)

    def forward(self, color0, color1, scale0=None, scale1=None,
                mask0=None, mask1=None):
        """color0/1: (B, 3, H, W) float [0,1]; scale0/1: (B, 2) [w/w', h/h'];
        mask0/1: (B, H, W) bool content masks for padded canvases.

        Returns dict: mkpts0_f/mkpts1_f (B, M, 2) in ORIGINAL image pixels,
        mconf (B, M), valid (B, M), plus the coarse tensors.
        """
        c = self.cfg
        dt = self.backbone.encode.conv1.weight.dtype
        B, _, H, W = color0.shape
        hc, wc = H // c.resolution[0], W // c.resolution[0]
        stride = c.resolution[0] // c.resolution[1]

        x = torch.cat([color0, color1], dim=0).to(dt)
        feat_c, feat_f = self.backbone(x)
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
        if c.fused_matching:
            m = fused_mutual_topk(f0 / norm, f1 / norm, c.dsmax_temperature,
                                  mask_c0, mask_c1, **kw)
        else:
            n0 = f0.float() / norm
            n1 = f1.float() / norm
            sim = torch.einsum("nlc,nsc->nls", n0, n1)
            conf = dual_softmax(sim, c.dsmax_temperature, mask_c0, mask_c1)
            m = mutual_topk_matches(conf, **kw)

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
