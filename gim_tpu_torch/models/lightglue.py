"""LightGlue sparse matcher (port of `gim_tpu/models/lightglue.py`).

Reference: networks/lightglue/models/matchers/lightglue.py: learnable
Fourier rotary position encoding (:46-59), n_layers of SelfBlock
(:125-157) and bidirectional CrossBlock with one shared FFN (:160-215),
sigmoid-log-double-softmax assignment with dustbins (:250-281) and the
mutual filter (:287-304). As in the JAX package, the depth is static (the
reference's early exit and pruning are off by default, :316-317, and
`TokenConfidence` is not ported), padded keypoint slots are masked in the
attention, and attention is plain batched matmuls: the JAX package runs
these products outside any Pallas kernel.

Two choices follow the JAX package where it departs from the reference:
flax's `nn.gelu` is the tanh approximation (the reference's `nn.GELU()`
is exact) and flax's `nn.LayerNorm` has eps 1e-6 (the reference's 1e-5).

Parameter names are the reference's state-dict keys, as
`gim_tpu/weights/port.py:port_lightglue` maps them: `posenc.Wr`,
`transformers.{i}.self_attn.{Wqkv,out_proj,ffn.0,ffn.1,ffn.3}`,
`transformers.{i}.cross_attn.{to_qk,to_v,to_out,ffn.*}` and
`log_assignment.{n_layers-1}.{final_proj,matchability}`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gim_tpu_torch.config import LightGlueConfig
from gim_tpu_torch.ops.attention import apply_rotary, sdpa
from gim_tpu_torch.ops.matching import (filter_matches,
                                        sigmoid_log_double_softmax)
from gim_tpu_torch.utils.profiling import span

LN_EPS = 1e-6        # flax nn.LayerNorm's default


def normalize_keypoints(kpts: torch.Tensor, size: torch.Tensor
                        ) -> torch.Tensor:
    """Centre and scale keypoints by the image size (`lightglue.py:30-35`).
    kpts: (B, K, 2); size: (B, 2) as (w, h)."""
    shift = size / 2.0
    scale = size.amax(-1) / 2.0
    return (kpts - shift[:, None, :]) / scale[:, None, None]


class FourierPosEnc(nn.Module):
    """Learnable Fourier features as rotary cos and sin (`:38-48`)."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.Wr = nn.Linear(2, head_dim // 2, bias=False)

    def forward(self, kpts: torch.Tensor) -> torch.Tensor:
        """kpts (B, K, 2) -> (2, B, 1, K, head_dim), each frequency twice
        in a row (an interleave, not a tile)."""
        proj = self.Wr(kpts)
        emb = torch.stack([torch.cos(proj), torch.sin(proj)], dim=0)
        return emb[:, :, None].repeat_interleave(2, dim=-1)


def ffn(dim: int) -> nn.Sequential:
    """Linear(2d, 2d), LayerNorm, GELU (tanh), Linear(2d, d) (`:51-61`)."""
    return nn.Sequential(nn.Linear(2 * dim, 2 * dim),
                         nn.LayerNorm(2 * dim, eps=LN_EPS),
                         nn.GELU(approximate="tanh"),
                         nn.Linear(2 * dim, dim))


class SelfBlock(nn.Module):
    """`lightglue.py:64-83`."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.Wqkv = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)
        self.ffn = ffn(dim)

    def forward(self, x: torch.Tensor, encoding: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        B, K, d = x.shape
        # the reference's unflatten(-1, (heads, head_dim, 3))
        qkv = self.Wqkv(x).reshape(B, K, self.heads, d // self.heads, 3)
        qkv = qkv.transpose(1, 2)                       # (B, H, K, hd, 3)
        q = apply_rotary(qkv[..., 0], encoding)
        k = apply_rotary(qkv[..., 1], encoding)
        ctx = sdpa(q, k, qkv[..., 2], mask)             # (B, H, K, hd)
        msg = self.out_proj(ctx.transpose(1, 2).reshape(B, K, d))
        return x + self.ffn(torch.cat([x, msg], -1))


class CrossBlock(nn.Module):
    """`lightglue.py:86-129`: one similarity for both directions, a
    softmax along each axis, and one FFN shared by both images."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_qk = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)
        self.ffn = ffn(dim)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor,
                mask: torch.Tensor | None = None):
        B, _, d = x0.shape
        hd = d // self.heads
        scale = hd ** -0.25       # the reference scales both sides

        def split(t):
            return t.unflatten(-1, (self.heads, hd)).transpose(1, 2)

        def merge(t):
            return t.transpose(1, 2).flatten(-2)

        qk0 = split(self.to_qk(x0)) * scale
        qk1 = split(self.to_qk(x1)) * scale
        v0 = split(self.to_v(x0))
        v1 = split(self.to_v(x1))
        sim = qk0 @ qk1.transpose(-1, -2)               # (B, H, K0, K1)
        if mask is not None:
            sim = sim.masked_fill(~mask, float("-inf"))
        a01 = torch.softmax(sim, dim=-1)
        a10 = torch.softmax(sim.transpose(-1, -2), dim=-1)
        m0 = a01 @ v1
        m1 = a10 @ v0
        if mask is not None:
            m0 = torch.nan_to_num(m0)
            m1 = torch.nan_to_num(m1)
        m0 = self.to_out(merge(m0))
        m1 = self.to_out(merge(m1))
        x0 = x0 + self.ffn(torch.cat([x0, m0], -1))
        x1 = x1 + self.ffn(torch.cat([x1, m1], -1))
        return x0, x1


class TransformerLayer(nn.Module):
    """One layer: a SelfBlock shared by both images, then a CrossBlock."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.self_attn = SelfBlock(dim, heads)
        self.cross_attn = CrossBlock(dim, heads)

    def forward(self, desc0, desc1, enc0, enc1, smask0=None, smask1=None,
                xmask=None):
        desc0 = self.self_attn(desc0, enc0, smask0)
        desc1 = self.self_attn(desc1, enc1, smask1)
        return self.cross_attn(desc0, desc1, xmask)


class MatchAssignment(nn.Module):
    """`lightglue.py:132-154`; padded slots get -1e9 similarity and
    matchability, so their mass lands in the dustbin."""

    def __init__(self, dim: int):
        super().__init__()
        self.final_proj = nn.Linear(dim, dim)
        self.matchability = nn.Linear(dim, 1)

    def forward(self, desc0, desc1, valid0=None, valid1=None):
        d = self.final_proj.out_features
        md0 = self.final_proj(desc0) / d ** 0.25
        md1 = self.final_proj(desc1) / d ** 0.25
        sim = md0 @ md1.transpose(-1, -2)
        z0 = self.matchability(desc0)[..., 0]
        z1 = self.matchability(desc1)[..., 0]
        if valid0 is not None:
            neg = -1e9
            sim = sim.masked_fill(~(valid0[:, :, None] & valid1[:, None, :]),
                                  neg)
            z0 = z0.masked_fill(~valid0, neg)
            z1 = z1.masked_fill(~valid1, neg)
        return sigmoid_log_double_softmax(sim, z0, z1), sim


class LightGlue(nn.Module):
    """`lightglue.py:168-214`."""

    def __init__(self, cfg: LightGlueConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.descriptor_dim
        if cfg.input_dim != d:
            self.input_proj = nn.Linear(cfg.input_dim, d)
        self.posenc = FourierPosEnc(d // cfg.num_heads)
        self.transformers = nn.ModuleList(
            TransformerLayer(d, cfg.num_heads) for _ in range(cfg.n_layers))
        # only the last layer's head: its reference key is
        # log_assignment.{n_layers - 1}
        self.log_assignment = nn.ModuleDict(
            {str(cfg.n_layers - 1): MatchAssignment(d)})

    @span("gim.lightglue")
    def forward(self, kpts0, kpts1, desc0, desc1, size0, size1,
                valid0=None, valid1=None) -> dict:
        """kpts (B, K, 2) pixels (+0.5 centred); desc (B, K, D); size
        (B, 2) as (w, h); valid (B, K) masks of padded keypoint slots."""
        c = self.cfg
        if c.input_dim != c.descriptor_dim:
            desc0, desc1 = self.input_proj(desc0), self.input_proj(desc1)
        enc0 = self.posenc(normalize_keypoints(kpts0, size0))
        enc1 = self.posenc(normalize_keypoints(kpts1, size1))
        smask0 = smask1 = xmask = None
        if valid0 is not None:
            smask0 = valid0[:, None, :, None] & valid0[:, None, None, :]
            smask1 = valid1[:, None, :, None] & valid1[:, None, None, :]
            xmask = valid0[:, None, :, None] & valid1[:, None, None, :]
        for layer in self.transformers:
            with span("gim.lightglue.layer"):
                desc0, desc1 = layer(desc0, desc1, enc0, enc1, smask0,
                                     smask1, xmask)
        with span("gim.lightglue.assign"):
            scores, _ = self.log_assignment[str(c.n_layers - 1)](
                desc0, desc1, valid0, valid1)
            m0, m1, ms0, ms1 = filter_matches(scores, c.filter_threshold)
            if valid0 is not None:
                m0 = torch.where(valid0, m0, -1)
                m1 = torch.where(valid1, m1, -1)
                ms0 = torch.where(valid0, ms0, 0.0)
                ms1 = torch.where(valid1, ms1, 0.0)
        return {"matches0": m0, "matches1": m1,
                "matching_scores0": ms0, "matching_scores1": ms1,
                "log_assignment": scores, "desc0": desc0, "desc1": desc1}
