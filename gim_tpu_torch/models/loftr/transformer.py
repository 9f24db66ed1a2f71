"""LoFTR transformer: sine positional encoding + linear-attention encoder.

Port of `gim_tpu/models/loftr/transformer.py` (reference:
PositionEncodingSine with the legacy temp_bug_fix=False divisor, ref
networks/loftr/utils/position_encoding.py:6-43, and LoFTREncoderLayer /
LocalFeatureTransformer, ref networks/loftr/submodules/transformer.py:
7-101).

LayerNorm eps is 1e-6, the flax default the JAX package runs with; the
reference torch LoFTR uses torch's 1e-5 (see ROADMAP, Queue 3).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from gim_tpu_torch.ops.attention import full_attention, linear_attention

LN_EPS = 1e-6


def sine_pos_encoding(d_model: int, h: int, w: int,
                      temp_bug_fix: bool = False) -> np.ndarray:
    """(h*w, d_model) sinusoidal 2D encoding (ref position_encoding.py:22-36).

    The legacy divisor `-math.log(10000.0) / d_model // 2` binds as
    `(-log(10000.0) / d_model) // 2`, a floor division: for d_model=256 it
    is -1.0. The shipped weights were trained with it.
    """
    y_pos = np.cumsum(np.ones((h, w)), axis=0)
    x_pos = np.cumsum(np.ones((h, w)), axis=1)
    if temp_bug_fix:
        div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32)
                     * (-math.log(10000.0) / (d_model // 2)))
    else:
        div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32)
                     * ((-math.log(10000.0) / d_model) // 2))
    div = div[:, None, None]
    pe = np.zeros((d_model, h, w), dtype=np.float32)
    pe[0::4] = np.sin(x_pos[None] * div)
    pe[1::4] = np.cos(x_pos[None] * div)
    pe[2::4] = np.sin(y_pos[None] * div)
    pe[3::4] = np.cos(y_pos[None] * div)
    return pe.reshape(d_model, h * w).T  # (L, C)


class LoFTREncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, attention: str = "linear"):
        super().__init__()
        self.nhead = nhead
        self.dim = d_model // nhead
        self.attention = attention
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(
            nn.Linear(2 * d_model, 2 * d_model, bias=False), nn.ReLU(),
            nn.Linear(2 * d_model, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, source, x_mask=None, source_mask=None):
        B, L, C = x.shape
        q = self.q_proj(x).view(B, L, self.nhead, self.dim)
        k = self.k_proj(source).view(B, -1, self.nhead, self.dim)
        v = self.v_proj(source).view(B, -1, self.nhead, self.dim)
        attn = (linear_attention if self.attention == "linear"
                else full_attention)
        msg = attn(q, k, v, x_mask, source_mask).reshape(B, L, C)
        msg = self.norm1(self.merge(msg.to(x.dtype)))
        msg = self.mlp(torch.cat([x, msg], dim=2))
        return x + self.norm2(msg)


class LocalFeatureTransformer(nn.Module):
    """Alternating (self, cross) x n_pairs stack (ref transformer.py:61-101).

    `layers` holds self and cross layers alternately, as the reference's
    ModuleList does (`layers.{2i}` self, `layers.{2i+1}` cross)."""

    def __init__(self, d_model: int, nhead: int, n_pairs: int,
                 attention: str = "linear"):
        super().__init__()
        self.layers = nn.ModuleList(
            LoFTREncoderLayer(d_model, nhead, attention)
            for _ in range(2 * n_pairs))

    def forward(self, feat0, feat1, mask0=None, mask1=None):
        for i in range(0, len(self.layers), 2):
            slayer, clayer = self.layers[i], self.layers[i + 1]
            feat0 = slayer(feat0, feat0, mask0, mask0)
            feat1 = slayer(feat1, feat1, mask1, mask1)
            # feat0 is updated before feat1 reads it (transformer.py:114-115)
            feat0 = clayer(feat0, feat1, mask0, mask1)
            feat1 = clayer(feat1, feat0, mask1, mask0)
        return feat0, feat1
