"""Attention primitives: elu+1 linear attention, full attention, sdpa,
and LightGlue's rotary encoding.

Port of `gim_tpu/ops/attention.py:21-134` (reference semantics: LoFTR
LinearAttention and FullAttention, ref networks/loftr/submodules/
attentions.py:14-81; torch SDPA for the ViTs and LightGlue; LightGlue's
rotary position encoding, ref matchers/lightglue.py:36-44). Layouts are
[N, L, H, D] as in the JAX package, and [..., H, L, D] for `sdpa`.

The JAX package has two forms of linear attention: the head-split
`linear_attention` and `linear_attention_chan`, which computes the same
per-head contractions as masked C x C matmuls to keep the TPU's lanes
full. Both are one function here: `linear_attention` in the head-split
layout, whose contractions are batched matmuls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def elu_feature_map(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_mask: torch.Tensor | None = None,
                     kv_mask: torch.Tensor | None = None,
                     eps: float = 1e-6) -> torch.Tensor:
    """elu+1 linear attention. q: [N,L,H,D], k/v: [N,S,H,D] -> [N,L,H,D].

    masks: (N, L) / (N, S) bool; masked queries and keys/values are zeroed
    (gim_tpu/ops/attention.py:32-36).
    """
    Q = elu_feature_map(q)
    K = elu_feature_map(k)
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].to(Q.dtype)
    if kv_mask is not None:
        kvm = kv_mask[:, :, None, None].to(K.dtype)
        K = K * kvm
        v = v * kvm
    s = v.shape[1]
    v = v / s  # fp16/bf16 overflow guard, mirrors reference
    KV = torch.einsum("nshd,nshv->nhdv", K, v)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv->nlhv", Q, KV) * Z[..., None] * s


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_mask: torch.Tensor | None = None,
                   kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax attention with 1/sqrt(D) temperature. [N,L,H,D] layout."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qk = torch.einsum("nlhd,nshd->nlsh", q, k)
    if kv_mask is not None:
        qm = (q_mask if q_mask is not None
              else torch.ones(q.shape[:2], dtype=torch.bool, device=q.device))
        mask = qm[:, :, None, None] & kv_mask[:, None, :, None]
        qk = qk.masked_fill(~mask, float("-inf"))
    a = torch.softmax(scale * qk, dim=2)
    if kv_mask is not None:
        a = torch.nan_to_num(a)  # rows fully masked
    return torch.einsum("nlsh,nshd->nlhd", a, v)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention in [..., L, D] layout (the torch SDPA
    contract): softmax(q k^T / sqrt(D)) v, computed in q's dtype.
    mask: bool, broadcast to [..., L, S], True = attend."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qk = (q @ k.transpose(-1, -2)) * scale
    if mask is not None:
        qk = qk.masked_fill(~mask, float("-inf"))
    a = torch.softmax(qk, dim=-1)
    if mask is not None:
        a = torch.nan_to_num(a)
    return a @ v


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Pairwise (-x2, x1) rotation on the last dim, in the reference's
    unflatten(-1, (-1, 2)) layout (`gim_tpu/ops/attention.py:123-128`)."""
    x = x.unflatten(-1, (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def apply_rotary(x: torch.Tensor, encoding: torch.Tensor) -> torch.Tensor:
    """encoding: stacked (2, ..., D) [cos, sin] of the learnable Fourier
    position encoding (`gim_tpu/ops/attention.py:131-134`)."""
    return x * encoding[0] + rotate_half(x) * encoding[1]
