"""Attention primitives: elu+1 linear attention and full attention.

Port of `gim_tpu/ops/attention.py:21-106` (reference semantics: LoFTR
LinearAttention and FullAttention, ref networks/loftr/submodules/
attentions.py:14-81). Layouts are [N, L, H, D] as in the JAX package.

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
