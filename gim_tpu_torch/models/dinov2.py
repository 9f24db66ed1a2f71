"""DINOv2 ViT-L/14, the frozen coarse encoder of gim_roma (PyTorch port).

Port of `gim_tpu/models/dinov2.py:27-154` (ref networks/roma/dino.py:
DinoVisionTransformer :322, vit_large :621, Attention :54-91, LayerScale
:182, Mlp :27, bicubic pos-embed interpolation :457-487). Parameter names
are the DINOv2 hub checkpoint's (`blocks.{i}.attn.qkv`, `patch_embed.proj`,
...).

Attention runs as kernel K3 (`ops/kernels/flash.py`) where
`forward_only.on_kernel` holds (a card tensor in inference mode), else as
the plain `sdpa`, the JAX default graph.
`Block` is also the RoMa coordinate decoder's block (no layer scale, no
qkv bias, head dim 128).

Dtypes follow the JAX graph: LayerNorms compute and return float32, every
Dense and the patch conv run at `dtype`, and the residual stream is
float32 (the float32 class and position tokens promote it, and each
block adds its `dtype` output to it).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gim_tpu_torch.models.common import conv, dense, layernorm
from gim_tpu_torch.ops.attention import sdpa
from gim_tpu_torch.ops.kernels import forward_only
from gim_tpu_torch.ops.kernels.flash import flash_sdpa
from gim_tpu_torch.ops.resize import bicubic_matrix
from gim_tpu_torch.utils.device import torch_dtype


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: str = "float32"):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = torch_dtype(dtype)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        qkv = dense(self.qkv, x, self.dtype).reshape(
            B, N, 3, self.num_heads, C // self.num_heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)                       # (B, H, N, hd) views
        if forward_only.on_kernel(q):
            # the kernel reads the strided views in place; on the card its
            # output is a view of a (B, N, H, hd) buffer, so the merge of
            # the heads below is a view too
            out = flash_sdpa(q, k, v)
        else:
            out = sdpa(q, k, v)
        out = out.transpose(1, 2).reshape(B, N, C)
        return dense(self.proj, out, self.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: str = "float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(dense(self.fc1, x, self.dtype), approximate="none")
        return dense(self.fc2, h, self.dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layerscale: bool = True, qkv_bias: bool = True,
                 dtype: str = "float32"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        self.ls1 = LayerScale(dim) if layerscale else None
        self.ls2 = LayerScale(dim) if layerscale else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(layernorm(self.norm1, x))
        if self.ls1 is not None:
            h = self.ls1(h)
        x = x + h
        h = self.mlp(layernorm(self.norm2, x))
        if self.ls2 is not None:
            h = self.ls2(h)
        return x + h


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)


class DinoViT(nn.Module):
    """ViT-L/14 trunk returning normalized patch tokens."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, patch_size: int = 14,
                 pretrain_img_size: int = 518, dtype: str = "float32"):
        super().__init__()
        self.embed_dim = embed_dim
        self.n0 = pretrain_img_size // patch_size
        self.dtype = torch_dtype(dtype)
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.n0 * self.n0 + 1, embed_dim))
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads, dtype=dtype)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def interpolate_pos(self, hp: int, wp: int) -> torch.Tensor:
        """(1, 1 + hp wp, D) position tokens: the patch grid resized from
        n0 x n0 by `jax.image.resize(..., "bicubic")` (ops/resize.py)."""
        D, n0 = self.embed_dim, self.n0
        cls_pos = self.pos_embed[:, :1]
        patch = self.pos_embed[0, 1:].reshape(n0, n0, D)
        if (hp, wp) != (n0, n0):
            dev = patch.device
            mh = bicubic_matrix(n0, hp).to(dev)
            mw = bicubic_matrix(n0, wp).to(dev)
            patch = torch.einsum("ih,hwd->iwd", mh, patch)
            patch = torch.einsum("jw,iwd->ijd", mw, patch)
        return torch.cat([cls_pos, patch.reshape(1, hp * wp, D)], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W), H and W multiples of 14. Returns (B, H/14 *
        W/14, embed_dim) float32 patch tokens after the final norm."""
        B = x.shape[0]
        patches = conv(self.patch_embed.proj, x, self.dtype)  # (B, D, h, w)
        hp, wp = patches.shape[-2:]
        tokens = patches.flatten(2).transpose(1, 2).float()
        tokens = torch.cat([self.cls_token.expand(B, 1, -1), tokens], dim=1)
        tokens = tokens + self.interpolate_pos(hp, wp)
        for blk in self.blocks:
            tokens = blk(tokens)
        return layernorm(self.norm, tokens)[:, 1:]
