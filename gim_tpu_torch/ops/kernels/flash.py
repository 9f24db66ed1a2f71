"""Flash (online-softmax) attention (kernel K3, CUDA C++ for Hopper).

Port of `gim_tpu/ops/pallas_kernels/flash.py:flash_sdpa`: unmasked
softmax(q k^T / sqrt(D)) v over q, k, v of shape (..., N, D), without
writing the (N, N) matrix to device memory. The kernel
(`csrc/flash.cu`) takes D in {64, 128} (the DINOv2 ViT-L heads and the
RoMa coordinate decoder's), bf16 on the tensor cores or float32 through
FMA, and masks the ragged query and key edges itself.

`flash_sdpa` takes the plain version `flash_sdpa_plain` (the einsum +
softmax of `ops.attention.sdpa`) only for CPU tensors; for a CUDA tensor
it launches the kernel or raises. `LAUNCHES` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from gim_tpu_torch.ops.attention import sdpa
from gim_tpu_torch.ops.kernels.build import load_library

BLOCK_Q = 64          # query rows per block; must match BQ in csrc/flash.cu
HEAD_DIMS = (64, 128)

LAUNCHES = {"flash_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _lib():
    lib = load_library("flash")
    if not getattr(lib, "_gim_typed", False):
        lib.flash_block_rows.argtypes = []
        lib.flash_block_rows.restype = _I
        lib.flash_attention.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I,
                                        ctypes.c_float, _P]
        lib.flash_attention.restype = _I
        if lib.flash_block_rows() != BLOCK_Q:
            raise RuntimeError("csrc/flash.cu BQ differs from BLOCK_Q")
        lib._gim_typed = True
    return lib


def flash_sdpa_plain(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: `sdpa` without a mask."""
    return sdpa(q, k, v)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v for contiguous q, k, v (..., N, D) of one
    shape and dtype (bf16 or float32). Returns q's shape and dtype."""
    if q.device.type == "cpu":
        return flash_sdpa_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash takes bf16 or float32 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() < 2 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (..., N, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    N, D = q.shape[-2:]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash takes contiguous tensors only")
    G = q.numel() // (N * D)
    if N < 1 or G < 1 or G > 65535:
        raise ValueError(f"bad attention shape {tuple(q.shape)}")
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention(_DTYPE_CODE[q.dtype], q.data_ptr(),
                                  k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  G, N, D, float(D ** -0.5), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return o
