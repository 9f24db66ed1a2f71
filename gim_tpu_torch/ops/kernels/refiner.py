"""Fused ConvRefiner block (kernel K2, CUDA C++ for Hopper).

Port of `gim_tpu/ops/pallas_kernels/refiner.py`: one hidden block of the
DKM/RoMa ConvRefiner at inference, depthwise KxK (K = 5, SAME) with the
BatchNorm running statistics folded into its taps and bias, ReLU, then the
1x1 convolution C -> C_out plus bias, in one pass over x (B, C, H, W),
NCHW. The kernel (`csrc/refiner.cu`) takes bf16 (1x1 on the tensor cores)
or float32 (FMA), C and C_out up to 192, and masks the ragged edge itself.

`fold_block_params` folds a block's modules into the kernel's inputs.
`fused_dw_block` takes the plain version `fused_dw_block_plain` (grouped
`F.conv2d`, ReLU, 1x1 `F.conv2d` on the folded parameters) only for CPU
tensors; for a CUDA tensor it launches the kernel or raises. `LAUNCHES`
counts the launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gim_tpu_torch.ops.kernels.build import load_library

KERNEL_SIZE = 5
MAX_CHANNELS = 192    # must match MAXC in csrc/refiner.cu

LAUNCHES = {"refiner_block": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _lib():
    lib = load_library("refiner")
    if not getattr(lib, "_gim_typed", False):
        lib.refiner_max_channels.argtypes = []
        lib.refiner_max_channels.restype = _I
        lib.refiner_block.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _P]
        lib.refiner_block.restype = _I
        if lib.refiner_max_channels() != MAX_CHANNELS:
            raise RuntimeError("csrc/refiner.cu MAXC differs from "
                               "MAX_CHANNELS")
        lib._gim_typed = True
    return lib


@torch.no_grad()
def fold_block_params(conv1: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d,
                      conv2: torch.nn.Conv2d, eps: float = 1e-5):
    """Fold a block's depthwise conv, BatchNorm (running statistics) and
    1x1 conv into the kernel's inputs, in float32 (`refiner.py:180-197`).

    Returns (wdw (C, K*K) taps row-major in (dy, dx), bdw (C,), w1
    (C_out, C), b1 (C_out,))."""
    kd = conv1.weight.float()                         # (C, 1, K, K)
    C, _, K, _ = kd.shape
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + eps)
    t = bn.bias.float() - bn.running_mean.float() * s
    wdw = (kd[:, 0] * s[:, None, None]).reshape(C, K * K)
    b0 = (conv1.bias.float() if conv1.bias is not None
          else kd.new_zeros(C))
    bdw = b0 * s + t
    w1 = conv2.weight.float()[:, :, 0, 0]             # (C_out, C)
    b1 = (conv2.bias.float() if conv2.bias is not None
          else w1.new_zeros(w1.shape[0]))
    return wdw, bdw, w1, b1


def fused_dw_block_plain(x, wdw, bdw, w1, b1):
    """The kernel's plain version: grouped conv with the folded taps and
    bias, ReLU, h cast to w1's dtype, 1x1 conv; out in x's dtype."""
    C = x.shape[1]
    K = round(wdw.shape[1] ** 0.5)
    h = F.conv2d(x, wdw.reshape(C, 1, K, K).to(x.dtype), bdw.to(x.dtype),
                 padding=K // 2, groups=C)
    h = F.relu(h).to(w1.dtype)
    return F.conv2d(h, w1[:, :, None, None], b1.to(w1.dtype)).to(x.dtype)


def fused_dw_block(x: torch.Tensor, wdw: torch.Tensor, bdw: torch.Tensor,
                   w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """x: (B, C, H, W); wdw: (C, 25); bdw: (C,); w1: (C_out, C); b1:
    (C_out,), all contiguous and of x's dtype on CUDA. Returns
    (B, C_out, H, W) in x's dtype."""
    if x.device.type == "cpu":
        return fused_dw_block_plain(x, wdw, bdw, w1, b1)
    if x.device.type != "cuda":
        raise ValueError(f"refiner kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"refiner takes bf16 or float32, got {x.dtype}")
    for t in (wdw, bdw, w1, b1):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError("refiner parameters must have x's dtype and "
                            "device")
        if not t.is_contiguous():
            raise ValueError("refiner takes contiguous tensors only")
    if not x.is_contiguous():
        raise ValueError("refiner takes a contiguous x only")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    B, C, H, W = x.shape
    C_out = w1.shape[0]
    if (tuple(wdw.shape) != (C, KERNEL_SIZE ** 2) or tuple(bdw.shape) != (C,)
            or tuple(w1.shape) != (C_out, C) or tuple(b1.shape) != (C_out,)):
        raise ValueError(
            f"parameter shapes {tuple(wdw.shape)}, {tuple(bdw.shape)}, "
            f"{tuple(w1.shape)}, {tuple(b1.shape)} do not fit C={C} and a "
            f"{KERNEL_SIZE}x{KERNEL_SIZE} depthwise kernel")
    if not (1 <= C <= MAX_CHANNELS and 1 <= C_out <= MAX_CHANNELS):
        raise ValueError(f"channels {C} -> {C_out} exceed {MAX_CHANNELS}")
    if B > 65535 or H < 1 or W < 1:
        raise ValueError(f"bad shape {tuple(x.shape)}")
    out = torch.empty((B, C_out, H, W), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.refiner_block(_DTYPE_CODE[x.dtype], x.data_ptr(),
                                wdw.data_ptr(), bdw.data_ptr(),
                                w1.data_ptr(), b1.data_ptr(), out.data_ptr(),
                                B, C, C_out, H, W, stream)
    if err:
        raise RuntimeError(f"refiner_block launch failed: CUDA error {err}")
    LAUNCHES["refiner_block"] += 1
    return out
