"""Flash (online-softmax) attention (kernel K3, CUDA C++ for Hopper).

Port of `gim_tpu/ops/pallas_kernels/flash.py:flash_sdpa`: unmasked
softmax(q k^T / sqrt(D)) v over q, k, v of shape (B, H, N, D), without
writing the (N, N) matrix to device memory. The kernel
(`csrc/flash.cu`) takes D in {64, 128} (the DINOv2 ViT-L heads and the
RoMa coordinate decoder's), bf16 through TMA and wgmma or float32 through
3xTF32 products on wgmma, and masks the ragged query and key edges
itself.

Argument contract on the card. q, k and v may be strided views, as the
qkv split of a ViT block gives them (`qkv.permute(2, 0, 3, 1, 4)
.unbind(0)`: unit stride along D, row stride 3 C, head stride D): the
kernel reads them in place. Every stride but the last must be a multiple
of 16 bytes and every base 16-byte aligned (TMA's rule in bf16, 16-byte
loads in float32; `kernel_args` checks and raises, and nothing is copied
in their place). The result is
a (B, H, N, D) view of a contiguous (B, N, H, D) buffer, so
`o.transpose(1, 2).reshape(B, N, H * D)` merges the heads without a copy.
In float32 the wrapper also hands the kernel a scratch buffer, where a
split pass writes K and V in TF32 parts (twice their size).

`flash_sdpa` takes the plain version `flash_sdpa_plain` (the einsum +
softmax of `ops.attention.sdpa`) only for CPU tensors; for a CUDA tensor
it launches the kernel or raises. On both it is forward only
(`forward_only.py`): a backward through it raises. `LAUNCHES` counts the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from gim_tpu_torch.ops.attention import sdpa
from gim_tpu_torch.ops.kernels.build import load_library
from gim_tpu_torch.ops.kernels.forward_only import forward_only

HEAD_DIMS = (64, 128)
ALIGN = 16            # bytes: bases and strides (TMA, 16-byte loads)

LAUNCHES = {"flash_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _lib(csrc=None, flags=()):
    """The built csrc/flash.cu with its C interface typed; `csrc` and
    `flags` load a variant instead (`build.build_all`)."""
    lib = load_library("flash", csrc, flags)
    if not getattr(lib, "_gim_typed", False):
        lib.flash_attention.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I,
                                        _I, ctypes.POINTER(ctypes.c_longlong),
                                        ctypes.c_float, _P]
        lib.flash_attention.restype = _I
        lib.flash_scratch_bytes.argtypes = [_I, _I, _I, _I, _I]
        lib.flash_scratch_bytes.restype = ctypes.c_longlong
        lib._gim_typed = True
    return lib


def flash_sdpa_plain(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: `sdpa` without a mask."""
    return sdpa(q, k, v)


def kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """What the kernel is handed for q, k, v of one (B, H, N, D) shape:
    returns ((B, H, N, D), the element strides (B, H, N) of q, k and v,
    9 ints). Raises on what the kernel does not take: another rank or
    shape, D outside HEAD_DIMS, a non-unit stride along D, a stride of a
    dimension longer than 1 or a base that is not a multiple of 16
    bytes."""
    if q.dim() != 4:
        raise ValueError(f"flash takes (B, H, N, D), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    shape = tuple(q.shape)
    B, H, N, D = shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if N < 1 or B < 1 or H < 1 or B * H > 65535:
        raise ValueError(f"bad attention shape {tuple(q.shape)}")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        st = t.stride()
        item = t.element_size()
        if st[3] != 1:
            raise ValueError(f"{name} needs unit stride along D, has "
                             f"{st[3]}")
        for size, s in zip(shape[:3], st[:3]):
            if size > 1 and (s * item) % ALIGN:
                raise ValueError(f"{name} strides {st} are not multiples "
                                 f"of {ALIGN} bytes")
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} base is not {ALIGN}-byte aligned")
        strides.extend(st[:3])
    return shape, strides


def flash_sdpa(q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v for q, k, v (B, H, N, D) of one shape and
    dtype (bf16 or float32). Returns q's shape and dtype; on the card as a
    view of a contiguous (B, N, H, D) buffer (module docstring). Forward
    only: a backward through the result raises."""
    return forward_only("flash_attention", _flash_sdpa, q, k, v)


def _flash_sdpa(q, k, v):
    if q.device.type == "cpu":
        return flash_sdpa_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash takes bf16 or float32 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    (B, H, N, D), strides = kernel_args(q, k, v)
    buf = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    strides += [N * H * D, D, H * D]
    arr = (ctypes.c_longlong * 12)(*strides)
    lib = _lib()
    code = _DTYPE_CODE[q.dtype]
    # float32: the kernel's scratch for K and V split into TF32 parts
    n = lib.flash_scratch_bytes(code, B, H, N, D)
    scratch = torch.empty(n // 4, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention(code, q.data_ptr(), k.data_ptr(),
                                  v.data_ptr(), buf.data_ptr(),
                                  scratch.data_ptr() if n else None, B, H, N,
                                  D, arr, float(D ** -0.5), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return buf.transpose(1, 2)
