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
launches, and the span `gim.flash_attention` (`utils/profiling.span`)
marks each: the plain version on the CPU enters none.

`flash_sdpa_masked` is the kernel's masked float32 variant, LightGlue's
self and cross attention (`models/lightglue.py`; it replaces no TPU
kernel, see `csrc/flash.cu`): q (B, H, Nq, D), k and v (B, H, Nk, D), the
padded keypoint slots' validity (B, Nq) and (B, Nk), the scale 1 / sqrt(D)
as `flash_sdpa`'s; a row whose query is invalid or which has no valid key
is 0. Its plain
version `flash_sdpa_masked_plain` is `sdpa` with the mask q_valid &
k_valid. It has its own counter, `LAUNCHES["lightglue_attention"]`, and
span, `gim.lightglue.attention`, under the same rules.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gim_tpu_torch.ops.attention import sdpa
from gim_tpu_torch.ops.kernels.build import load_library
from gim_tpu_torch.ops.kernels.forward_only import forward_only
from gim_tpu_torch.utils.profiling import span

HEAD_DIMS = (64, 128)
ALIGN = 16            # bytes: bases and strides (TMA, 16-byte loads)

LAUNCHES = {"flash_attention": 0, "lightglue_attention": 0}

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
        lib.flash_attention_masked.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            ctypes.POINTER(ctypes.c_longlong), _I, _P]
        lib.flash_attention_masked.restype = _I
        lib.flash_masked_scratch_bytes.argtypes = [_I, _I, _I, _I]
        lib.flash_masked_scratch_bytes.restype = ctypes.c_longlong
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
        strides.extend(_strides(name, t))
    return shape, strides


def _strides(name: str, t: torch.Tensor) -> list[int]:
    """The element strides (B, H, N) of one (B, H, N, D) operand; raises
    on a non-unit stride along D, a stride of a dimension longer than 1
    or a base that is not a multiple of 16 bytes."""
    st = t.stride()
    item = t.element_size()
    if st[3] != 1:
        raise ValueError(f"{name} needs unit stride along D, has {st[3]}")
    for size, s in zip(t.shape[:3], st[:3]):
        if size > 1 and (s * item) % ALIGN:
            raise ValueError(f"{name} strides {st} are not multiples of "
                             f"{ALIGN} bytes")
    if t.data_ptr() % ALIGN:
        raise ValueError(f"{name} base is not {ALIGN}-byte aligned")
    return list(st[:3])


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
    with span("gim.flash_attention"):
        return _launch(q, k, v)


def _launch(q, k, v):
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


def flash_sdpa_masked_plain(q, k, v, q_valid, k_valid) -> torch.Tensor:
    """The masked variant's plain version: `sdpa` with the mask q_valid &
    k_valid (None: all valid)."""
    B, Nq, Nk = q.shape[0], q.shape[2], k.shape[2]
    if q_valid is None:
        q_valid = torch.ones((B, Nq), dtype=torch.bool, device=q.device)
    if k_valid is None:
        k_valid = torch.ones((B, Nk), dtype=torch.bool, device=k.device)
    mask = q_valid[:, None, :, None] & k_valid[:, None, None, :]
    return sdpa(q, k, v, mask)


def masked_args(q, k, v, q_valid, k_valid):
    """What the masked variant is handed: returns ((B, H, Nq, Nk, D), the
    element strides (B, H, N) of q, k and v, 9 ints). Raises on what the
    kernel does not take: dtypes other than float32, other ranks or
    shapes (k and v of one shape, Nk keys of q's B, H and D), D outside
    HEAD_DIMS, strides as `kernel_args`, or a mask that is not a
    contiguous bool (B, Nq) / (B, Nk) tensor (None: all valid). Written
    for the host's time: LightGlue calls it 36 times a match."""
    qs, ks = q.shape, k.shape
    if (len(qs) != 4 or len(ks) != 4 or v.shape != ks or ks[:2] != qs[:2]
            or ks[3] != qs[3]):
        raise ValueError(f"k and v must be (B, H, Nk, D) of q's B, H, D, "
                         f"got {tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    f32 = torch.float32
    if q.dtype != f32 or k.dtype != f32 or v.dtype != f32:
        raise TypeError(f"the masked flash kernel takes float32 q, k, v, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Nq, D = qs
    Nk = ks[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if min(B, H, Nq, Nk) < 1 or B * H > 65535:
        raise ValueError(f"bad attention shapes {tuple(qs)}, {tuple(ks)}")
    for name, m, n in (("q_valid", q_valid, Nq), ("k_valid", k_valid, Nk)):
        if m is None:
            continue
        if m.dtype != torch.bool:
            raise TypeError(f"{name} must be bool, got {m.dtype}")
        if m.shape != (B, n) or not m.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({B}, {n}), got "
                             f"{tuple(m.shape)} with strides {m.stride()}")
    return (B, H, Nq, Nk, D), [*_strides("q", q), *_strides("k", k),
                               *_strides("v", v)]


def flash_sdpa_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_valid: torch.Tensor | None,
                      k_valid: torch.Tensor | None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over the keys k_valid marks, for float32 q
    (B, H, Nq, D) and k, v (B, H, Nk, D); rows whose query is invalid, or
    with no valid key, are 0. Returns q's shape; on the card as a view of
    a contiguous (B, Nq, H, D) buffer. Forward only: where autograd
    records, a backward through the result raises (`forward_only`); where
    it does not, there is no backward to refuse and the call skips the
    autograd node's host time."""
    if torch.is_grad_enabled():
        return forward_only("lightglue_attention", _flash_sdpa_masked, q,
                            k, v, q_valid, k_valid)
    return _flash_sdpa_masked(q, k, v, q_valid, k_valid)


def _flash_sdpa_masked(q, k, v, q_valid, k_valid):
    shape, strides = masked_args(q, k, v, q_valid, k_valid)
    if q.device.type == "cpu":
        return flash_sdpa_masked_plain(q, k, v, q_valid, k_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    if any(t is not None and t.device != q.device
           for t in (k, v, q_valid, k_valid)):
        raise ValueError("q, k, v and the masks must be on one device")
    with span("gim.lightglue.attention"):
        return _launch_masked(q, k, v, q_valid, k_valid, shape, strides)


@functools.lru_cache(maxsize=64)
def _masked_scratch_floats(B: int, H: int, Nk: int, D: int) -> int:
    return _lib().flash_masked_scratch_bytes(B, H, Nk, D) // 4


def masked_launch(q, k, v, q_valid, k_valid, shape, strides):
    """One launch's output buffer, made here, and the arguments of the C
    entry `flash_attention_masked` for it (shape and strides from
    `masked_args`). chip_smoke.py times the entry on these, without this
    module's host time."""
    B, H, Nq, Nk, D = shape
    # the output (B, Nq, H, D) and the kernel's scratch in one allocation
    n_out = B * Nq * H * D
    buf = torch.empty(n_out + _masked_scratch_floats(B, H, Nk, D),
                      dtype=torch.float32, device=q.device)
    arr = (ctypes.c_longlong * 12)(*strides, Nq * H * D, D, H * D)
    dev = q.device.index
    ptr = lambda m: None if m is None else m.data_ptr()   # noqa: E731
    base = buf.data_ptr()
    # the stream's handle without a Stream object (as torch's own generated
    # code reads it); the C side launches on q's device
    return buf, (q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(q_valid),
                 ptr(k_valid), base, base + 4 * n_out, B, H, Nq, Nk, D, arr,
                 dev,
                 torch._C._cuda_getCurrentRawStream(dev))


def _launch_masked(q, k, v, q_valid, k_valid, shape, strides):
    buf, args = masked_launch(q, k, v, q_valid, k_valid, shape, strides)
    err = _lib().flash_attention_masked(*args)
    if err:
        raise RuntimeError(f"flash_attention_masked launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["lightglue_attention"] += 1
    B, H, Nq, _, D = shape
    return buf[:B * Nq * H * D].view(B, Nq, H, D).transpose(1, 2)
