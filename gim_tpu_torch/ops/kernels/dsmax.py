"""Fused dual-softmax mutual matching (kernel K1, CUDA C++ for Hopper).

Port of `gim_tpu/ops/pallas_kernels/dsmax.py`. For features f0 (B, L, C)
and f1 (B, S, C), sim = f0 f1^T / T and

    conf = softmax_rows(sim) * softmax_cols(sim)

followed by the row-wise argmax, its value, and the mutual check. The
kernel (`csrc/dsmax.cu`) never writes the (L, S) matrix. It runs two
sweeps over sim tiles, each launched once for the whole batch:

- `dsmax_stats`: row max and row sum-exp, plus column max / sum-exp
  partials for each block of `block_rows(dtype)` rows of f0 (the TPU's
  `_stats_kernel`);
- `dsmax_argmax`: the log-domain argmax on both sides, rows resident and
  columns as per-row-block partials (the TPU's `_argmax_kernel`).

Both kernels take blocks of 128 rows of f0: the bf16 one (TMA + wgmma)
sweeps all of S in each block; the float32 one (SIMT FMA) cuts S into
`chunks` runs of whole 128-column tiles (`sweep_chunks` picks the count
that fills the card), so that its row outputs are partials (B, chunks,
L). `stats_sweep` / `argmax_sweep` return that partial layout, from the
kernel or, for CPU tensors, from the plain version given the same
`chunks`; `dsmax_stats` / `dsmax_argmax` merge the row partials (log-
sum-exp; the first chunk holding the maximum) and keep their (B, L)
rows. `dual_softmax_mutual` reduces the column partials with torch ops
between and after the sweeps, as the JAX package leaves them to XLA
(`dsmax.py:226-258`). For a CUDA tensor a wrapper launches its kernel or
raises (`kernel_args` says what the kernel takes). `dual_softmax_mutual`
is forward only on both devices (`forward_only.py`): a backward through
its conf raises. `LAUNCHES` counts the
launches of each of the four kernels: the bf16 sweeps under their names,
the float32 ones (`dsmax_f32_kernel<false / true>` in the source) as
`dsmax_stats_f32` and `dsmax_argmax_f32`.

`dual_softmax_mutual_plain` is the dense recipe (conf materialised one
pair at a time), an independent reference for tests and the card check.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gim_tpu_torch.ops.kernels.build import load_library
from gim_tpu_torch.ops.kernels.forward_only import forward_only

NEG = -1e30
# rows of f0 per block, by feature dtype; must match dsmax_block_rows()
BLOCK_ROWS = {torch.bfloat16: 128, torch.float32: 128}
CHUNK_TILE = 128      # float32 kernel: columns per tile, a chunk's unit
MAX_CHUNKS = 8
H100_SMS = 132        # the chunk rule's card for tensors off CUDA
MAX_C = 256           # widest feature the kernels' shared memory holds
C_STEP = 8            # C must be a multiple: TMA's 16-byte row stride
ALIGN = 16            # bytes: TMA's rule for the feature bases

LAUNCHES = {"dsmax_stats": 0, "dsmax_argmax": 0, "dsmax_stats_f32": 0,
            "dsmax_argmax_f32": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _lib():
    lib = load_library("dsmax")
    if not getattr(lib, "_gim_typed", False):
        lib.dsmax_block_rows.argtypes = [_I]
        lib.dsmax_block_rows.restype = _I
        lib.dsmax_chunk_span.argtypes = [_I, _I]
        lib.dsmax_chunk_span.restype = _I
        lib.dsmax_stats.argtypes = [_I, _P, _P, _P, _P, _F, _I, _I, _I, _I,
                                    _I, _P, _P, _P, _P, _P]
        lib.dsmax_stats.restype = _I
        lib.dsmax_argmax.argtypes = [_I, _P, _P, _P, _P, _P, _P, _F, _I, _I,
                                     _I, _I, _I, _P, _P, _P, _P, _P]
        lib.dsmax_argmax.restype = _I
        for dtype, code in _DTYPE_CODE.items():
            if lib.dsmax_block_rows(code) != BLOCK_ROWS[dtype]:
                raise RuntimeError(f"csrc/dsmax.cu block rows for {dtype} "
                                   f"differ from BLOCK_ROWS")
        for S, n in ((11025, 3), (129, 2), (300, 1)):
            if lib.dsmax_chunk_span(S, n) != chunk_span(S, n):
                raise RuntimeError("csrc/dsmax.cu chunk spans differ from "
                                   "chunk_span")
        lib._gim_typed = True
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_rows(dtype: torch.dtype) -> int:
    """Rows of f0 per block (the column partials' tiling) for a dtype;
    float32's for the dtypes that only the plain version takes."""
    return BLOCK_ROWS.get(dtype, BLOCK_ROWS[torch.float32])


def chunk_span(S: int, chunks: int) -> int:
    """Columns per chunk of S: whole CHUNK_TILE-column tiles, as even as
    they come (the last chunk takes the rest); dsmax_chunk_span() in the
    source."""
    return CHUNK_TILE * _cdiv(_cdiv(S, CHUNK_TILE), chunks)


def sweep_chunks(dtype: torch.dtype, B: int, L: int, S: int,
                 sms: int = H100_SMS) -> int:
    """Chunks of S for a sweep over (B, L) x (B, S): 1 for bf16 (its
    kernel sweeps all of S); for float32 the count, up to MAX_CHUNKS, that
    gives the (row block, chunk, pair) blocks, one resident on each of
    `sms` SMs, the fewest waves times tiles per block (plus one tile's
    worth for a block's f0 load and row merge), no chunk empty. ZEB's
    (1, 11025, 11025) on 132 SMs: 3 (261 blocks of 29 tiles)."""
    if dtype != torch.float32:
        return 1
    n_rb, n_ct = _cdiv(L, BLOCK_ROWS[dtype]), _cdiv(S, CHUNK_TILE)
    best, best_cost = 1, None
    for n in range(1, min(n_ct, MAX_CHUNKS) + 1):
        tiles = _cdiv(n_ct, n)
        n = _cdiv(n_ct, tiles)
        cost = _cdiv(B * n_rb * n, sms) * (tiles + 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = n, cost
    return best


def _sms(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def _chunks(S: int, chunks: int) -> list[tuple[int, int]]:
    """(first, end) columns of each chunk of S; raises if there is none or
    one is empty."""
    if chunks < 1 or _cdiv(S, chunk_span(S, chunks)) != chunks:
        raise ValueError(f"{chunks} chunks of S = {S}: none, or one empty")
    span = chunk_span(S, chunks)
    return [(c * span, min(S, (c + 1) * span)) for c in range(chunks)]


def _chunk_count(f0, f1, chunks: int | None) -> int:
    if chunks is not None:
        return chunks
    return sweep_chunks(f0.dtype, f0.shape[0], f0.shape[1], f1.shape[1],
                        _sms(f0.device))


class KernelArgs(NamedTuple):
    B: int
    L: int
    S: int
    C: int
    block: int                # rows of f0 per block
    grid: tuple[int, int]     # (row blocks x chunks, pairs)
    cluster: int              # blocks per cluster
    chunks: int               # chunks of S (row partials)


def kernel_args(f0, f1, m0, m1, *terms, chunks: int | None = None
                ) -> KernelArgs:
    """What the kernel is handed for f0 (B, L, C), f1 (B, S, C), masks
    m0 (B, L) and m1 (B, S) and, for the argmax sweep, the terms colterm
    (B, S) and rowterm (B, L), with S in `chunks` chunks (default
    `sweep_chunks` for the features' device). Raises on what the kernel
    does not take: a dtype other than bf16 / float32, another rank or
    shape, C not a multiple of 8 or above 256, masks or terms that are not
    float32 on the features' device, a non-contiguous tensor, a feature
    base that is not 16-byte aligned, a chunk count other than 1 for bf16
    or one that leaves a chunk empty. Nothing is copied or padded in place
    of a raise."""
    if f0.dtype not in BLOCK_ROWS or f1.dtype != f0.dtype:
        raise TypeError(f"dsmax takes bf16 or float32 features, got "
                        f"{f0.dtype} and {f1.dtype}")
    if f0.dim() != 3 or f1.dim() != 3 or f0.shape[0] != f1.shape[0] \
            or f0.shape[2] != f1.shape[2]:
        raise ValueError(f"bad feature shapes {tuple(f0.shape)}, "
                         f"{tuple(f1.shape)}")
    B, L, C = f0.shape
    S = f1.shape[1]
    if min(B, L, S) < 1 or B > 65535:
        raise ValueError(f"bad feature shapes {tuple(f0.shape)}, "
                         f"{tuple(f1.shape)}")
    if C % C_STEP or C > MAX_C:
        raise ValueError(f"feature width {C} must be a multiple of {C_STEP} "
                         f"and at most {MAX_C}")
    if tuple(m0.shape) != (B, L) or tuple(m1.shape) != (B, S):
        raise ValueError(f"mask shapes {tuple(m0.shape)}, {tuple(m1.shape)} "
                         f"do not match {(B, L)}, {(B, S)}")
    if terms and (len(terms) != 2 or tuple(terms[0].shape) != (B, S)
                  or tuple(terms[1].shape) != (B, L)):
        raise ValueError("colterm must be (B, S) and rowterm (B, L)")
    for t in (m0, m1, *terms):
        if t.dtype != torch.float32 or t.device != f0.device:
            raise TypeError("masks and terms must be float32 on the "
                            "features' device")
    for t in (f0, f1, m0, m1, *terms):
        if not t.is_contiguous():
            raise ValueError("dsmax takes contiguous tensors only")
    for t in (f0, f1):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"feature base is not {ALIGN}-byte aligned")
    block = BLOCK_ROWS[f0.dtype]
    chunks = _chunk_count(f0, f1, chunks)
    if f0.dtype == torch.bfloat16 and chunks != 1:
        raise ValueError(f"{chunks} chunks for bf16 features: its kernel "
                         f"sweeps all of S")
    _chunks(S, chunks)
    return KernelArgs(B, L, S, C, block, (_cdiv(L, block) * chunks, B), 1,
                      chunks)


def _on_cuda(f0):
    if f0.device.type != "cuda":
        raise ValueError(f"dsmax kernel needs CUDA tensors, got {f0.device}")


def _counted(sweep: str, dtype: torch.dtype) -> str:
    """The LAUNCHES key of a sweep's kernel for a feature dtype."""
    return sweep + ("_f32" if dtype == torch.float32 else "")


# ---------------------------------------------------------------------------
# plain versions (same outputs, same row tiling, same chunks)
# ---------------------------------------------------------------------------

def _sim(f0b: torch.Tensor, f1b: torch.Tensor, inv_t: float) -> torch.Tensor:
    return (f0b.float() @ f1b.float().T) * inv_t


def _row_tiles(x: torch.Tensor, block: int) -> torch.Tensor:
    """(L, S) -> (L/block, block, S), rows past L padded with NEG."""
    L, S = x.shape
    n = _cdiv(L, block)
    pad = x.new_full((n * block - L, S), NEG)
    return torch.cat([x, pad]).view(n, block, S)


def dsmax_stats_plain(f0, f1, m0, m1, inv_t: float, block: int | None = None,
                      chunks: int = 1):
    """Plain version of the stats sweep: row partials (rmax, rsum) (B,
    chunks, L) over each chunk's columns, and column partials (cpmax,
    cpsum) (B, L/block, S), float32. `block` defaults to the kernel's for
    f0's dtype."""
    B, L, _ = f0.shape
    block = block or block_rows(f0.dtype)
    S = f1.shape[1]
    n = _cdiv(L, block)
    spans = _chunks(S, chunks)
    rmax = f0.new_empty((B, chunks, L), dtype=torch.float32)
    rsum = torch.empty_like(rmax)
    cpmax = f0.new_empty((B, n, S), dtype=torch.float32)
    cpsum = torch.empty_like(cpmax)
    for b in range(B):                 # one (L, S) matrix alive at a time
        sim = _sim(f0[b], f1[b], inv_t)
        sim_r = sim.masked_fill((m1[b] <= 0)[None, :], NEG)
        for c, (lo, hi) in enumerate(spans):
            rmax[b, c] = sim_r[:, lo:hi].amax(1)
            rsum[b, c] = torch.exp(sim_r[:, lo:hi] - rmax[b, c][:, None]
                                   ).sum(1)
        sim_c = _row_tiles(sim.masked_fill((m0[b] <= 0)[:, None], NEG), block)
        cpmax[b] = sim_c.amax(1)
        cpsum[b] = torch.exp(sim_c - cpmax[b][:, None]).sum(1)
    return rmax, rsum, cpmax, cpsum


def dsmax_argmax_plain(f0, f1, m0, m1, colterm, rowterm, inv_t: float,
                       block: int | None = None, chunks: int = 1):
    """Plain version of the argmax sweep: row partials (jbest int32, jval)
    (B, chunks, L), each chunk's best column and its value, and column
    partials (ipidx int32, ipval) (B, L/block, S). Ties go to the first
    index (torch.max returns the first maximal index). `block` defaults to
    the kernel's for f0's dtype."""
    B, L, _ = f0.shape
    block = block or block_rows(f0.dtype)
    S = f1.shape[1]
    n = _cdiv(L, block)
    spans = _chunks(S, chunks)
    jbest = f0.new_empty((B, chunks, L), dtype=torch.int32)
    jval = f0.new_empty((B, chunks, L), dtype=torch.float32)
    ipidx = f0.new_empty((B, n, S), dtype=torch.int32)
    ipval = f0.new_empty((B, n, S), dtype=torch.float32)
    base = torch.arange(n, device=f0.device)[:, None] * block
    for b in range(B):
        sim = _sim(f0[b], f1[b], inv_t)
        br = torch.where(m1[b][None, :] > 0, 2.0 * sim - colterm[b][None, :],
                         NEG)
        for c, (lo, hi) in enumerate(spans):
            v, j = br[:, lo:hi].max(1)
            jval[b, c], jbest[b, c] = v, (j + lo).int()
        bc = torch.where(m0[b][:, None] > 0, 2.0 * sim - rowterm[b][:, None],
                         NEG)
        v, i = _row_tiles(bc, block).max(1)
        ipval[b], ipidx[b] = v, (i + base).int()
    return jbest, jval, ipidx, ipval


def merge_row_stats(rmax, rsum):
    """Row partials (B, chunks, L) -> (rmax, rsum) (B, L): log-sum-exp."""
    if rmax.shape[1] == 1:
        return rmax[:, 0], rsum[:, 0]
    m = rmax.amax(1)
    return m, (rsum * torch.exp(rmax - m[:, None])).sum(1)


def merge_row_argmax(jbest, jval):
    """Row partials (B, chunks, L) -> (jbest, jval) (B, L): the first
    chunk holding the maximum, so an equal value in a lower chunk wins."""
    if jval.shape[1] == 1:
        return jbest[:, 0], jval[:, 0]
    k = jval.argmax(1, keepdim=True)
    return jbest.gather(1, k)[:, 0], jval.gather(1, k)[:, 0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def stats_sweep(f0, f1, m0, m1, inv_t: float, chunks: int):
    """Stats sweep in the kernel's layout (row partials over `chunks`
    chunks of S): kernel on CUDA tensors, plain version on CPU tensors."""
    if f0.device.type == "cpu":
        return dsmax_stats_plain(f0, f1, m0, m1, inv_t, chunks=chunks)
    _on_cuda(f0)
    B, L, S, C, block, _, _, n_ch = kernel_args(f0, f1, m0, m1,
                                                chunks=chunks)
    n = _cdiv(L, block)
    rmax = torch.empty((B, n_ch, L), dtype=torch.float32, device=f0.device)
    rsum = torch.empty_like(rmax)
    cpmax = torch.empty((B, n, S), dtype=torch.float32, device=f0.device)
    cpsum = torch.empty_like(cpmax)
    lib = _lib()
    with torch.cuda.device(f0.device):
        stream = torch.cuda.current_stream(f0.device).cuda_stream
        err = lib.dsmax_stats(_DTYPE_CODE[f0.dtype], f0.data_ptr(),
                              f1.data_ptr(), m0.data_ptr(), m1.data_ptr(),
                              float(inv_t), B, L, S, C, n_ch, rmax.data_ptr(),
                              rsum.data_ptr(), cpmax.data_ptr(),
                              cpsum.data_ptr(), stream)
    if err:
        raise RuntimeError(f"dsmax_stats launch failed: CUDA error {err}")
    LAUNCHES[_counted("dsmax_stats", f0.dtype)] += 1
    return rmax, rsum, cpmax, cpsum


def argmax_sweep(f0, f1, m0, m1, colterm, rowterm, inv_t: float,
                 chunks: int):
    """Argmax sweep in the kernel's layout (row partials over `chunks`
    chunks of S): kernel on CUDA tensors, plain version on CPU tensors."""
    if f0.device.type == "cpu":
        return dsmax_argmax_plain(f0, f1, m0, m1, colterm, rowterm, inv_t,
                                  chunks=chunks)
    _on_cuda(f0)
    B, L, S, C, block, _, _, n_ch = kernel_args(f0, f1, m0, m1, colterm,
                                                rowterm, chunks=chunks)
    n = _cdiv(L, block)
    jbest = torch.empty((B, n_ch, L), dtype=torch.int32, device=f0.device)
    jval = torch.empty((B, n_ch, L), dtype=torch.float32, device=f0.device)
    ipidx = torch.empty((B, n, S), dtype=torch.int32, device=f0.device)
    ipval = torch.empty((B, n, S), dtype=torch.float32, device=f0.device)
    lib = _lib()
    with torch.cuda.device(f0.device):
        stream = torch.cuda.current_stream(f0.device).cuda_stream
        err = lib.dsmax_argmax(_DTYPE_CODE[f0.dtype], f0.data_ptr(),
                               f1.data_ptr(), m0.data_ptr(), m1.data_ptr(),
                               colterm.data_ptr(), rowterm.data_ptr(),
                               float(inv_t), B, L, S, C, n_ch,
                               jbest.data_ptr(), jval.data_ptr(),
                               ipidx.data_ptr(), ipval.data_ptr(), stream)
    if err:
        raise RuntimeError(f"dsmax_argmax launch failed: CUDA error {err}")
    LAUNCHES[_counted("dsmax_argmax", f0.dtype)] += 1
    return jbest, jval, ipidx, ipval


def dsmax_stats(f0, f1, m0, m1, inv_t: float, chunks: int | None = None):
    """Stats sweep: (rmax, rsum) (B, L) and column partials (cpmax, cpsum)
    (B, L/block, S); S in `chunks` chunks (default `sweep_chunks`), the
    row partials merged here."""
    rmax, rsum, cpmax, cpsum = stats_sweep(f0, f1, m0, m1, inv_t,
                                           _chunk_count(f0, f1, chunks))
    return (*merge_row_stats(rmax, rsum), cpmax, cpsum)


def dsmax_argmax(f0, f1, m0, m1, colterm, rowterm, inv_t: float,
                 chunks: int | None = None):
    """Argmax sweep: (jbest int32, jval) (B, L) and column partials (ipidx
    int32, ipval) (B, L/block, S); S in `chunks` chunks (default
    `sweep_chunks`), the row partials merged here."""
    jbest, jval, ipidx, ipval = argmax_sweep(
        f0, f1, m0, m1, colterm, rowterm, inv_t, _chunk_count(f0, f1, chunks))
    return (*merge_row_argmax(jbest, jval), ipidx, ipval)


def _masks(f0, f1, mask0, mask1):
    B, L, _ = f0.shape
    S = f1.shape[1]
    m0 = (torch.ones((B, L), dtype=torch.float32, device=f0.device)
          if mask0 is None else mask0.float().contiguous())
    m1 = (torch.ones((B, S), dtype=torch.float32, device=f0.device)
          if mask1 is None else mask1.float().contiguous())
    return m0, m1


def dual_softmax_mutual(f0: torch.Tensor, f1: torch.Tensor,
                        temperature: float,
                        mask0: torch.Tensor | None = None,
                        mask1: torch.Tensor | None = None,
                        chunks: int | None = None):
    """Fused dual-softmax mutual matching over a batch of pairs.

    f0: (B, L, C), f1: (B, S, C) pre-scaled features (1/sqrt(C) applied),
    bf16 or float32; masks: (B, L)/(B, S) bool. Returns (j_best (B, L)
    int64, conf (B, L) float32, mutual (B, L) bool): the column argmax of
    conf per row, its value, and whether the match is mutual. Invalid rows
    get conf 0 and mutual False. Same as dense `dual_softmax` + row/column
    argmax, without materialising (L, S). `chunks`: chunks of S in both
    sweeps (default `sweep_chunks`; the result does not depend on it).
    Forward only: a backward through conf raises.
    """
    return forward_only("dual_softmax_mutual", _dual_softmax_mutual, f0, f1,
                        temperature, mask0, mask1, chunks)


def _dual_softmax_mutual(f0, f1, temperature, mask0, mask1, chunks):
    f0 = f0.contiguous()
    f1 = f1.contiguous()
    L = f0.shape[1]
    S = f1.shape[1]
    m0, m1 = _masks(f0, f1, mask0, mask1)
    inv_t = 1.0 / temperature

    chunks = _chunk_count(f0, f1, chunks)
    rmax, rsum, cpmax, cpsum = dsmax_stats(f0, f1, m0, m1, inv_t, chunks)
    cmax = cpmax.amax(1)                                      # (B, S)
    csum = (cpsum * torch.exp(cpmax - cmax[:, None])).sum(1)
    # log-domain terms; masked slots get 0 (their sim is NEG in the sweeps)
    rowterm = torch.where(m0 > 0, rmax + torch.log(rsum), 0.0).contiguous()
    colterm = torch.where(m1 > 0, cmax + torch.log(csum.clamp_min(1e-30)),
                          0.0).contiguous()

    jbest, jval, ipidx, ipval = dsmax_argmax(f0, f1, m0, m1, colterm,
                                             rowterm, inv_t, chunks)
    # column side: first row tile holding the maximum, then its row
    k = ipval.argmax(1, keepdim=True)                         # (B, 1, S)
    ibest = ipidx.gather(1, k)[:, 0].long()                   # (B, S)
    jbest = jbest.long()
    conf = torch.exp(jval - rowterm)       # the winner's conf, exp once
    mutual = (ibest.gather(1, jbest.clamp(0, S - 1))
              == torch.arange(L, device=f0.device)[None])
    if mask0 is not None:
        valid = m0 > 0
        conf = torch.where(valid, conf, 0.0)
        mutual = mutual & valid
    return jbest, conf, mutual


def dual_softmax_mutual_plain(f0: torch.Tensor, f1: torch.Tensor,
                              temperature: float,
                              mask0: torch.Tensor | None = None,
                              mask1: torch.Tensor | None = None):
    """Dense reference for `dual_softmax_mutual`: the (L, S) conf matrix of
    one pair at a time (dual_softmax, then row and column argmax), in
    float32. Same outputs and contract."""
    from gim_tpu_torch.ops.matching import dual_softmax

    B, L, _ = f0.shape
    jbest = torch.empty((B, L), dtype=torch.long, device=f0.device)
    conf = torch.empty((B, L), dtype=torch.float32, device=f0.device)
    mutual = torch.empty((B, L), dtype=torch.bool, device=f0.device)
    rows = torch.arange(L, device=f0.device)
    for b in range(B):
        sim = f0[b].float() @ f1[b].float().T
        m0 = None if mask0 is None else mask0[b:b + 1]
        m1 = None if mask1 is None else mask1[b:b + 1]
        c = dual_softmax(sim[None], temperature, m0, m1)[0]
        v, j = c.max(1)
        ibest = c.argmax(0)
        mu = ibest[j] == rows
        if mask0 is not None:
            v = torch.where(mask0[b], v, 0.0)
            mu = mu & mask0[b]
        jbest[b], conf[b], mutual[b] = j, v, mu
    return jbest, conf, mutual
