// K1: fused dual-softmax mutual matching for Hopper (sm_90a).
//
// Replaces the TPU kernel pair in gim_tpu/ops/pallas_kernels/dsmax.py:
// `_stats_kernel` (sweep 1) and `_argmax_kernel` (sweep 2). For features
// f0 (L, C) and f1 (S, C) of one pair, sim = f0 f1^T * inv_t and
//   conf = softmax_rows(sim) * softmax_cols(sim).
// The L x S matrix is never written to device memory:
//   sweep 1 (dsmax_stats): masked row max and row sum-exp, kept in
//     registers across the block's loop over column tiles, plus per-row-
//     tile column max / sum-exp partials (B, L/BM, S);
//   sweep 2 (dsmax_argmax): the log-domain argmax on both sides,
//     log conf_ij = 2 sim_ij - rowterm_i - colterm_j. Rows: argmax_j of
//     2 sim - colterm_j, kept in registers; columns: argmax_i of
//     2 sim - rowterm_i as per-row-tile partials.
// The partials are reduced by the caller (gim_tpu_torch/ops/kernels/
// dsmax.py), as the JAX package reduces them outside its kernel.
//
// Grid (row tile, pair): the batch is in the grid and a loop inside the
// block over column tiles takes the place of the TPU's sequential column
// axis. Blocks run in no order, so nothing is carried between them and
// the column side leaves partials instead of atomics: results do not
// depend on run order.
//
// Semantics kept from the TPU kernel: masked entries (and the rows and
// columns past L and S) are NEG = -1e30 before max and exp; ties go to
// the lowest index, inside a tile, across column tiles (strict >), and
// across the threads that share a row or a column.
//
// What bounds it. Each sweep is 2*L*S*C FLOP of product per pair (at
// L = S = 10816, C = 256, batch 8: 4.8e11 FLOP, 0.49 ms at the H100's
// 989 TFLOP/s dense bf16) against 89 MB of inputs, so it is bound by
// operations, not bytes. This first version takes the tensor cores
// through WMMA bf16 16x16x16 fragments with float32 accumulation, stores
// each 64 x 64 sim tile to shared memory and reduces rows and columns
// from there; f1 tiles are loaded synchronously, so loads do not overlap
// the products. The products' operand traffic (f1 is re-read once per
// row tile, from L2) and the exps of sweep 1 are what a faster version
// (wgmma + TMA ring) has to hide. float32 inputs take a plain FMA
// product in full float32 (no TF32), for checks on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 64;            // rows of f0 per block
constexpr int BN = 64;            // rows of f1 per column tile
constexpr int THREADS = 256;      // 8 warps
constexpr int SIM_LD = BN + 4;    // float row stride of the sim tile
constexpr float NEG = -1e30f;

// Shared-memory row padding: bf16 rows stay 16-byte aligned (WMMA and
// uint4 loads); float rows get an odd stride so the FMA product's column
// reads hit 32 different banks.
template <typename T> struct Pad;
template <> struct Pad<bf16> { static constexpr int value = 8; };
template <> struct Pad<float> { static constexpr int value = 1; };

// Copy rows [row0, row0 + 64) of a (n_rows, C) matrix into shared memory
// (row stride ld), zero-filling rows at or past n_rows.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int row0, int n_rows, int C) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int vecs = C / 8;
    for (int idx = threadIdx.x; idx < 64 * vecs; idx += THREADS) {
      const int r = idx / vecs, v = idx - r * vecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < n_rows)
        val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * C
                                              + v * 8);
      *reinterpret_cast<uint4*>(dst + r * ld + v * 8) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * C; idx += THREADS) {
      const int r = idx / C, c = idx - r * C;
      dst[r * ld + c] = (row0 + r < n_rows) ? src[(size_t)(row0 + r) * C + c]
                                            : 0.f;
    }
  }
}

// sim[r][c] = sum_k a[r][k] * b[c][k] for the 64 x 64 tile (unscaled).
__device__ __forceinline__ void sim_tile(const bf16* a, const bf16* b,
                                         float* sim, int ld, int C) {
  const int warp = threadIdx.x / 32;
  const int wr = warp >> 1;           // 16-row strip of the tile
  const int wc0 = (warp & 1) * 2;     // first of two 16-column strips
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int k = 0; k < C; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + wr * 16 * ld + k, ld);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // B(k, n) = f1[n][k]: column-major with leading dimension ld
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + (wc0 + j) * 16 * ld + k, ld);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(sim + wr * 16 * SIM_LD + (wc0 + j) * 16, acc[j],
                            SIM_LD, wmma::mem_row_major);
}

__device__ __forceinline__ void sim_tile(const float* a, const float* b,
                                         float* sim, int ld, int C) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < C; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * ld + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * ld + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sim[(ty + 16 * i) * SIM_LD + tx + 16 * j] = acc[i][j];
}

template <typename T>
size_t smem_bytes(int C) {
  return (size_t)(BM + BN) * (C + Pad<T>::value) * sizeof(T)
         + (size_t)BM * SIM_LD * sizeof(float);
}

// Thread roles in the reductions over a 64 x 64 sim tile:
//   row side:    row rr = tid / 4 owns columns rq + 4k (k < 16);
//   column side: column cc = tid % 64 owns rows cq + 4k (k < 16).
// Both patterns read 32 distinct banks per warp.

template <typename T>
__global__ void __launch_bounds__(THREADS)
dsmax_stats_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                   const float* __restrict__ m0, const float* __restrict__ m1,
                   float inv_t, int L, int S, int C, int n_row_tiles,
                   float* __restrict__ rmax, float* __restrict__ rsum,
                   float* __restrict__ cpmax, float* __restrict__ cpsum) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float sm0[BM], sm1[BN];
  __shared__ float red_m[4][BN], red_s[4][BN];

  const int ld = C + Pad<T>::value;
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sb = sa + BM * ld;
  float* sim = reinterpret_cast<float*>(sb + BN * ld);

  const int tid = threadIdx.x;
  const int ti = blockIdx.x, b = blockIdx.y;
  const int i0 = ti * BM;
  const T* f0b = f0 + (size_t)b * L * C;
  const T* f1b = f1 + (size_t)b * S * C;
  const float* m0b = m0 + (size_t)b * L;
  const float* m1b = m1 + (size_t)b * S;

  const int rr = tid >> 2, rq = tid & 3;
  const int cc = tid & 63, cq = tid >> 6;

  load_tile(sa, ld, f0b, i0, L, C);
  if (tid < BM) sm0[tid] = (i0 + tid < L) ? m0b[i0 + tid] : 0.f;

  float run_m = NEG, run_s = 0.f;     // online row stats, this thread's part
  for (int j0 = 0; j0 < S; j0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(sb, ld, f1b, j0, S, C);
    if (tid < BN) sm1[tid] = (j0 + tid < S) ? m1b[j0 + tid] : 0.f;
    __syncthreads();
    sim_tile(sa, sb, sim, ld, C);
    __syncthreads();

    // row side: mask columns
    {
      float v[16];
      float tmax = NEG;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int c = rq + 4 * k;
        const float s = sim[rr * SIM_LD + c] * inv_t;
        v[k] = sm1[c] > 0.f ? s : NEG;
        tmax = fmaxf(tmax, v[k]);
      }
      const float m_new = fmaxf(run_m, tmax);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) acc += expf(v[k] - m_new);
      run_s = run_s * expf(run_m - m_new) + acc;
      run_m = m_new;
    }
    // column side: mask rows, this thread's 16 rows
    {
      float v[16];
      float tmax = NEG;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int r = cq + 4 * k;
        const float s = sim[r * SIM_LD + cc] * inv_t;
        v[k] = sm0[r] > 0.f ? s : NEG;
        tmax = fmaxf(tmax, v[k]);
      }
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) acc += expf(v[k] - tmax);
      red_m[cq][cc] = tmax;
      red_s[cq][cc] = acc;
    }
    __syncthreads();
    if (tid < BN && j0 + tid < S) {
      float M = red_m[0][tid];
#pragma unroll
      for (int q = 1; q < 4; ++q) M = fmaxf(M, red_m[q][tid]);
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) sum += red_s[q][tid] * expf(red_m[q][tid] - M);
      const size_t o = ((size_t)b * n_row_tiles + ti) * S + j0 + tid;
      cpmax[o] = M;
      cpsum[o] = sum;
    }
  }

  // merge the four parts of each row (adjacent lanes)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, run_m, off);
    const float os = __shfl_xor_sync(0xffffffffu, run_s, off);
    const float M = fmaxf(run_m, om);
    run_s = run_s * expf(run_m - M) + os * expf(om - M);
    run_m = M;
  }
  if (rq == 0 && i0 + rr < L) {
    rmax[(size_t)b * L + i0 + rr] = run_m;
    rsum[(size_t)b * L + i0 + rr] = run_s;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dsmax_argmax_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                    const float* __restrict__ m0, const float* __restrict__ m1,
                    const float* __restrict__ colterm,
                    const float* __restrict__ rowterm,
                    float inv_t, int L, int S, int C, int n_row_tiles,
                    int* __restrict__ jbest, float* __restrict__ jval,
                    int* __restrict__ ipidx, float* __restrict__ ipval) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float sm0[BM], srow[BM], sm1[BN], scol[BN];
  __shared__ float red_v[4][BN];
  __shared__ int red_i[4][BN];

  const int ld = C + Pad<T>::value;
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sb = sa + BM * ld;
  float* sim = reinterpret_cast<float*>(sb + BN * ld);

  const int tid = threadIdx.x;
  const int ti = blockIdx.x, b = blockIdx.y;
  const int i0 = ti * BM;
  const T* f0b = f0 + (size_t)b * L * C;
  const T* f1b = f1 + (size_t)b * S * C;
  const float* m0b = m0 + (size_t)b * L;
  const float* m1b = m1 + (size_t)b * S;
  const float* colb = colterm + (size_t)b * S;
  const float* rowb = rowterm + (size_t)b * L;

  const int rr = tid >> 2, rq = tid & 3;
  const int cc = tid & 63, cq = tid >> 6;

  load_tile(sa, ld, f0b, i0, L, C);
  if (tid < BM) {
    const bool in = i0 + tid < L;
    sm0[tid] = in ? m0b[i0 + tid] : 0.f;
    srow[tid] = in ? rowb[i0 + tid] : 0.f;
  }

  float best_v = NEG;   // row side, this thread's columns
  int best_j = 0;
  for (int j0 = 0; j0 < S; j0 += BN) {
    __syncthreads();
    load_tile(sb, ld, f1b, j0, S, C);
    if (tid < BN) {
      const bool in = j0 + tid < S;
      sm1[tid] = in ? m1b[j0 + tid] : 0.f;
      scol[tid] = in ? colb[j0 + tid] : 0.f;
    }
    __syncthreads();
    sim_tile(sa, sb, sim, ld, C);
    __syncthreads();

    // row side: argmax_j of 2 sim - colterm_j; columns rise with k and
    // with j0, so the strict > keeps the first index
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int c = rq + 4 * k;
      const float s = sim[rr * SIM_LD + c] * inv_t;
      const float v = sm1[c] > 0.f ? 2.f * s - scol[c] : NEG;
      if (v > best_v) { best_v = v; best_j = j0 + c; }
    }
    // column side: argmax_i of 2 sim - rowterm_i over this thread's rows
    {
      float bv = NEG;
      int bi = i0 + cq;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int r = cq + 4 * k;
        const float s = sim[r * SIM_LD + cc] * inv_t;
        const float v = sm0[r] > 0.f ? 2.f * s - srow[r] : NEG;
        if (v > bv) { bv = v; bi = i0 + r; }
      }
      red_v[cq][cc] = bv;
      red_i[cq][cc] = bi;
    }
    __syncthreads();
    if (tid < BN && j0 + tid < S) {
      float v = red_v[0][tid];
      int i = red_i[0][tid];
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        const float ov = red_v[q][tid];
        const int oi = red_i[q][tid];
        if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
      }
      const size_t o = ((size_t)b * n_row_tiles + ti) * S + j0 + tid;
      ipval[o] = v;
      ipidx[o] = i;
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
    if (ov > best_v || (ov == best_v && oj < best_j)) {
      best_v = ov;
      best_j = oj;
    }
  }
  if (rq == 0 && i0 + rr < L) {
    jbest[(size_t)b * L + i0 + rr] = best_j;
    jval[(size_t)b * L + i0 + rr] = best_v;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = bf16, 1 = float32.
// Every array is contiguous: f0 (B, L, C), f1 (B, S, C), m0 (B, L),
// m1 (B, S) float32 (> 0 = valid). Returns cudaGetLastError() after the
// launch (0 = launched).

extern "C" int dsmax_block_rows() { return BM; }

extern "C" int dsmax_stats(int dtype, const void* f0, const void* f1,
                           const void* m0, const void* m1, float inv_t,
                           int B, int L, int S, int C, void* rmax, void* rsum,
                           void* cpmax, void* cpsum, void* stream) {
  const int n_row_tiles = (L + BM - 1) / BM;
  const dim3 grid(n_row_tiles, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    const size_t smem = smem_bytes<bf16>(C);
    err = prepare(dsmax_stats_kernel<bf16>, smem);
    if (err != cudaSuccess) return (int)err;
    dsmax_stats_kernel<bf16><<<grid, THREADS, smem, st>>>(
        (const bf16*)f0, (const bf16*)f1, (const float*)m0, (const float*)m1,
        inv_t, L, S, C, n_row_tiles, (float*)rmax, (float*)rsum,
        (float*)cpmax, (float*)cpsum);
  } else {
    const size_t smem = smem_bytes<float>(C);
    err = prepare(dsmax_stats_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    dsmax_stats_kernel<float><<<grid, THREADS, smem, st>>>(
        (const float*)f0, (const float*)f1, (const float*)m0,
        (const float*)m1, inv_t, L, S, C, n_row_tiles, (float*)rmax,
        (float*)rsum, (float*)cpmax, (float*)cpsum);
  }
  return (int)cudaGetLastError();
}

extern "C" int dsmax_argmax(int dtype, const void* f0, const void* f1,
                            const void* m0, const void* m1,
                            const void* colterm, const void* rowterm,
                            float inv_t, int B, int L, int S, int C,
                            void* jbest, void* jval, void* ipidx, void* ipval,
                            void* stream) {
  const int n_row_tiles = (L + BM - 1) / BM;
  const dim3 grid(n_row_tiles, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    const size_t smem = smem_bytes<bf16>(C);
    err = prepare(dsmax_argmax_kernel<bf16>, smem);
    if (err != cudaSuccess) return (int)err;
    dsmax_argmax_kernel<bf16><<<grid, THREADS, smem, st>>>(
        (const bf16*)f0, (const bf16*)f1, (const float*)m0, (const float*)m1,
        (const float*)colterm, (const float*)rowterm, inv_t, L, S, C,
        n_row_tiles, (int*)jbest, (float*)jval, (int*)ipidx, (float*)ipval);
  } else {
    const size_t smem = smem_bytes<float>(C);
    err = prepare(dsmax_argmax_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    dsmax_argmax_kernel<float><<<grid, THREADS, smem, st>>>(
        (const float*)f0, (const float*)f1, (const float*)m0,
        (const float*)m1, (const float*)colterm, (const float*)rowterm, inv_t,
        L, S, C, n_row_tiles, (int*)jbest, (float*)jval, (int*)ipidx,
        (float*)ipval);
  }
  return (int)cudaGetLastError();
}
