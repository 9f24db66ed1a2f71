// K3: flash (online-softmax) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` in gim_tpu/ops/pallas_kernels/
// flash.py (via `flash_sdpa`). For q, k, v of shape (G, N, D), G = batch x
// heads folded,
//   o = softmax(q k^T / sqrt(D)) v,
// unmasked self-attention, without writing the (N, N) matrix to device
// memory. Semantics kept from the TPU kernel: the running row max and row
// sum and the output accumulator are float32; p is cast to v's dtype for
// the P V product; key columns past N get -1e30 (not -inf) before the
// max and exp; o = acc / l is written in q's dtype.
//
// Grid (query tile of 64, G). A block loads its 64 query rows once and
// loops over key/value tiles of 64 rows in shared memory; the loop inside
// the block takes the place of the TPU grid's sequential key axis.
// Ragged edges are masked inside the kernel: query rows past N load as
// zeros and are not stored, key rows past N load as zeros and their
// scores are -1e30. No padded copy of q, k or v is made, and every key
// tile up to N is visited (the tile sizes are fixed here, so there is no
// block-size rounding that could skip a tail tile).
//
// What bounds it. 4 G N^2 D FLOP (at the ViT-L shape G = 32, N = 2305,
// D = 64: 4.35e10 FLOP, 0.044 ms at 989 TFLOP/s bf16) against 4 G N D
// elements of traffic (38 MB), so it is bound by operations. bf16 inputs
// take the tensor cores through `mma.sync.m16n8k16` (bf16 in, float32
// accumulate) in the FlashAttention-2 arrangement: four warps, each owning
// 16 query rows, keep Q fragments, the S tile, the online statistics and
// the O accumulator in registers, so S and P never touch shared memory;
// the S fragment layout is reused as the A operand of P V. K and V tiles
// are loaded synchronously (no cp.async/TMA ring), and V's B fragments
// are gathered with 16-bit shared loads: overlapping loads with products
// (wgmma + TMA) is what a faster version has to add. float32 inputs take
// a plain FMA path in full float32 (no TF32), for checks on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // key rows per tile
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int THREADS_BF16 = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Copy rows [row0, row0 + 64) of one (N, D) matrix into shared memory
// (row stride LD), zero-filling rows at or past N. 16-byte vectors.
template <int D, int LD>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src,
                                               int row0, int N) {
  constexpr int VECS = D / 8;
  for (int idx = threadIdx.x; idx < 64 * VECS; idx += blockDim.x) {
    const int r = idx / VECS, v = idx - r * VECS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < N)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D
                                            + v * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + v * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS_BF16)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int N,
                  float scale) {
  constexpr int LD = D + 8;       // bf16 row stride: 16-byte aligned rows
  constexpr int KSTEPS = D / 16;  // k-steps of Q K^T
  constexpr int DT = D / 8;       // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BQ * LD;
  bf16* vs = ks + BK * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;      // mma group row, thread in group
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * N * D;
  const bf16* qg = q + base;
  const bf16* kg = k + base;
  const bf16* vg = v + base;

  load_rows_bf16<D, LD>(qs, qg, q0, N);
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per k-step
  uint32_t qa[KSTEPS][4];
  {
    const bf16* r0 = qs + (warp * 16 + g) * LD;
    const bf16* r1 = r0 + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(r0 + c);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(r1 + c);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + c + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + c + 8);
    }
  }

  const float sl2 = scale * LOG2E;   // scores in the log2 domain
  float m[2] = {NEG, NEG};           // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};           // this thread's part of the row sums
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j0 = 0; j0 < N; j0 += BK) {
    __syncthreads();                 // previous tile's readers are done
    load_rows_bf16<D, LD>(ks, kg, j0, N);
    load_rows_bf16<D, LD>(vs, vg, j0, N);
    __syncthreads();

    // S = Q K^T for 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* kr = ks + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }

    // scale, mask the columns past N, row max of this tile
    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + j * 8 + 2 * t + (e & 1);
        const float val = col < N ? s[j][e] * sl2 : NEG;
        s[j][e] = val;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], val);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // p = exp(s - m); row sums in float32, P as bf16 A fragments
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[j][0] - m[0]);
      const float p1 = exp2f(s[j][1] - m[0]);
      const float p2 = exp2f(s[j][2] - m[1]);
      const float p3 = exp2f(s[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      // keys 16 kk + [0, 8) fill a0/a1, keys 16 kk + [8, 16) fill a2/a3
      pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: B(k = key, n = d), gathered from V's rows
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* v0 = vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const bf16* vp = v0 + n * 8;
        const uint32_t b0 = pack_raw(vp[0], vp[LD]);
        const uint32_t b1 = pack_raw(vp[8 * LD], vp[9 * LD]);
        mma_bf16(acc[n], pa[kk], b0, b1);
      }
    }
  }

  // full row sums across the four threads of a row group, then o = acc / l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = 1.f / l[h];
  }
  const int r0 = q0 + warp * 16 + g;
  bf16* og = o + base;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r0 * D + c) =
          __floats2bfloat162_rn(acc[n][0] * l[0], acc[n][1] * l[0]);
    if (r0 + 8 < N)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)(r0 + 8) * D + c) =
          __floats2bfloat162_rn(acc[n][2] * l[1], acc[n][3] * l[1]);
  }
}

// ---------------------------------------------------------------------------
// float32: plain FMA, S and P staged in shared memory
// ---------------------------------------------------------------------------

constexpr int THREADS_F32 = 256;
constexpr int S_LD = BK + 1;

template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld,
                                              const float* src, int row0,
                                              int N) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS_F32) {
    const int r = idx / D, c = idx - r * D;
    dst[r * ld + c] = (row0 + r < N) ? src[(size_t)(row0 + r) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS_F32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int N,
                 float scale) {
  constexpr int QLD = D + 1;      // odd strides: column reads hit 32 banks
  constexpr int DPT = D / 4;      // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + BQ * QLD;
  float* vs = ks + BK * QLD;      // row stride D
  float* ss = vs + BK * D;        // (BQ, S_LD) scores, then p

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;       // S tile: 4 x 4 per thread
  const int row = tid >> 2, part = tid & 3;     // softmax and O: row owner
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * N * D;

  load_rows_f32<D>(qs, QLD, q + base, q0, N);

  float m_run = NEG, l_run = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int j0 = 0; j0 < N; j0 += BK) {
    __syncthreads();
    load_rows_f32<D>(ks, QLD, k + base, j0, N);
    load_rows_f32<D>(vs, D, v + base, j0, N);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * QLD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * QLD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        ss[(ty + 16 * i) * S_LD + col] = j0 + col < N ? s[i][j] * scale
                                                      : NEG;
      }
    __syncthreads();

    // online softmax of row `row`, four threads per row
    float tmax = NEG;
#pragma unroll
    for (int kq = 0; kq < 16; ++kq)
      tmax = fmaxf(tmax, ss[row * S_LD + part + 4 * kq]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int kq = 0; kq < 16; ++kq) {
      const int idx = row * S_LD + part + 4 * kq;
      const float p = expf(ss[idx] - m_new);
      ss[idx] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();  // the row's p values are written by this warp

    // O[row][part + 4 i] = alpha O + sum_j p[row][j] V[j][part + 4 i]
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = ss[row * S_LD + j];
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(p, vs[j * D + part + 4 * i], acc[i]);
    }
  }
  if (q0 + row < N) {
    float* orow = o + base + (size_t)(q0 + row) * D;
    const float inv = 1.f / l_run;
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[part + 4 * i] = acc[i] * inv;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int G, int N, float scale, cudaStream_t st) {
  const dim3 grid((N + BQ - 1) / BQ, G);
  cudaError_t err;
  if (dtype == 0) {
    const size_t smem = (size_t)(BQ + 2 * BK) * (D + 8) * sizeof(bf16);
    err = prepare(flash_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bf16_kernel<D><<<grid, THREADS_BF16, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, N, scale);
  } else {
    const size_t smem =
        ((size_t)(BQ + BK) * (D + 1) + (size_t)BK * D + (size_t)BQ * S_LD)
        * sizeof(float);
    err = prepare(flash_f32_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_f32_kernel<D><<<grid, THREADS_F32, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, N,
        scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = bf16, 1 = float32.
// q, k, v, o: contiguous (G, N, D), D in {64, 128}. Returns
// cudaGetLastError() after the launch (0 = launched); an unsupported D
// returns cudaErrorInvalidValue without launching.

extern "C" int flash_block_rows() { return BQ; }

extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* o, int G, int N, int D,
                               float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(dtype, q, k, v, o, G, N, scale, st);
  if (D == 128) return launch<128>(dtype, q, k, v, o, G, N, scale, st);
  return (int)cudaErrorInvalidValue;
}
