// K2: fused ConvRefiner block for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in gim_tpu/ops/pallas_kernels/
// refiner.py (via `fused_dw_block`). One hidden block of the DKM/RoMa
// ConvRefiner at inference, with BatchNorm's running statistics folded
// into the depthwise taps and bias on the host:
//   h   = relu(depthwise_5x5_same(x) * taps + bdw)      float32
//   out = w1 . cast(h, w1.dtype) + b1                    (C_out x C) 1x1
// for x (B, C, H, W) in PyTorch's NCHW layout; out (B, C_out, H, W) in
// x's dtype. Sums are float32 as in the TPU kernel, and h is cast to the
// weights' dtype before the 1x1 product (refiner.py:70).
//
// Grid (column tile, row tile, image); a block owns a tile of TH x TW =
// 8 x 16 pixels for all channels:
//   1. channel chunk by chunk (16 channels), it stages the halo'd input
//      window (TH + 4) x (TW + 4) in shared memory; rows and columns
//      outside the image load as zeros, which is SAME padding;
//   2. each thread owns one channel and one column of the chunk and slides
//      a 5-row register window down the tile's 8 rows (the 25-tap sum in
//      float32, plus the folded bias and the ReLU), writing h for the
//      whole tile into shared memory in the input dtype;
//   3. the 1x1 conv is one (C_out x C) . (C x 128 pixels) product: for
//      bf16 on the tensor cores (WMMA 16x16x16, bf16 in, float32
//      accumulate), with C and C_out zero-padded to multiples of 16 in
//      shared memory (C = 24 runs as 32); float32 inputs take a plain FMA
//      product in full float32, for checks on the card. b1 is added and
//      the stores are masked at the image's ragged edge.
// No (B, C, H, W) intermediate reaches device memory: x is read once
// (plus the halo, which neighbouring tiles share through L2) and the
// output is written once.
//
// What bounds it. Per pixel it reads C and writes C_out values and does
// 2 (25 C + C C_out) FLOP: at C = C_out = 144 in bf16 that is 576 bytes
// against 48 kFLOP, 84 FLOP per byte, under the H100's 295 FLOP/byte
// ridge; so it is bound by bytes (0.155 ms for (2, 144, 672, 672) at
// 3.35 TB/s). This first version loads the halo with scalar loads and
// without overlap (no cp.async/TMA pipeline), and re-reads the halo rows
// (1.9x the tile) through L2; those are what a faster version removes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int KS = 5;                 // depthwise kernel size
constexpr int R = KS / 2;
constexpr int TH = 8, TW = 16;        // output tile (rows x columns)
constexpr int P = TH * TW;            // pixels per tile
constexpr int HH = TH + KS - 1, HW = TW + KS - 1;   // halo window
constexpr int CC = 16;                // channels per halo chunk
constexpr int THREADS = 256;          // CC x TW: one channel, one column
constexpr int MAXC = 192;             // widest C and C_out taken

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// h row stride in elements: bf16 rows padded by 8 (16 bytes, WMMA's ldm
// rule); float rows are read lane by lane and need no padding.
template <typename T> struct HLd;
template <> struct HLd<bf16> { static constexpr int value = P + 8; };
template <> struct HLd<float> { static constexpr int value = P; };

struct Layout {
  int kpad, mpad, kld;       // padded C, padded C_out, w1 row stride
  size_t w1_off, h_off, halo_off, stage_off, bytes;
};

template <typename T>
__host__ __device__ Layout layout(int C, int C_out) {
  Layout L;
  L.kpad = round16(C);
  L.mpad = round16(C_out);
  L.kld = L.kpad + 8;
  const bool tc = std::is_same<T, bf16>::value;
  L.w1_off = 0;
  L.h_off = tc ? (size_t)L.mpad * L.kld * sizeof(T) : 0;
  L.halo_off = L.h_off + (size_t)L.kpad * HLd<T>::value * sizeof(T);
  L.stage_off = L.halo_off + (size_t)CC * HH * HW * sizeof(T);
  L.stage_off = (L.stage_off + 127) / 128 * 128;
  L.bytes = L.stage_off + (tc ? (size_t)(THREADS / 32) * 256 * sizeof(float)
                              : 0);
  return L;
}

// Depthwise 5x5 + bias + ReLU for all channels of the tile, into h_s.
template <typename T>
__device__ __forceinline__ void depthwise(const T* __restrict__ xb,
                                          const T* __restrict__ wdw,
                                          const T* __restrict__ bdw, int C,
                                          int H, int W, int y0, int x0,
                                          int kpad, T* h_s, T* halo) {
  constexpr int HLD = HLd<T>::value;
  const int tid = threadIdx.x;
  const int cl = tid / TW, tx = tid % TW;
  for (int c0 = 0; c0 < kpad; c0 += CC) {
    __syncthreads();                   // previous chunk's readers are done
    for (int idx = tid; idx < CC * HH * HW; idx += THREADS) {
      const int ch = idx / (HH * HW), rem = idx - ch * (HH * HW);
      const int hr = rem / HW, hc = rem - hr * HW;
      const int c = c0 + ch, gy = y0 - R + hr, gx = x0 - R + hc;
      T val = from_f<T>(0.f);
      if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        val = xb[((size_t)c * H + gy) * W + gx];
      halo[idx] = val;
    }
    __syncthreads();
    const int c = c0 + cl;
    float acc[TH];
#pragma unroll
    for (int r = 0; r < TH; ++r) acc[r] = 0.f;
    if (c < C) {
      float w[KS * KS];
#pragma unroll
      for (int i = 0; i < KS * KS; ++i) w[i] = to_f(wdw[c * KS * KS + i]);
      const T* hp = halo + cl * HH * HW + tx;
#pragma unroll
      for (int hr = 0; hr < HH; ++hr) {
        float v[KS];
#pragma unroll
        for (int b = 0; b < KS; ++b) v[b] = to_f(hp[hr * HW + b]);
#pragma unroll
        for (int r = 0; r < TH; ++r) {
          const int a = hr - r;        // tap row of this halo row for row r
          if (a >= 0 && a < KS) {
#pragma unroll
            for (int b = 0; b < KS; ++b)
              acc[r] = fmaf(w[a * KS + b], v[b], acc[r]);
          }
        }
      }
      const float bias = to_f(bdw[c]);
#pragma unroll
      for (int r = 0; r < TH; ++r) acc[r] = fmaxf(acc[r] + bias, 0.f);
    }
    // channels past C hold zeros: they pad the product's K dimension
#pragma unroll
    for (int r = 0; r < TH; ++r) h_s[c * HLD + r * TW + tx] = from_f<T>(acc[r]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
refiner_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wdw,
                    const bf16* __restrict__ bdw, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, bf16* __restrict__ out,
                    int C, int C_out, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int HLD = HLd<bf16>::value;
  const Layout L = layout<bf16>(C, C_out);
  bf16* w1_s = reinterpret_cast<bf16*>(smem_raw + L.w1_off);
  bf16* h_s = reinterpret_cast<bf16*>(smem_raw + L.h_off);
  bf16* halo = reinterpret_cast<bf16*>(smem_raw + L.halo_off);
  float* stage = reinterpret_cast<float*>(smem_raw + L.stage_off);

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;

  // w1 zero-padded to (mpad, kpad); the depthwise phase syncs before use
  for (int idx = tid; idx < L.mpad * L.kpad; idx += THREADS) {
    const int m = idx / L.kpad, kc = idx - m * L.kpad;
    w1_s[m * L.kld + kc] = (m < C_out && kc < C) ? w1[m * C + kc]
                                                 : __float2bfloat16_rn(0.f);
  }
  depthwise<bf16>(x + (size_t)b * C * H * W, wdw, bdw, C, H, W, y0, x0,
                  L.kpad, h_s, halo);

  // out tile (mpad x 128) = w1_s (mpad x kpad) . h_s (kpad x 128)
  const int warp = tid >> 5, lane = tid & 31;
  float* st = stage + warp * 256;
  const int n_tiles = (L.mpad / 16) * TH;     // 16-pixel n-tile = one row
  for (int tile = warp; tile < n_tiles; tile += THREADS / 32) {
    const int mi = tile / TH, ni = tile - mi * TH;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < L.kpad; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, w1_s + mi * 16 * L.kld + kk, L.kld);
      wmma::load_matrix_sync(fb, h_s + kk * HLD + ni * 16, HLD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    const int co = mi * 16 + (lane >> 1), px0 = (lane & 1) * 8;
    const int gy = y0 + ni;
    if (co < C_out && gy < H) {
      const float bias = __bfloat162float(b1[co]);
      bf16* orow = out + (((size_t)b * C_out + co) * H + gy) * W;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int gx = x0 + px0 + e;
        if (gx < W)
          orow[gx] = __float2bfloat16_rn(st[(lane >> 1) * 16 + px0 + e]
                                         + bias);
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(THREADS)
refiner_f32_kernel(const float* __restrict__ x, const float* __restrict__ wdw,
                   const float* __restrict__ bdw,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   float* __restrict__ out, int C, int C_out, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout L = layout<float>(C, C_out);
  float* h_s = reinterpret_cast<float*>(smem_raw + L.h_off);
  float* halo = reinterpret_cast<float*>(smem_raw + L.halo_off);

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  depthwise<float>(x + (size_t)b * C * H * W, wdw, bdw, C, H, W, y0, x0,
                   L.kpad, h_s, halo);

  // out[co][p] = b1[co] + sum_c w1[co][c] h[c][p]: a thread owns pixel p
  // and every other output channel; w1 reads are warp-uniform (broadcast)
  const int p = tid % P;
  const int gy = y0 + p / TW, gx = x0 + p % TW;
  if (gy >= H || gx >= W) return;
  for (int co = tid / P; co < C_out; co += THREADS / P) {
    const float* wr = w1 + (size_t)co * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = fmaf(__ldg(wr + c), h_s[c * P + p], acc);
    out[(((size_t)b * C_out + co) * H + gy) * W + gx] = acc + b1[co];
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
// x (B, C, H, W), wdw (C, 25), bdw (C,), w1 (C_out, C), b1 (C_out,) and
// out (B, C_out, H, W) are contiguous and of one dtype; C, C_out <= 192.
// Returns cudaGetLastError() after the launch (0 = launched); shapes it
// does not take return cudaErrorInvalidValue without launching.

extern "C" int refiner_max_channels() { return MAXC; }

extern "C" int refiner_block(int dtype, const void* x, const void* wdw,
                             const void* bdw, const void* w1, const void* b1,
                             void* out, int B, int C, int C_out, int H, int W,
                             void* stream) {
  if (C < 1 || C > MAXC || C_out < 1 || C_out > MAXC || B < 1 || B > 65535
      || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    const size_t smem = layout<bf16>(C, C_out).bytes;
    err = prepare(refiner_bf16_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    refiner_bf16_kernel<<<grid, THREADS, smem, st>>>(
        (const bf16*)x, (const bf16*)wdw, (const bf16*)bdw, (const bf16*)w1,
        (const bf16*)b1, (bf16*)out, C, C_out, H, W);
  } else {
    const size_t smem = layout<float>(C, C_out).bytes;
    err = prepare(refiner_f32_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    refiner_f32_kernel<<<grid, THREADS, smem, st>>>(
        (const float*)x, (const float*)wdw, (const float*)bdw,
        (const float*)w1, (const float*)b1, (float*)out, C, C_out, H, W);
  }
  return (int)cudaGetLastError();
}
