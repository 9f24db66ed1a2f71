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
// weights' dtype before the 1x1 product (refiner.py:70). No (B, C, H, W)
// intermediate reaches device memory.
//
// What bounds it. Per pixel it reads C and writes C_out values and does
// 2 (25 C + C C_out) FLOP: at C = C_out = 144 in bf16 that is 576 bytes
// against 48 kFLOP, 84 FLOP per byte, under the H100's 295 FLOP/byte
// ridge; so it is bound by bytes (0.155 ms for (2, 144, 672, 672) at
// 3.35 TB/s). Next come the depthwise FMAs in float32 (25 per channel and
// pixel: 0.10 ms at 67 TFLOP/s for that shape); the 1x1's tensor-core
// time is a tenth of that.
//
// bf16 design: persistent, warp-specialised blocks, one per SM, each
// with w1, the folded taps and both biases staged in shared memory once,
// walking over output tiles of TH x 32 pixels (tile t, t + grid, ...) in
// chunks of CCH = 32 input channels. TH = 8 for C_out <= 48 (the 24-wide
// blocks), TH = 4 above (the 1x1's accumulators set the tile: 128 pixels
// x C_out floats in registers).
//   - 8 depthwise warps issue the halo'd window of the next chunks (TH + 4
//     rows x 48 columns, the 16-byte aligned superset of what the taps
//     read) as 16-byte cp.async with zero fill outside the image (SAME
//     padding) into a ring of 3-4 chunks that runs across tiles, so loads
//     overlap compute. A width that is not a multiple of 8 (or an
//     unaligned base) takes element loads into the same ring instead.
//     Each lane then holds 2 columns x 4 rows of one channel in float32
//     registers and slides down 8 window rows read as bf16x2 words; bias,
//     ReLU, and h goes to a ring of h chunks in shared memory as bf16,
//     never the whole of C.
//   - 8 1x1 warps, behind mbarriers (h full / h empty), each own 16 or 32
//     pixels and all of C_out: h (ldmatrix.trans) times w1 (ldmatrix)
//     through mma.sync.m16n8k16, pixels on M and C_out on N (C_out only
//     pads to a multiple of 8). At a tile's last chunk they add b1 and
//     write bf16 through per-warp staging rows as 16-byte stores.
//   The two roles overlap: the FMA pipe runs the depthwise while the
//   tensor cores run the 1x1 and the stores drain. setmaxnreg gives the
//   1x1 warps the registers of their accumulators.
// What holds it back now (per-shape ratios in PERF.md): the depthwise
// side issues ~40 instructions per output (25 FMAs, window loads and
// unpacking, the taps), on 8 warps; the 1x1 on mma.sync is next.
//
// float32 design (the dense heads' default dtype). The same roles carry
// float32 data: 8 depthwise warps and one 1x1 warpgroup (384 threads),
// chunks of 16 channels, tiles of TH x 32 pixels (TH = 8 for C_out <= 48,
// else 4).
//   - Halo: one thread issues each chunk's window as one TMA box (40
//     columns x TH + 4 rows x 16 channels of x seen as (W, H, C, B); the
//     hardware's zero fill outside the image and past C is SAME padding)
//     into a ring of up to 4 stages, each tracked by a full and an empty
//     mbarrier, so a depthwise warp waits only for its own chunk. Where
//     W % 4 != 0 or x is not 16-byte aligned, element loads fill the same
//     ring behind a barrier of the depthwise warps. (16-byte cp.async
//     issued by every thread kept the depthwise warps busy issuing.)
//   - The depthwise stays in FP32 FMAs: a lane holds 2 columns x 4 rows
//     of one channel (a half-warp a channel), reads window rows as float2
//     and its channel's folded taps and bias, staged in shared memory once
//     per block, as 16-byte vectors.
//   - The 1x1 runs on the tensor cores as 3xTF32, wgmma.m64nNk8 .tf32
//     with N = C_out padded to 8 and float32 accumulators: each operand
//     splits into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest
//     with ties away from zero, and the product sums lo.hi + hi.lo +
//     hi.hi (hopper.cuh). One TF32 product keeps about 3 digits (1.1-1.5e-3
//     against float64 for C = 24-192, over the float32 tolerance of 1e-4);
//     3xTF32 stays within float32's own rounding (tests/test_torch_
//     refiner.py emulates both). A register-blocked SIMT 1x1 could not go
//     below the FP32 bound, which the 1x1 alone sets at C = 144 (20736 of
//     a pixel's 24336 FMAs); 3xTF32 on the tensor cores can. A is h, from
//     registers (word loads at a pitch of 8 mod 32, split once per
//     k-step), the warpgroup's MT m64 tiles of the tile's pixels.
//   - Shared memory: hi and lo copies of the whole of w1 would not fit
//     beside the rings at C = C_out = 192 (295 KB). So a split pass (one
//     small kernel a call) writes w1's hi and lo parts chunk by chunk, in
//     wgmma's K-major layout, to a scratch buffer, and each stage of the h
//     ring carries its chunk's parts beside h (one bulk copy, NT KB,
//     issued with the chunk and read from L2).
//   - The epilogue adds b1 and stores straight from the accumulators: 8
//     consecutive pixels of 4 channels a store, whole 32-byte sectors
//     where W % 8 == 0.
//   Bounds, per gim_dkm dense call at 672 (32 launches; chip_smoke.py
//   computes both from each run's shapes): the design's floor, bytes at
//   3.35 TB/s or the depthwise's FP32 FMAs at 66.9 TFLOP/s plus the 1x1's
//   three TF32 products at 495 TFLOP/s, whichever is larger (5.53 ms);
//   and the FP32-FMA figure, every FLOP at 66.9 TFLOP/s (8.995 ms).
//   What holds it back (PERF.md; f32_probe.py's ablations): the skeleton.
//   Without the 1x1's products and the depthwise FMAs a gim_dkm call
//   takes 10.596 of 12.018 ms: the TMA halo boxes, w1's parts read from
//   L2, the rings' barriers and the stores, not the arithmetic.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int KS = 5;                 // depthwise kernel size
constexpr int R = KS / 2;
constexpr int MAXC = 192;             // widest C and C_out taken

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// ---------------------------------------------------------------------------
// bf16: persistent warp-specialised blocks, cp.async halo ring, mma.sync 1x1
// ---------------------------------------------------------------------------

constexpr int TW = 32;                // output tile columns
constexpr int THREADS = 512;          // 8 depthwise warps, 8 1x1 warps
constexpr int HALF = THREADS / 2;
constexpr int WIN_X = 8;              // window column 0 is image column x0 - 8
constexpr int WIN_VEC = (TW + 2 * WIN_X) / 8;   // 6 vectors of 8 per row
constexpr int WIN_LD = 56;            // window row pitch (16-byte rows)
constexpr int OUT_LD = 24;            // output staging row pitch (16 px)
constexpr int CCH = 32;               // channels per chunk (bf16)

constexpr size_t SMEM_MAX = 232448;   // bytes a block may use (227 KB)

struct Bf16Layout {
  int cpad, w1ld;                     // C padded to a chunk, w1 pitch
  size_t taps, bdw, b1, halo, h, out, bars, bytes;
};

// Shared memory of the bf16 kernel: w1, taps, biases, the halo ring of
// `stages` chunks (stage_elems each), the h ring of `hs` chunks (rows of
// h_ld), the output staging rows and the h barriers.
__host__ __device__ constexpr Bf16Layout bf16_layout(int C, int nt,
                                                     int stage_elems, int h_ld,
                                                     int stages, int hs) {
  Bf16Layout L{};
  L.cpad = round_up(C, CCH);
  L.w1ld = L.cpad + 8;
  L.taps = round_up(nt * 8 * L.w1ld * 2, 16);
  L.bdw = L.taps + (size_t)L.cpad * KS * KS * 4;
  L.b1 = L.bdw + (size_t)L.cpad * 4;
  L.halo = round_up((int)(L.b1 + nt * 8 * 4), 128);
  L.h = L.halo + (size_t)stages * stage_elems * 2;
  L.out = L.h + (size_t)hs * CCH * h_ld * 2;
  L.bars = L.out + (size_t)(HALF / 32) * 16 * OUT_LD * 2;
  L.bytes = L.bars + 8 * 2 * hs;
  return L;
}

// Tile geometry for TH output rows (4 or 8) of TW columns and chunks of
// CCH channels. A depthwise lane covers 2 columns x 4 rows of
// one channel at a time; the two half-warps take two channels, whose
// windows sit 16 banks apart.
template <int TH>
struct Geo {
  static constexpr int TP = TH * TW;              // pixels per tile
  static constexpr int MT = TP / (16 * (HALF / 32));   // m16 tiles per warp
  static constexpr int WIN_H = TH + KS - 1;       // window rows
  static constexpr int WIN_CH =
      WIN_H * WIN_LD + ((16 - (WIN_H * WIN_LD / 2) % 32 + 32) % 32) * 2;
  static constexpr int STAGE = CCH * WIN_CH;      // elements per ring stage
  static constexpr int H_LD = TP + 8;             // h rows 4 banks apart
};

template <int NT, int TH>
constexpr bool rings_fit(int stages, int hs) {
  using G = Geo<TH>;
  return bf16_layout(MAXC, NT, G::STAGE, G::H_LD, stages, hs).bytes
         <= SMEM_MAX;
}

// Ring depths (chunks) of the halo windows and of h: the deepest that fit
// for every C up to MAXC.
template <int NT, int TH>
struct Rings {
  static constexpr int STAGES = rings_fit<NT, TH>(4, 4) ? 4 : 3;
  static constexpr int HS = rings_fit<NT, TH>(STAGES, 4) ? 4 : 2;
  static_assert(rings_fit<NT, TH>(STAGES, HS), "shared memory");
  __host__ __device__ static Bf16Layout layout(int C) {
    using G = Geo<TH>;
    return bf16_layout(C, NT, G::STAGE, G::H_LD, STAGES, HS);
  }
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

struct Tile {
  int b, y0, x0;
};

template <int TH>
__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y) {
  const int tx = t % tiles_x, r = t / tiles_x;
  return {r / tiles_y, (r % tiles_y) * TH, tx * TW};
}

// Issue the window of channels [c0, c0 + CCH) of tile `tl` into `dst`.
// Rows and columns outside the image read as zeros; channels past C are
// not loaded (their warps write zero h without reading). A thread keeps
// one (row, vector) slot of the window and walks over every GROUPS-th
// channel, so its addresses and masks are worked out once per chunk.
template <int TH>
__device__ __forceinline__ void load_window(bf16* dst,
                                            const bf16* __restrict__ x,
                                            Tile tl, int c0, int C, int H,
                                            int W, bool vec) {
  using G = Geo<TH>;
  constexpr int SLOTS = G::WIN_H * WIN_VEC, GROUPS = HALF / SLOTS;
  const int t = threadIdx.x;
  if (t >= SLOTS * GROUPS) return;
  const int slot = t % SLOTS, grp = t / SLOTS;
  const int v = slot % WIN_VEC, rr = slot / WIN_VEC;
  const int y = tl.y0 - R + rr, xc = tl.x0 - WIN_X + 8 * v;
  const bool row_ok = y >= 0 && y < H;
  const int n_ch = min(CCH, C - c0);
  const size_t plane = (size_t)H * W;
  const bf16* src = x + ((size_t)tl.b * C + c0 + grp) * plane
                    + (size_t)(row_ok ? y : 0) * W;
  bf16* d = dst + grp * G::WIN_CH + rr * WIN_LD + 8 * v;
  if (vec) {
    const bool ok = row_ok && xc >= 0 && xc < W;
    for (int ch = grp; ch < n_ch; ch += GROUPS) {
      cp_async16(d, ok ? src + xc : x, ok);
      src += GROUPS * plane;
      d += GROUPS * G::WIN_CH;
    }
  } else {
    for (int ch = grp; ch < n_ch; ch += GROUPS) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int xe = xc + e;
        d[e] = (row_ok && xe >= 0 && xe < W) ? src[xe]
                                             : __float2bfloat16_rn(0.f);
      }
      src += GROUPS * plane;
      d += GROUPS * G::WIN_CH;
    }
  }
}

// Depthwise 5x5 + bias + ReLU of 4 rows of one channel: the lane holds
// columns 2 cp, 2 cp + 1 and slides down the 8 window rows they need
// (win points at the first). Writes h (bf16) rows of TW pixels.
__device__ __forceinline__ void depthwise(const bf16* win, const float* taps,
                                          float bias, bool live, bf16* h) {
  constexpr int TH = 4, WIN_H = TH + KS - 1;
  const int cp = threadIdx.x % 16;
  float a0[TH] = {0.f, 0.f, 0.f, 0.f}, a1[TH] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    float w[KS * KS];
#pragma unroll
    for (int i = 0; i < KS * KS; ++i) w[i] = taps[i];
    // window column of image column x0 + 2 cp - 2
    const bf16* p = win + WIN_X - R + 2 * cp;
#pragma unroll
    for (int i = 0; i < WIN_H; ++i) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(p + i * WIN_LD);
      const uint32_t u0 = q[0], u1 = q[1], u2 = q[2];
      const float v[6] = {lo_f(u0), hi_f(u0), lo_f(u1),
                          hi_f(u1), lo_f(u2), hi_f(u2)};
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        const int a = i - r;            // tap row of window row i for row r
        if (a >= 0 && a < KS) {
#pragma unroll
          for (int bb = 0; bb < KS; ++bb) {
            a0[r] = fmaf(w[a * KS + bb], v[bb], a0[r]);
            a1[r] = fmaf(w[a * KS + bb], v[bb + 1], a1[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      a0[r] = fmaxf(a0[r] + bias, 0.f);
      a1[r] = fmaxf(a1[r] + bias, 0.f);
    }
  }
#pragma unroll
  for (int r = 0; r < TH; ++r)
    *reinterpret_cast<__nv_bfloat162*>(h + r * TW + 2 * cp) =
        __floats2bfloat162_rn(a0[r], a1[r]);
}

// acc (MT m16 tiles of this warp's pixels x NT * 8 output channels) +=
// h^T w1^T for one chunk: A from h [channel][pixel] (ldmatrix.trans), B
// from w1 [c_out][c] (ldmatrix), shared by the m tiles.
template <int NT, int TH>
__device__ __forceinline__ void pointwise(float (*acc)[NT][4], const bf16* h,
                                          const bf16* w1_s, int w1ld, int c0,
                                          int wm) {
  using G = Geo<TH>;
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8, rr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < CCH / 16; ++kk, h += 16 * G::H_LD, c0 += 16) {
  uint32_t a[G::MT][4];
#pragma unroll
  for (int m = 0; m < G::MT; ++m)
    ldmatrix_x4_trans(a[m], h + ((mi >> 1) * 8 + rr) * G::H_LD
                                + (wm * G::MT + m) * 16 + (mi & 1) * 8);
#pragma unroll
  for (int n = 0; n + 1 < NT; n += 2) {
    uint32_t b[4];
    ldmatrix_x4(b, w1_s + (8 * (n + (mi >> 1)) + rr) * w1ld + c0
                       + (mi & 1) * 8);
#pragma unroll
    for (int m = 0; m < G::MT; ++m) {
      mma_bf16(acc[m][n], a[m], b[0], b[1]);
      mma_bf16(acc[m][n + 1], a[m], b[2], b[3]);
    }
  }
  if (NT % 2) {
    uint32_t b[2];
    ldmatrix_x2(b, w1_s + (8 * (NT - 1) + rr) * w1ld + c0 + (mi & 1) * 8);
#pragma unroll
    for (int m = 0; m < G::MT; ++m) mma_bf16(acc[m][NT - 1], a[m], b[0], b[1]);
  }
  }
}

// out = acc + b1 for 16 pixels (p0 .. p0 + 15 of the tile), bf16: 16
// output channels at a time go through the warp's staging rows in shared
// memory and leave as 16-byte stores along the row (element stores at a
// ragged or unaligned edge). Resets acc.
template <int NT>
__device__ __forceinline__ void store_px(float (*acc)[4], const float* b1_s,
                                         bf16* stage, bf16* __restrict__ out,
                                         Tile tl, int p0, int C_out, int H,
                                         int W, bool vec) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int y = tl.y0 + p0 / TW, x0 = tl.x0 + p0 % TW;
  if (y < H && x0 < W) {
#pragma unroll
    for (int np = 0; np < (NT + 1) / 2; ++np) {
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int n = 2 * np + nn;
        if (n < NT) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cl = 8 * nn + 2 * t + (e & 1);
            stage[cl * OUT_LD + g + (e >> 1) * 8] =
                __float2bfloat16_rn(acc[n][e] + b1_s[16 * np + cl]);
          }
        }
      }
      __syncwarp();
      const int cl = lane / 2, q = lane % 2;
      const int co = 16 * np + cl, xq = x0 + 8 * q;
      if (co < C_out && xq < W) {
        const bf16* src = stage + cl * OUT_LD + 8 * q;
        bf16* dst = out + (((size_t)tl.b * C_out + co) * H + y) * W + xq;
        if (vec && xq + 8 <= W) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && xq + e < W; ++e) dst[e] = src[e];
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

template <int NT, int TH>
__global__ void __launch_bounds__(THREADS, 1)
refiner_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wdw,
                    const bf16* __restrict__ bdw, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, bf16* __restrict__ out,
                    int C, int C_out, int H, int W, int tiles_x, int tiles_y,
                    int n_tiles, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  using G = Geo<TH>;
  using RG = Rings<NT, TH>;
  constexpr int STAGES = RG::STAGES, HS = RG::HS;
  const Bf16Layout L = RG::layout(C);
  bf16* w1_s = reinterpret_cast<bf16*>(smem);
  float* taps_s = reinterpret_cast<float*>(smem + L.taps);
  float* bdw_s = reinterpret_cast<float*>(smem + L.bdw);
  float* b1_s = reinterpret_cast<float*>(smem + L.b1);
  bf16* halo = reinterpret_cast<bf16*>(smem + L.halo);
  bf16* h_s = reinterpret_cast<bf16*>(smem + L.h);
  bf16* stage_s = reinterpret_cast<bf16*>(smem + L.out);
  const uint32_t bars = smem_u32(smem + L.bars);
  auto h_full = [&](int s) { return bars + 8u * s; };
  auto h_empty = [&](int s) { return bars + 8u * (HS + s); };
  const int tid = threadIdx.x;

  // parameters once per block, zero-padded to (NT * 8, cpad)
  for (int i = tid; i < NT * 8 * L.cpad; i += THREADS) {
    const int co = i / L.cpad, c = i - co * L.cpad;
    w1_s[co * L.w1ld + c] = (co < C_out && c < C) ? w1[co * C + c]
                                                  : __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < L.cpad * KS * KS; i += THREADS)
    taps_s[i] = i < C * KS * KS ? __bfloat162float(wdw[i]) : 0.f;
  for (int i = tid; i < L.cpad; i += THREADS)
    bdw_s[i] = i < C ? __bfloat162float(bdw[i]) : 0.f;
  for (int i = tid; i < NT * 8; i += THREADS)
    b1_s[i] = i < C_out ? __bfloat162float(b1[i]) : 0.f;
  if (tid == 0) {
    for (int s = 0; s < HS; ++s) {
      mbar_init(h_full(s), HALF / 32);     // one arrival per warp
      mbar_init(h_empty(s), HALF / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // chunk g of this block: tile blockIdx.x + (g / nck) gridDim.x,
  // channels (g % nck) * CCH ...
  const int nck = L.cpad / CCH;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1)
                       / (int)gridDim.x;
  const int total = my_tiles * nck;
  auto tile_of = [&](int g) {
    return tile_at<TH>(blockIdx.x + (g / nck) * gridDim.x, tiles_x,
                       tiles_y);
  };

  if (tid < HALF) {
    // ---- depthwise warps: loads, depthwise, h ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n");
    const int wd = tid / 32;
    auto issue = [&](int g) {
      if (g < total)
        load_window<TH>(halo + (g % STAGES) * G::STAGE, x, tile_of(g),
                             (g % nck) * CCH, C, H, W, vec != 0);
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s);
    for (int g = 0; g < total; ++g) {
      cp_async_wait<STAGES - 2>();      // chunk g's window has landed ...
      asm volatile("bar.sync 1, %0;\n" ::"n"(HALF) : "memory");
      issue(g + STAGES - 1);            // ... for all; chunk g - 1's stage
                                        // is free
      const int hs = g % HS;
      if (g >= HS) mbar_wait(h_empty(hs), ((g / HS) - 1) & 1);
      const bf16* win = halo + (g % STAGES) * G::STAGE;
      bf16* h = h_s + hs * CCH * G::H_LD;
#pragma unroll
      for (int k = 0; k < CCH / 16; ++k) {
        const int ch = 16 * k + 2 * wd + (tid % 32) / 16;
        const int c = (g % nck) * CCH + ch;
#pragma unroll
        for (int rb = 0; rb < TH / 4; ++rb)   // blocks of 4 output rows
          depthwise(win + ch * G::WIN_CH + 4 * rb * WIN_LD,
                    taps_s + c * KS * KS, bdw_s[c], c < C,
                    h + ch * G::H_LD + 4 * rb * TW);
      }
      __syncwarp();                     // the warp's h writes, then lane 0
      if (tid % 32 == 0) mbar_arrive(h_full(hs));
    }
  } else {
    // ---- 1x1 warps: products, epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    const int wm = (tid - HALF) / 32;
    bf16* stage = stage_s + wm * 16 * OUT_LD;
    float acc[G::MT][NT][4];
#pragma unroll
    for (int m = 0; m < G::MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    for (int g = 0; g < total; ++g) {
      const int hs = g % HS;
      mbar_wait(h_full(hs), (g / HS) & 1);
      pointwise<NT, TH>(acc, h_s + hs * CCH * G::H_LD, w1_s, L.w1ld,
                             (g % nck) * CCH, wm);
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(h_empty(hs));
      if (g % nck == nck - 1) {
        const Tile tl = tile_of(g);
#pragma unroll
        for (int m = 0; m < G::MT; ++m)
          store_px<NT>(acc[m], b1_s, stage, out, tl, (wm * G::MT + m) * 16,
                       C_out, H, W, vec != 0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: persistent warp-specialised blocks, TMA halo ring, the 1x1 in
// 3xTF32 on wgmma
// ---------------------------------------------------------------------------

constexpr int THREADS_F32 = 384;      // 8 depthwise warps, 1x1 warpgroup
constexpr int DW_F32 = 256;           // depthwise threads (warpgroups 0, 1)
constexpr int MMA_WARPS_F32 = (THREADS_F32 - DW_F32) / 32;
constexpr int CCH_F32 = 16;           // channels per chunk: one per half-warp
constexpr int WIN_X_F32 = 4;          // window column 0 is image column x0 - 4
constexpr int WIN_VEC_F32 = (TW + 2 * WIN_X_F32) / 4;   // 10 vectors of 4
constexpr int WIN_LD_F32 = 4 * WIN_VEC_F32;             // window row pitch
constexpr int W1_SBO = CCH_F32 / 4 * CORE;   // w1 parts: 16 columns a row
constexpr int TAP_LD = 28;            // a channel's 25 taps, its bias, pad

// Tile geometry for TH output rows (4 or 8) of TW columns: MT m64 tiles
// of pixels for the 1x1 warpgroup (2 or 4).
template <int TH>
struct GeoF {
  static constexpr int TP = TH * TW;              // pixels per tile
  static constexpr int MT = TP / 64;
  static constexpr int WIN_H = TH + KS - 1;       // window rows
  static constexpr int WIN_CH = WIN_H * WIN_LD_F32;
  static constexpr int STAGE = CCH_F32 * WIN_CH;  // floats per halo stage
  static constexpr int H_LD = TP + 8;   // A loads (channel t, pixel g): 8 t + g
};

// One chunk of w1 split into TF32 hi and lo parts, each NT * 8 rows (c_out)
// x 16 columns (c) K-major without swizzle: what the split pass writes per
// chunk and what each stage of the h ring carries beside its h.
template <int NT>
__host__ __device__ constexpr int w1_part() { return NT * 8 * CCH_F32; }

struct F32Layout {
  size_t taps, halo, h, bars, bytes;
};

// Shared memory of the float32 kernel: b1, the folded taps and bias of
// every channel (rows of TAP_LD, read as 16-byte vectors), the halo ring
// of `stages` chunks (128-byte aligned TMA boxes), the h ring of `hs`
// chunks (h in rows of h_ld, then the chunk's w1 parts) and the barriers
// (halo full, halo empty, h full, w1 full, h empty).
__host__ __device__ constexpr F32Layout f32_layout(int nt, int stage_elems,
                                                   int h_stage, int stages,
                                                   int hs) {
  F32Layout L{};
  L.taps = round_up(nt * 8 * 4, 16);
  L.halo = round_up((int)L.taps + MAXC * TAP_LD * 4, 128);
  L.h = L.halo + (size_t)stages * stage_elems * 4;
  L.bars = L.h + (size_t)hs * h_stage * 4;
  L.bytes = L.bars + 8 * (2 * stages + 3 * hs);
  return L;
}

template <int NT, int TH>
constexpr F32Layout f32_rings(int stages, int hs) {
  using G = GeoF<TH>;
  return f32_layout(NT, G::STAGE, CCH_F32 * G::H_LD + 2 * w1_part<NT>(),
                    stages, hs);
}

// Ring depths (chunks): the deepest halo ring, then h ring, that fit.
template <int NT, int TH>
struct RingsF {
  static constexpr int STAGES = f32_rings<NT, TH>(4, 2).bytes <= SMEM_MAX ? 4
                                : f32_rings<NT, TH>(3, 2).bytes <= SMEM_MAX
                                    ? 3
                                    : 2;
  static constexpr int HS = f32_rings<NT, TH>(STAGES, 4).bytes <= SMEM_MAX ? 4
                            : f32_rings<NT, TH>(STAGES, 3).bytes <= SMEM_MAX
                                ? 3
                                : 2;
  static constexpr F32Layout L = f32_rings<NT, TH>(STAGES, HS);
  static_assert(L.bytes <= SMEM_MAX, "shared memory");
  static constexpr int H_STAGE =
      CCH_F32 * GeoF<TH>::H_LD + 2 * w1_part<NT>();
};

// The split pass of w1: block kc writes chunk kc's hi and lo parts (zeros
// past C_out and C) into the scratch buffer.
template <int NT>
__global__ void __launch_bounds__(128)
refiner_split_w1(const float* __restrict__ w1, float* __restrict__ w1s,
                 int C, int C_out) {
  constexpr int PART = w1_part<NT>();
  char* chunk = reinterpret_cast<char*>(w1s + (size_t)blockIdx.x * 2 * PART);
  for (int i = threadIdx.x; i < PART; i += blockDim.x) {
    const int co = i / CCH_F32, cl = i % CCH_F32;
    const int c = blockIdx.x * CCH_F32 + cl;
    uint32_t hi, lo;
    split_tf32(co < C_out && c < C ? w1[co * C + c] : 0.f, hi, lo);
    const int off = kmajor(co, cl, W1_SBO);
    *reinterpret_cast<uint32_t*>(chunk + off) = hi;
    *reinterpret_cast<uint32_t*>(chunk + PART * 4 + off) = lo;
  }
}

// The window of channels [c0, c0 + CCH_F32) of tile `tl`: TH + 4 rows x
// 40 columns (image columns x0 - 4 .. x0 + 35, the 16-byte aligned
// superset of what the taps read), rows and columns outside the image
// and channels past C as zeros. With `vec` (W % 4 == 0, 16-byte aligned
// x) one TMA box (issued by one thread, tracked by the stage's full
// barrier), else element loads by the depthwise threads into the same
// ring (channels past C are then not loaded and not read).
template <int TH>
__device__ __forceinline__ void load_window_f32(float* dst,
                                                const CUtensorMap* map,
                                                uint32_t full,
                                                const float* __restrict__ x,
                                                Tile tl, int c0, int C, int H,
                                                int W, bool vec) {
  using G = GeoF<TH>;
  if (vec) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(full, G::STAGE * 4);
      tma_load_4d(smem_u32(dst), map, full, tl.x0 - WIN_X_F32, tl.y0 - R,
                  c0, tl.b);
    }
    return;
  }
  constexpr int SLOTS = G::WIN_H * WIN_VEC_F32, GROUPS = DW_F32 / SLOTS;
  const int t = threadIdx.x;
  if (t >= SLOTS * GROUPS) return;
  const int slot = t % SLOTS, grp = t / SLOTS;
  const int v = slot % WIN_VEC_F32, rr = slot / WIN_VEC_F32;
  const int y = tl.y0 - R + rr, xc = tl.x0 - WIN_X_F32 + 4 * v;
  const bool row_ok = y >= 0 && y < H;
  const int n_ch = min(CCH_F32, C - c0);
  const size_t plane = (size_t)H * W;
  const float* src = x + ((size_t)tl.b * C + c0 + grp) * plane
                     + (size_t)(row_ok ? y : 0) * W;
  float* d = dst + grp * G::WIN_CH + rr * WIN_LD_F32 + 4 * v;
  for (int ch = grp; ch < n_ch; ch += GROUPS) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int xe = xc + e;
      d[e] = (row_ok && xe >= 0 && xe < W) ? src[xe] : 0.f;
    }
    src += GROUPS * plane;
    d += GROUPS * G::WIN_CH;
  }
}

// Depthwise 5x5 + bias + ReLU of TH rows of one channel, in blocks of 4
// rows: the lane holds columns 2 cp, 2 cp + 1 and slides down the 8
// window rows a block needs, read as float2 (win points at the channel's
// window; taps at its row of folded taps and bias). Writes h rows of TW
// pixels; zeros for a channel past C.
template <int TH>
__device__ __forceinline__ void depthwise_f32(const float* win,
                                              const float* taps, bool live,
                                              float* h) {
  constexpr int RB = 4, WIN_H = RB + KS - 1;
  const int cp = threadIdx.x % 16;
  float w[TAP_LD];                      // 25 taps, then the bias
  if (live) {
#pragma unroll
    for (int i = 0; i < TAP_LD / 4; ++i) {
      const float4 v4 = reinterpret_cast<const float4*>(taps)[i];
      w[4 * i] = v4.x;
      w[4 * i + 1] = v4.y;
      w[4 * i + 2] = v4.z;
      w[4 * i + 3] = v4.w;
    }
  }
  const float bias = w[KS * KS];
#pragma unroll
  for (int rb = 0; rb < TH / RB; ++rb) {
    float a0[RB] = {0.f, 0.f, 0.f, 0.f}, a1[RB] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      // window column of image column x0 + 2 cp - 2
      const float* p = win + RB * rb * WIN_LD_F32 + WIN_X_F32 - R + 2 * cp;
#pragma unroll
      for (int i = 0; i < WIN_H; ++i) {
        const float2* q = reinterpret_cast<const float2*>(p + i * WIN_LD_F32);
        const float2 u0 = q[0], u1 = q[1], u2 = q[2];
        const float v[6] = {u0.x, u0.y, u1.x, u1.y, u2.x, u2.y};
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int a = i - r;          // tap row of window row i for row r
          if (a >= 0 && a < KS) {
#pragma unroll
            for (int bb = 0; bb < KS; ++bb) {
              a0[r] = fmaf(w[a * KS + bb], v[bb], a0[r]);
              a1[r] = fmaf(w[a * KS + bb], v[bb + 1], a1[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        a0[r] = fmaxf(a0[r] + bias, 0.f);
        a1[r] = fmaxf(a1[r] + bias, 0.f);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
      *reinterpret_cast<float2*>(h + (RB * rb + r) * TW + 2 * cp) =
          make_float2(a0[r], a1[r]);
  }
}

// acc (MT m64 tiles of pixels x NT * 8 output channels) += h^T w1^T for
// one chunk in 3xTF32: A from h [channel][pixel] (word loads at a pitch of
// 8 mod 32, no bank conflicts; split once), B the chunk's w1 parts. Warp w
// holds rows 16 w .. 16 w + 15 of each m64 tile. One commit group, waited
// for before the chunk's h is released.
template <int NT, int TH>
__device__ __forceinline__ void pointwise_f32(float (*acc)[NT * 4],
                                              const float* h,
                                              uint32_t w_hi) {
  using G = GeoF<TH>;
  constexpr int MT = G::MT, KSTEPS = CCH_F32 / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int w = (threadIdx.x / 32) % 4;
  const uint32_t w_lo = w_hi + w1_part<NT>() * 4;
  uint32_t ahi[KSTEPS][MT][4], alo[KSTEPS][MT][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* hp = h + (8 * kk + t) * G::H_LD + 64 * m + 16 * w + g;
      split_tf32(hp[0], ahi[kk][m][0], alo[kk][m][0]);
      split_tf32(hp[8], ahi[kk][m][1], alo[kk][m][1]);
      split_tf32(hp[4 * G::H_LD], ahi[kk][m][2], alo[kk][m][2]);
      split_tf32(hp[4 * G::H_LD + 8], ahi[kk][m][3], alo[kk][m][3]);
    }
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_operands<NT * 4>(acc[m]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint64_t bh = desc_plain(w_hi + kk * 2 * CORE, CORE, W1_SBO);
    const uint64_t bl = desc_plain(w_lo + kk * 2 * CORE, CORE, W1_SBO);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#ifndef F32_PROBE_NO_1X1
      wgmma_tf32<NT * 8>(acc[m], alo[kk][m], bh, 1);
      wgmma_tf32<NT * 8>(acc[m], ahi[kk][m], bl, 1);
      wgmma_tf32<NT * 8>(acc[m], ahi[kk][m], bh, 1);
#else   // f32_probe.py's ablation: the operands stay live, no products
      acc[m][0] += __uint_as_float(ahi[kk][m][0] ^ alo[kk][m][1]);
#endif
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_operands<NT * 4>(acc[m]);
}

// out = acc + b1 for 16 pixels (p0 .. p0 + 15 of the tile, one tile row),
// straight from the fragments: each store instruction writes 8
// consecutive pixels of 4 output channels, whole 32-byte sectors where
// W % 8 == 0. (Staging 16 channels through shared memory for 16-byte
// stores measured slower on the H100: the 1x1 warps stall on the bursts.)
// Resets acc.
template <int NT>
__device__ __forceinline__ void store_f32(float* acc, const float* b1_s,
                                          float* __restrict__ out, Tile tl,
                                          int p0, int C_out, int H, int W) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int y = tl.y0 + p0 / TW, xg = tl.x0 + p0 % TW + g;
  if (y < H) {
    const size_t plane = (size_t)H * W;
    float* ob = out + (size_t)tl.b * C_out * plane + (size_t)y * W;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = 8 * n + 2 * t + (e & 1), xx = xg + 8 * (e >> 1);
        if (co < C_out && xx < W)
          ob[(size_t)co * plane + xx] = acc[4 * n + e] + b1_s[co];
      }
  }
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) acc[i] = 0.f;
}

template <int NT, int TH>
__global__ void __launch_bounds__(THREADS_F32, 1)
refiner_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                   const float* __restrict__ x, const float* __restrict__ wdw,
                   const float* __restrict__ bdw,
                   const float* __restrict__ w1s, const float* __restrict__ b1,
                   float* __restrict__ out, int C, int C_out, int H, int W,
                   int tiles_x, int tiles_y, int n_tiles, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  using G = GeoF<TH>;
  using RG = RingsF<NT, TH>;
  constexpr int STAGES = RG::STAGES, HS = RG::HS;
  constexpr F32Layout L = RG::L;
  constexpr int W_BYTES = 2 * w1_part<NT>() * 4;
  float* b1_s = reinterpret_cast<float*>(smem);
  float* taps_s = reinterpret_cast<float*>(smem + L.taps);
  float* halo = reinterpret_cast<float*>(smem + L.halo);
  float* h_s = reinterpret_cast<float*>(smem + L.h);
  const uint32_t bars = smem_u32(smem + L.bars);
  auto halo_full = [&](int s) { return bars + 8u * s; };
  auto halo_empty = [&](int s) { return bars + 8u * (STAGES + s); };
  auto h_full = [&](int s) { return bars + 8u * (2 * STAGES + s); };
  auto w_full = [&](int s) { return bars + 8u * (2 * STAGES + HS + s); };
  auto h_empty = [&](int s) {
    return bars + 8u * (2 * STAGES + 2 * HS + s);
  };
  auto h_of = [&](int s) { return h_s + s * RG::H_STAGE; };
  const int tid = threadIdx.x;

  for (int i = tid; i < NT * 8; i += THREADS_F32)
    b1_s[i] = i < C_out ? b1[i] : 0.f;
  for (int i = tid; i < C * TAP_LD; i += THREADS_F32) {
    const int c = i / TAP_LD, k = i - c * TAP_LD;
    taps_s[i] = k < KS * KS ? wdw[c * KS * KS + k] : k == KS * KS ? bdw[c]
                                                                  : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(halo_full(s), 1);
      mbar_init(halo_empty(s), DW_F32 / 32);
    }
    for (int s = 0; s < HS; ++s) {
      mbar_init(h_full(s), DW_F32 / 32);        // one arrival per warp
      mbar_init(w_full(s), 1);
      mbar_init(h_empty(s), MMA_WARPS_F32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // chunk g of this block: tile blockIdx.x + (g / nck) gridDim.x,
  // channels (g % nck) * CCH_F32 ...
  const int nck = (C + CCH_F32 - 1) / CCH_F32;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1)
                       / (int)gridDim.x;
  const int total = my_tiles * nck;
  auto tile_of = [&](int g) {
    return tile_at<TH>(blockIdx.x + (g / nck) * gridDim.x, tiles_x,
                       tiles_y);
  };

  if (tid < DW_F32) {
    // ---- depthwise warps: loads, depthwise, h; thread 0 also issues the
    // halo boxes and each chunk's w1 parts ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n");
    const int ch = tid / 16;          // the half-warp's channel of a chunk
    auto issue = [&](int g) {
      if (g < total)
        load_window_f32<TH>(halo + (g % STAGES) * G::STAGE, &xmap,
                            halo_full(g % STAGES), x, tile_of(g),
                            (g % nck) * CCH_F32, C, H, W, vec != 0);
    };
    // every stage's first box (TMA), or all but the last (element loads,
    // whose last stage is filled in the first turn)
    for (int s = 0; s < STAGES - (vec ? 0 : 1); ++s) issue(s);
    for (int g = 0; g < total; ++g) {
      if (vec) {
        // thread 0 refills chunk g - 1's stage once every warp is done
        // with it; each warp waits only for its own chunk's box
        if (tid == 0 && g >= 1 && g + STAGES - 1 < total) {
          mbar_wait(halo_empty((g - 1) % STAGES), ((g - 1) / STAGES) & 1);
          issue(g + STAGES - 1);
        }
        mbar_wait(halo_full(g % STAGES), (g / STAGES) & 1);
      } else {
        // chunk g's elements were written before this barrier, and every
        // depthwise thread is done with chunk g - 1's stage
        asm volatile("bar.sync 1, %0;\n" ::"n"(DW_F32) : "memory");
        issue(g + STAGES - 1);
      }
      const int hs = g % HS;
      if (g >= HS) mbar_wait(h_empty(hs), ((g / HS) - 1) & 1);
      float* h = h_of(hs);
      if (tid == 0) {
        mbar_expect_tx(w_full(hs), W_BYTES);
        bulk_load(smem_u32(h + CCH_F32 * G::H_LD),
                  w1s + (size_t)(g % nck) * 2 * w1_part<NT>(), W_BYTES,
                  w_full(hs));
      }
      const int c = (g % nck) * CCH_F32 + ch;
#ifndef F32_PROBE_NO_DEPTHWISE
      const bool live = c < C;
#else   // f32_probe.py's ablation: every channel dead, no FMAs
      const bool live = false;
#endif
      depthwise_f32<TH>(halo + (g % STAGES) * G::STAGE + ch * G::WIN_CH,
                        taps_s + (live ? c : 0) * TAP_LD, live,
                        h + ch * G::H_LD);
      __syncwarp();                     // the warp's h writes, then lane 0
      if (tid % 32 == 0) {
        mbar_arrive(h_full(hs));
        if (vec) mbar_arrive(halo_empty(g % STAGES));
      }
    }
  } else {
    // ---- the 1x1 warpgroup: products, epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int w = (tid - DW_F32) / 32;
    float acc[G::MT][NT * 4];
#pragma unroll
    for (int m = 0; m < G::MT; ++m)
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) acc[m][i] = 0.f;
    for (int g = 0; g < total; ++g) {
      const int hs = g % HS;
      mbar_wait(h_full(hs), (g / HS) & 1);
      mbar_wait(w_full(hs), (g / HS) & 1);
      const float* h = h_of(hs);
      pointwise_f32<NT, TH>(acc, h, smem_u32(h + CCH_F32 * G::H_LD));
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(h_empty(hs));
      if (g % nck == nck - 1) {
        const Tile tl = tile_of(g);
#pragma unroll
        for (int m = 0; m < G::MT; ++m)
          store_f32<NT>(acc[m], b1_s, out, tl, 64 * m + 16 * w, C_out, H, W);
      }
    }
  }
}

template <int NT, int TH>
int launch_bf16(const void* x, const void* wdw, const void* bdw,
                const void* w1, const void* b1, void* out, int B, int C,
                int C_out, int H, int W, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long n_tiles = (long long)B * tiles_x * tiles_y;
  if (n_tiles > (1ll << 30)) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  const int vec = (W % 8 == 0) && ((uintptr_t)x % 16 == 0)
                  && ((uintptr_t)out % 16 == 0);
  const size_t smem = Rings<NT, TH>::layout(C).bytes;
  err = prepare(refiner_bf16_kernel<NT, TH>, smem);
  if (err != cudaSuccess) return (int)err;
  refiner_bf16_kernel<NT, TH><<<grid, THREADS, smem, st>>>(
      (const bf16*)x, (const bf16*)wdw, (const bf16*)bdw, (const bf16*)w1,
      (const bf16*)b1, (bf16*)out, C, C_out, H, W, tiles_x, tiles_y,
      (int)n_tiles, vec);
  return (int)cudaGetLastError();
}

template <int NT, int TH>
int launch_f32(const void* x, const void* wdw, const void* bdw,
               const void* w1, const void* b1, void* out, void* scratch,
               int B, int C, int C_out, int H, int W, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (scratch == nullptr || (uintptr_t)scratch % 16)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long n_tiles = (long long)B * tiles_x * tiles_y;
  if (n_tiles > (1ll << 30)) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  const int vec = (W % 4 == 0) && ((uintptr_t)x % 16 == 0);
  // x as a 4-D tensor (W, H, C, B) for TMA: one box is a chunk's window,
  // zero-filled outside the image and past C
  CUtensorMap xmap{};
  if (vec) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorInvalidValue;
    const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)C,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)W * 4,
                                   (cuuint64_t)H * W * 4,
                                   (cuuint64_t)C * H * W * 4};
    const cuuint32_t box[4] = {WIN_LD_F32, GeoF<TH>::WIN_H, CCH_F32, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
               const_cast<void*>(x), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const int nck = (C + CCH_F32 - 1) / CCH_F32;
  refiner_split_w1<NT><<<nck, 128, 0, st>>>((const float*)w1,
                                            (float*)scratch, C, C_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = RingsF<NT, TH>::L.bytes;
  err = prepare(refiner_f32_kernel<NT, TH>, smem);
  if (err != cudaSuccess) return (int)err;
  refiner_f32_kernel<NT, TH><<<grid, THREADS_F32, smem, st>>>(
      xmap, (const float*)x, (const float*)wdw, (const float*)bdw,
      (const float*)scratch, (const float*)b1, (float*)out, C, C_out, H, W,
      tiles_x, tiles_y, (int)n_tiles, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = bf16, 1 = float32.
// x (B, C, H, W), wdw (C, 25), bdw (C,), w1 (C_out, C), b1 (C_out,) and
// out (B, C_out, H, W) are contiguous and of one dtype; C, C_out <= 192;
// any H, W >= 1. float32 takes `scratch` of refiner_scratch_bytes(...)
// bytes, 16-byte aligned, for w1 split into TF32 parts; bf16 takes none.
// Returns cudaGetLastError() after the launches (0 = launched); shapes it
// does not take return cudaErrorInvalidValue without launching.

namespace {
// C_out in n-tiles of 8, rounded up to the instantiated widths
int nt_bucket(int C_out) {
  const int nt = (C_out + 7) / 8;
  return nt <= 3 ? 3 : nt <= 6 ? 6 : nt <= 12 ? 12 : nt <= 18 ? 18 : 24;
}
}  // namespace

extern "C" int refiner_max_channels() { return MAXC; }

extern "C" long long refiner_scratch_bytes(int dtype, int C, int C_out) {
  if (dtype == 0 || C < 1 || C_out < 1) return 0;
  const long long nck = (C + CCH_F32 - 1) / CCH_F32;
  return nck * 2 * nt_bucket(C_out) * 8 * CCH_F32 * 4;
}

extern "C" int refiner_block(int dtype, const void* x, const void* wdw,
                             const void* bdw, const void* w1, const void* b1,
                             void* out, void* scratch, int B, int C,
                             int C_out, int H, int W, void* stream) {
  if (C < 1 || C > MAXC || C_out < 1 || C_out > MAXC || B < 1 || B > 65535
      || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (nt_bucket(C_out) + 100 * dtype) {
    case 3:
      return launch_bf16<3, 8>(x, wdw, bdw, w1, b1, out, B, C, C_out, H, W, st);
    case 6:
      return launch_bf16<6, 8>(x, wdw, bdw, w1, b1, out, B, C, C_out, H, W, st);
    case 12:
      return launch_bf16<12, 4>(x, wdw, bdw, w1, b1, out, B, C, C_out, H, W, st);
    case 18:
      return launch_bf16<18, 4>(x, wdw, bdw, w1, b1, out, B, C, C_out, H, W, st);
    case 24:
      return launch_bf16<24, 4>(x, wdw, bdw, w1, b1, out, B, C, C_out, H, W, st);
    case 103:
      return launch_f32<3, 8>(x, wdw, bdw, w1, b1, out, scratch, B, C, C_out,
                              H, W, st);
    case 106:
      return launch_f32<6, 8>(x, wdw, bdw, w1, b1, out, scratch, B, C, C_out,
                              H, W, st);
    case 112:
      return launch_f32<12, 4>(x, wdw, bdw, w1, b1, out, scratch, B, C, C_out,
                               H, W, st);
    case 118:
      return launch_f32<18, 4>(x, wdw, bdw, w1, b1, out, scratch, B, C, C_out,
                               H, W, st);
    case 124:
      return launch_f32<24, 4>(x, wdw, bdw, w1, b1, out, scratch, B, C, C_out,
                               H, W, st);
  }
  return (int)cudaErrorInvalidValue;
}
