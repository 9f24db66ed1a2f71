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
// float32 inputs take a plain FMA kernel (tiles of 8 x 16, synchronous
// halo loads) in full float32, for checks on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int KS = 5;                 // depthwise kernel size
constexpr int R = KS / 2;
constexpr int CC = 16;                // channels per halo chunk (f32)
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Block until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

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
// float32: plain FMA, tiles of 8 x 16 pixels, synchronous halo loads
// ---------------------------------------------------------------------------

constexpr int TH32 = 8, TW32 = 16;
constexpr int P32 = TH32 * TW32;
constexpr int HH32 = TH32 + KS - 1, HW32 = TW32 + KS - 1;
constexpr int THREADS32 = 256;        // CC x TW32: one channel, one column

// h (round16(C) x P32) then one halo chunk (CC x HH32 x HW32), floats
__host__ __device__ inline size_t f32_smem(int C) {
  return ((size_t)round_up(C, CC) * P32 + (size_t)CC * HH32 * HW32)
         * sizeof(float);
}

__global__ void __launch_bounds__(THREADS32)
refiner_f32_kernel(const float* __restrict__ x, const float* __restrict__ wdw,
                   const float* __restrict__ bdw,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   float* __restrict__ out, int C, int C_out, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int kpad = round_up(C, CC);
  float* h_s = reinterpret_cast<float*>(smem_raw);
  float* halo = h_s + (size_t)kpad * P32;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW32, y0 = blockIdx.y * TH32, b = blockIdx.z;
  const float* xb = x + (size_t)b * C * H * W;
  const int cl = tid / TW32, tx = tid % TW32;
  for (int c0 = 0; c0 < kpad; c0 += CC) {
    __syncthreads();                   // previous chunk's readers are done
    for (int idx = tid; idx < CC * HH32 * HW32; idx += THREADS32) {
      const int ch = idx / (HH32 * HW32), rem = idx - ch * (HH32 * HW32);
      const int hr = rem / HW32, hc = rem - hr * HW32;
      const int c = c0 + ch, gy = y0 - R + hr, gx = x0 - R + hc;
      halo[idx] = (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
                      ? xb[((size_t)c * H + gy) * W + gx]
                      : 0.f;
    }
    __syncthreads();
    const int c = c0 + cl;
    float acc[TH32];
#pragma unroll
    for (int r = 0; r < TH32; ++r) acc[r] = 0.f;
    if (c < C) {
      float w[KS * KS];
#pragma unroll
      for (int i = 0; i < KS * KS; ++i) w[i] = wdw[c * KS * KS + i];
      const float* hp = halo + cl * HH32 * HW32 + tx;
#pragma unroll
      for (int hr = 0; hr < HH32; ++hr) {
        float v[KS];
#pragma unroll
        for (int bb = 0; bb < KS; ++bb) v[bb] = hp[hr * HW32 + bb];
#pragma unroll
        for (int r = 0; r < TH32; ++r) {
          const int a = hr - r;        // tap row of this halo row for row r
          if (a >= 0 && a < KS) {
#pragma unroll
            for (int bb = 0; bb < KS; ++bb)
              acc[r] = fmaf(w[a * KS + bb], v[bb], acc[r]);
          }
        }
      }
      const float bias = bdw[c];
#pragma unroll
      for (int r = 0; r < TH32; ++r) acc[r] = fmaxf(acc[r] + bias, 0.f);
    }
#pragma unroll
    for (int r = 0; r < TH32; ++r) h_s[c * P32 + r * TW32 + tx] = acc[r];
  }
  __syncthreads();

  // out[co][p] = b1[co] + sum_c w1[co][c] h[c][p]: a thread owns pixel p
  // and every other output channel; w1 reads are warp-uniform (broadcast)
  const int p = tid % P32;
  const int gy = y0 + p / TW32, gx = x0 + p % TW32;
  if (gy >= H || gx >= W) return;
  for (int co = tid / P32; co < C_out; co += THREADS32 / P32) {
    const float* wr = w1 + (size_t)co * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = fmaf(__ldg(wr + c), h_s[c * P32 + p], acc);
    out[(((size_t)b * C_out + co) * H + gy) * W + gx] = acc + b1[co];
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
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

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = bf16, 1 = float32.
// x (B, C, H, W), wdw (C, 25), bdw (C,), w1 (C_out, C), b1 (C_out,) and
// out (B, C_out, H, W) are contiguous and of one dtype; C, C_out <= 192;
// any H, W >= 1. Returns cudaGetLastError() after the launch (0 =
// launched); shapes it does not take return cudaErrorInvalidValue without
// launching.

extern "C" int refiner_max_channels() { return MAXC; }

extern "C" int refiner_block(int dtype, const void* x, const void* wdw,
                             const void* bdw, const void* w1, const void* b1,
                             void* out, int B, int C, int C_out, int H, int W,
                             void* stream) {
  if (C < 1 || C > MAXC || C_out < 1 || C_out > MAXC || B < 1 || B > 65535
      || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    // C_out in n-tiles of 8, rounded up to the instantiated widths
    const int nt = (C_out + 7) / 8;
    if (nt <= 3)
      return launch_bf16<3, 8>(x, wdw, bdw, w1, b1, out, B, C, C_out, H, W, st);
    if (nt <= 6)
      return launch_bf16<6, 8>(x, wdw, bdw, w1, b1, out, B, C, C_out, H, W, st);
    if (nt <= 12)
      return launch_bf16<12, 4>(x, wdw, bdw, w1, b1, out, B, C, C_out, H, W, st);
    if (nt <= 18)
      return launch_bf16<18, 4>(x, wdw, bdw, w1, b1, out, B, C, C_out, H, W, st);
    return launch_bf16<24, 4>(x, wdw, bdw, w1, b1, out, B, C, C_out, H, W, st);
  }
  const dim3 grid((W + TW32 - 1) / TW32, (H + TH32 - 1) / TH32, B);
  const size_t smem = f32_smem(C);
  cudaError_t err = prepare(refiner_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  refiner_f32_kernel<<<grid, THREADS32, smem, st>>>(
      (const float*)x, (const float*)wdw, (const float*)bdw,
      (const float*)w1, (const float*)b1, (float*)out, C, C_out, H, W);
  return (int)cudaGetLastError();
}
