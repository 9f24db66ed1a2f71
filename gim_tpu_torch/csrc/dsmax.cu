// K1: fused dual-softmax mutual matching for Hopper (sm_90a).
//
// Replaces the TPU kernel pair in gim_tpu/ops/pallas_kernels/dsmax.py:
// `_stats_kernel` (sweep 1) and `_argmax_kernel` (sweep 2). For features
// f0 (L, C) and f1 (S, C) of one pair, sim = f0 f1^T * inv_t and
//   conf = softmax_rows(sim) * softmax_cols(sim).
// The L x S matrix is never written to device memory:
//   sweep 1 (dsmax_stats): masked row max and row sum-exp, plus per-row-
//     block column max / sum-exp partials (B, ceil(L / block), S);
//   sweep 2 (dsmax_argmax): the log-domain argmax on both sides,
//     log conf_ij = 2 sim_ij - rowterm_i - colterm_j. Rows: argmax_j of
//     2 sim - colterm_j; columns: argmax_i of 2 sim - rowterm_i as per-
//     row-block partials.
// The partials are reduced by the caller (gim_tpu_torch/ops/kernels/
// dsmax.py), as the JAX package reduces them outside its kernel. Blocks
// run in no order and nothing is carried between them, so results do not
// depend on run order.
//
// Semantics kept from the TPU kernel: masked entries and the rows of f0
// past L are NEG = -1e30 before max and exp (the plain version pads its
// row blocks with NEG); columns past S take no part; ties go to the
// lowest index inside a thread, across tiles and across threads.
//
// What bounds it. Each sweep is 2 L S C FLOP of product per pair (at
// L = S = 10816, C = 256, batch 8: 4.8e11 FLOP, 0.485 ms at the H100's
// 989 TFLOP/s dense bf16) against 89 MB of inputs; the stats sweep also
// takes two exp2s per score (1.9e9, 0.48 ms at 16 a clock per SM). The
// bf16 kernel is one pipeline with two epilogues:
//   - a block keeps 128 rows of f0 in shared memory (TMA, 128-byte
//     swizzle, C in 64-column panels, rows past L and columns past C
//     zero-filled) as wgmma's B operand (N = 128, K-major);
//   - one producer warp streams f1 in tiles of 64 rows through a TMA ring
//     of mbarrier-tracked stages (5 at C = 256);
//   - two consumer warpgroups take the tiles in turn (named barriers, as
//     K3), each as the A operand of wgmma.m64n128k16: the accumulator is
//     a 64 x 128 tile of sim^T, its rows sim columns, its columns sim
//     rows. So both reductions run on registers: a column's partial over
//     the block's 128 rows is a depth-5 tree over 32 values per thread
//     plus two quad shuffles, once per tile; each thread keeps an online
//     state (max and sum, or best value and index) for its 32 sim rows
//     across the whole loop, merged across lanes, warps and warpgroups
//     once, at the end. No sim tile goes through shared memory, and the
//     loop has no __syncthreads;
//   - a group passes the turn once its product is done, so the products
//     run one after the other and each group's epilogue runs beside the
//     other's product; the row side's mask and terms are loaded before
//     the product, without a branch, so their latency hides behind it;
//   - scores are scaled and masked in one FFMA per side (the stats sweep
//     in the log2 domain, inv_t log2 e, converted back on output); the
//     stats' row sums are kept against a reference that moves only when
//     a row's max passes it by TAU, so rescales (and their exp2s) are
//     rare.
// The epilogue, not the product, sets the pace: it is longer than the
// product it runs beside (PERF.md, PR 4).
// float32 inputs take a plain FMA kernel in full float32 (no TF32, 64-row
// blocks, sim tiles in shared memory), for checks on the card.

#include <cmath>

#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// stats: how far (log2 units) a row's max may pass its reference before
// the sum is rescaled
constexpr float TAU = 64.f;

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, one producer warp and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int BM = 128;           // f0 rows per block (wgmma N)
constexpr int TN = 64;            // f1 rows per tile (wgmma M)
constexpr int CONSUMERS = 2;      // warpgroups, taking tiles in turn
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int ROW = 128;          // bytes per swizzled row: 64 bf16 columns
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100

// Shared memory, offsets from a 1024-byte aligned base: the f0 block and
// each f1 tile are P panels (64 columns, 128-byte rows, 128-byte swizzle:
// what TMA writes and wgmma reads with layout type 1); then the barriers
// and the column-side terms of the block's rows. The row states' final
// merge reuses the ring.
template <int P>
struct Layout {
  static constexpr int F0 = 0;
  static constexpr int RING = F0 + P * BM * ROW;
  static constexpr int TILE = P * TN * ROW;
  static constexpr int TAIL = 256 + BM * 4;
  static constexpr int FIT = (SMEM_MAX - 1024 - TAIL - RING) / TILE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int BAR = RING + STAGES * TILE;
  static constexpr int COLB = BAR + 256;
  static constexpr int BYTES = COLB + BM * 4 + 1024;
  static_assert(STAGES >= 2 && BYTES <= SMEM_MAX, "shared memory");
  static_assert(STAGES * TILE >= 8 * BM * 8, "merge buffer");
};

// What the epilogues read and write. Stats: out_v / out_w = row max / row
// sum-exp (B, L), part_v / part_w = column max / sum-exp partials (B,
// n_blocks, S). Argmax: out_i / out_v = row argmax and its value, part_i /
// part_v = column argmax partials and their values.
struct Args {
  const float* m0;
  const float* m1;
  const float* rowterm;
  const float* colterm;
  float scale;      // stats: inv_t log2 e; argmax: 2 inv_t
  int L, S, n_blocks;
  float* out_v;
  float* out_w;
  int* out_i;
  float* part_v;
  float* part_w;
  int* part_i;
};

// Stats in the log2 domain back to the plain version's units; masked
// maxima stay exactly NEG.
__device__ __forceinline__ float to_natural(float x) {
  return x <= 0.5f * NEG ? NEG : x * LN2;
}

// acc (64 x 128) = f1 tile (64 x C) . f0 block (128 x C)^T, 4 P k-steps of
// 16 columns (32 bytes inside a 128-byte swizzle row), panels apart.
template <int P>
__device__ __forceinline__ void product(float* acc, uint32_t tile,
                                        uint64_t db) {
  const uint64_t da = desc_sw128(tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4 * P; ++kk) {   // offsets in 16-byte units
    const uint32_t aoff = ((kk / 4) * TN * ROW + (kk % 4) * 32) >> 4;
    const uint32_t boff = ((kk / 4) * BM * ROW + (kk % 4) * 32) >> 4;
    wgmma_ss_m64n128(acc, da + aoff, db + boff, kk > 0);
  }
}

// Register c (0..31) of a thread's row state is accumulator column
// 8 (c / 2) + 2 t + (c % 2), i.e. registers k(c, h) = 4 (c / 2) + 2 h +
// c % 2 for its two accumulator rows h.
__device__ __forceinline__ int acc_col(int c, int t) {
  return 8 * (c >> 1) + 2 * t + (c & 1);
}

// Built with -DDSMAX_TIMELINE, block (0, 0) records the SM clock at four
// points of each of its first 256 tiles (loop top, product issued,
// product done, epilogue done), read back by dsmax_timeline(); the probe
// (ops/kernels/dsmax_probe.py) prints it. Off by default.
#ifdef DSMAX_TIMELINE
__device__ unsigned long long g_timeline[CONSUMERS][128][4];
#define TIMELINE(k)                                                       \
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x % 128 == 0 &&    \
      t / CONSUMERS < 128) {                                              \
    unsigned long long clk;                                               \
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(clk)::"memory");         \
    g_timeline[wg][t / CONSUMERS][k] = clk;                               \
  }
#else
#define TIMELINE(k)
#endif

template <int P, bool ARGMAX>
__global__ void __launch_bounds__(THREADS, 1)
dsmax_bf16_kernel(const __grid_constant__ CUtensorMap map0,
                  const __grid_constant__ CUtensorMap map1, const Args a) {
  using Ly = Layout<P>;
  constexpr int STAGES = Ly::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t s0 = base + Ly::F0, ring = base + Ly::RING;
  const uint32_t f0_full = base + Ly::BAR;
  auto full = [&](int s) { return f0_full + 8u * (1 + s); };
  auto empty = [&](int s) { return f0_full + 8u * (1 + STAGES + s); };
  float* colb = reinterpret_cast<float*>(smem + Ly::COLB);

  const int blk = blockIdx.x, b = blockIdx.y;
  const int i0 = blk * BM;
  const int L = a.L, S = a.S;
  const int n_tiles = (S + TN - 1) / TN;
  // warp-uniform to the compiler, so that descriptors live in uniform
  // registers and successive wgmmas need not wait for each other
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(f0_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);          // lane 0 of each consuming warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // column side: a masked row or a row past L is NEG (as the plain
  // version's padded row blocks); stats add 0, argmax -rowterm_i
  if (threadIdx.x < BM) {
    const int i = i0 + threadIdx.x;
    const bool valid = i < L && a.m0[(size_t)b * L + i] > 0.f;
    colb[threadIdx.x] = !valid ? NEG
                        : ARGMAX ? -a.rowterm[(size_t)b * L + i] : 0.f;
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(f0_full, P * BM * ROW);
#pragma unroll
      for (int p = 0; p < P; ++p)
        tma_load_3d(s0 + p * BM * ROW, &map0, f0_full, 64 * p, i0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty(s), ((t / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), P * TN * ROW);
#pragma unroll
        for (int p = 0; p < P; ++p)
          tma_load_3d(ring + s * Ly::TILE + p * TN * ROW, &map1, full(s),
                      64 * p, t * TN, b);
      }
    }
    return;
  }

  // ---- consumers: tile t goes to warpgroup t % 2 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rloc = warp * 16 + g;      // tile row of accumulator row h = 0
  const uint64_t db = desc_sw128(s0, 16, 1024);
  const float sc = a.scale;
  const float* m1b = a.m1 + (size_t)b * S;
  const float* colt = ARGMAX ? a.colterm + (size_t)b * S : nullptr;

  // column-side terms of my 32 rows: registers for argmax; the stats
  // sweep, which holds a third row state, reads them from shared memory
  float cb[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) cb[c] = ARGMAX ? colb[acc_col(c, t4)] : 0.f;
  // row state of my 32 sim rows. Argmax: best value and its column
  // (rv, ri). Stats, in the log2 domain, with v' = v - TAU: the reference
  // r (rv), the sum of 2^(v' - r) over the columns so far (rw) and the
  // largest v' so far (top). r moves only when some v' passes it, i.e.
  // when a row's max grows by more than TAU past the last reference, so
  // every term stays <= 1 and the exp2s of a rescale are rare.
  float rv[32];
  float rw[32];
  float top[32];
  int ri[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    rv[c] = NEG;
    rw[c] = 0.f;
    top[c] = NEG;
    ri[c] = 0;
  }
  float acc[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) acc[k] = 0.f;

  scheduler_open(wg);
  mbar_wait(f0_full, 0);
  for (int t = wg; t < n_tiles; t += CONSUMERS) {
    const int s = t % STAGES;
    const int j0 = t * TN + rloc;      // sim columns of rows h = 0, 1
    // the row side's mask and term of my two tile rows, loaded without a
    // branch before the product, so that their latency hides behind it
    float mk[2], ct[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = min(j0 + 8 * h, S - 1);
      mk[h] = __ldg(m1b + j);
      ct[h] = ARGMAX ? __ldg(colt + j) : 0.f;
    }
    TIMELINE(0);
    mbar_wait(full(s), (t / STAGES) & 1);
    scheduler_wait(wg);
    TIMELINE(1);
    fence_operands<64>(acc);
    wgmma_fence();
    product<P>(acc, ring + s * Ly::TILE, db);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands<64>(acc);
    scheduler_pass(wg, t == n_tiles - 1);   // the other group's turn
    TIMELINE(2);
    if (lane == 0) mbar_arrive(empty(s));

    // row side: columns past S take no part (-inf); masked ones are NEG
    float rb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rb[h] = j0 + 8 * h >= S ? -INFINITY
              : mk[h] <= 0.f  ? NEG
              : ARGMAX        ? -ct[h]
                              : -TAU;
    if (ARGMAX) {
#pragma unroll
      for (int c = 0; c < 32; ++c) {   // rows rise with h: strict > keeps
        const int k0 = 4 * (c >> 1) + (c & 1);   // the first column
        const float v0 = fmaf(acc[k0], sc, rb[0]);
        const float v1 = fmaf(acc[k0 + 2], sc, rb[1]);
        ri[c] = v0 > rv[c] ? j0 : ri[c];
        rv[c] = fmaxf(rv[c], v0);
        ri[c] = v1 > rv[c] ? j0 + 8 : ri[c];
        rv[c] = fmaxf(rv[c], v1);
      }
    } else {
      // pass 1: the largest v' of each row, and whether one passed r
      bool grow = false;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int k0 = 4 * (c >> 1) + (c & 1);
        const float m = fmaxf(fmaf(acc[k0], sc, rb[0]),
                              fmaf(acc[k0 + 2], sc, rb[1]));
        top[c] = fmaxf(top[c], m);
        grow |= m > rv[c];
      }
      if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          if (top[c] > rv[c]) {
            const float r = top[c] + TAU;
            rw[c] *= fast_exp2(rv[c] - r);
            rv[c] = r;
          }
        }
      }
      // pass 2: the terms 2^(v' - r), each <= 1 (ptxas keeps pass 1's
      // scores in registers across the branch)
      fence_operands<64>(acc);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int k0 = 4 * (c >> 1) + (c & 1);
        rw[c] += fast_exp2(fmaf(acc[k0], sc, rb[0]) - rv[c])
                 + fast_exp2(fmaf(acc[k0 + 2], sc, rb[1]) - rv[c]);
      }
    }
    // column side: each accumulator row over the block's 128 rows (32
    // registers here, the rest in the other three lanes of the quad), as
    // a tree of depth 5 over contiguous ranges of c (and so of rows), so
    // that a strict > keeps the first row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[32];
#pragma unroll
      for (int q = 0; q < 16; ++q) {   // c = 2 q, 2 q + 1: adjacent rows
        const float2 bq = ARGMAX ? make_float2(cb[2 * q], cb[2 * q + 1])
            : *reinterpret_cast<const float2*>(colb + 8 * q + 2 * t4);
        x[2 * q] = fmaf(acc[4 * q + 2 * h], sc, bq.x);
        x[2 * q + 1] = fmaf(acc[4 * q + 2 * h + 1], sc, bq.y);
      }
      float best, sum = 0.f;
      int bi = 0;
      float y[16];
      int yi[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const bool r = x[2 * c + 1] > x[2 * c];
        y[c] = fmaxf(x[2 * c], x[2 * c + 1]);
        yi[c] = r ? 2 * c + 1 : 2 * c;
      }
      // y[a] takes y[z], z > a, only if strictly larger (levels written
      // out, so that every index is known at compile time)
      auto pick = [&](int a, int z) {
        if (ARGMAX) yi[a] = y[z] > y[a] ? yi[z] : yi[a];
        y[a] = fmaxf(y[a], y[z]);
      };
#pragma unroll
      for (int c = 0; c < 8; ++c) pick(2 * c, 2 * c + 1);
#pragma unroll
      for (int c = 0; c < 4; ++c) pick(4 * c, 4 * c + 2);
#pragma unroll
      for (int c = 0; c < 2; ++c) pick(8 * c, 8 * c + 4);
      pick(0, 8);
      best = y[0];
      bi = acc_col(yi[0], t4);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        if (ARGMAX) {
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (ob > best || (ob == best && oi < bi)) {
            best = ob;
            bi = oi;
          }
        } else {
          best = fmaxf(best, ob);
        }
      }
      if (!ARGMAX) {
        float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 32; ++c) s4[c & 3] += fast_exp2(x[c] - best);
        sum = (s4[0] + s4[1]) + (s4[2] + s4[3]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      }
      const int j = j0 + 8 * h;
      if (t4 == h && j < S) {
        const size_t o = ((size_t)b * a.n_blocks + blk) * S + j;
        if (ARGMAX) {
          a.part_v[o] = best;
          a.part_i[o] = i0 + bi;
        } else {
          a.part_v[o] = to_natural(best);
          a.part_w[o] = sum;
        }
      }
    }
    TIMELINE(3);
  }

  // stats: to the row's max, top + TAU, and the sum relative to it
  if (!ARGMAX) {
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      rw[c] *= fast_exp2(rv[c] - top[c]);
      rv[c] = top[c] + TAU;
    }
  }
  // merge the row states: the 8 lanes of a column in a warp, then the 4
  // warps of both warpgroups through shared memory (the ring, once every
  // product is done)
#pragma unroll
  for (int c = 0; c < 32; ++c) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, rv[c], off);
      if (ARGMAX) {
        const int oi = __shfl_xor_sync(0xffffffffu, ri[c], off);
        if (ov > rv[c] || (ov == rv[c] && oi < ri[c])) {
          rv[c] = ov;
          ri[c] = oi;
        }
      } else {
        const float ow = __shfl_xor_sync(0xffffffffu, rw[c], off);
        const float m = fmaxf(rv[c], ov);
        rw[c] = rw[c] * fast_exp2(rv[c] - m) + ow * fast_exp2(ov - m);
        rv[c] = m;
      }
    }
  }
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
  float* mv = reinterpret_cast<float*>(smem + Ly::RING);   // [8][BM]
  float* mw = mv + 8 * BM;                                 // [8][BM]
  int* mi = reinterpret_cast<int*>(mw);
  const int slot = wg * 4 + warp;
  if (g == 0) {
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = acc_col(c, t4);
      mv[slot * BM + col] = rv[c];
      if (ARGMAX)
        mi[slot * BM + col] = ri[c];
      else
        mw[slot * BM + col] = rw[c];
    }
  }
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
  if (wg == 0 && i0 + tid < L) {
    float v = mv[tid], w = ARGMAX ? 0.f : mw[tid];
    int ix = ARGMAX ? mi[tid] : 0;
    for (int q = 1; q < 8; ++q) {
      const float ov = mv[q * BM + tid];
      if (ARGMAX) {
        const int oi = mi[q * BM + tid];
        if (ov > v || (ov == v && oi < ix)) {
          v = ov;
          ix = oi;
        }
      } else {
        const float m = fmaxf(v, ov);
        w = w * fast_exp2(v - m) + mw[q * BM + tid] * fast_exp2(ov - m);
        v = m;
      }
    }
    const size_t o = (size_t)b * L + i0 + tid;
    if (ARGMAX) {
      a.out_v[o] = v;
      a.out_i[o] = ix;
    } else {
      a.out_v[o] = to_natural(v);
      a.out_w[o] = w;
    }
  }
}

// A rank-3 bf16 tensor map over a contiguous (B, rows, C) tensor: box of
// 64 columns x `box_rows` rows of one pair, 128-byte swizzle; rows past
// `rows` and columns past C read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int rows, int C,
              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)rows, (cuuint64_t)B};
  cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)rows * C * 2};
  cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int P, bool ARGMAX>
int launch_bf16(const void* f0, const void* f1, int B, int C, const Args& a,
                cudaStream_t stream) {
  CUtensorMap map0, map1;
  if (!make_map(&map0, f0, B, a.L, C, BM) || !make_map(&map1, f1, B, a.S, C, TN))
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<P>::BYTES;
  cudaError_t err = prepare(dsmax_bf16_kernel<P, ARGMAX>, smem);
  if (err != cudaSuccess) return (int)err;
  dsmax_bf16_kernel<P, ARGMAX><<<dim3(a.n_blocks, B), THREADS, smem, stream>>>(
      map0, map1, a);
  return (int)cudaGetLastError();
}

template <bool ARGMAX>
int dispatch_bf16(const void* f0, const void* f1, int B, int C, const Args& a,
                  cudaStream_t stream) {
  switch ((C + 63) / 64) {
    case 1: return launch_bf16<1, ARGMAX>(f0, f1, B, C, a, stream);
    case 2: return launch_bf16<2, ARGMAX>(f0, f1, B, C, a, stream);
    case 3: return launch_bf16<3, ARGMAX>(f0, f1, B, C, a, stream);
    default: return launch_bf16<4, ARGMAX>(f0, f1, B, C, a, stream);
  }
}

// ---------------------------------------------------------------------------
// float32: plain FMA, 64-row blocks, sim tiles staged in shared memory
// ---------------------------------------------------------------------------

constexpr int BM_F32 = 64;        // rows of f0 per block
constexpr int BN_F32 = 64;        // rows of f1 per column tile
constexpr int THREADS_F32 = 256;  // 8 warps
constexpr int SIM_LD = BN_F32 + 4;  // float row stride of the sim tile

// Copy rows [row0, row0 + 64) of a (n_rows, C) matrix into shared memory
// (row stride ld, odd, so the product's column reads hit 32 banks),
// zero-filling rows at or past n_rows.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int row0, int n_rows, int C) {
  for (int idx = threadIdx.x; idx < 64 * C; idx += THREADS_F32) {
    const int r = idx / C, c = idx - r * C;
    dst[r * ld + c] = (row0 + r < n_rows) ? src[(size_t)(row0 + r) * C + c]
                                          : 0.f;
  }
}

// sim[r][c] = sum_k a[r][k] * b[c][k] for the 64 x 64 tile (unscaled).
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

size_t smem_bytes_f32(int C) {
  return (size_t)(BM_F32 + BN_F32) * (C + 1) * sizeof(float)
         + (size_t)BM_F32 * SIM_LD * sizeof(float);
}

// Thread roles in the reductions over a 64 x 64 sim tile:
//   row side:    row rr = tid / 4 owns columns rq + 4k (k < 16);
//   column side: column cc = tid % 64 owns rows cq + 4k (k < 16).
// Both patterns read 32 distinct banks per warp.

__global__ void __launch_bounds__(THREADS_F32)
dsmax_stats_f32(const float* __restrict__ f0, const float* __restrict__ f1,
                const float* __restrict__ m0, const float* __restrict__ m1,
                float inv_t, int L, int S, int C, int n_row_tiles,
                float* __restrict__ rmax, float* __restrict__ rsum,
                float* __restrict__ cpmax, float* __restrict__ cpsum) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float sm0[BM_F32], sm1[BN_F32];
  __shared__ float red_m[4][BN_F32], red_s[4][BN_F32];

  const int ld = C + 1;
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sb = sa + BM_F32 * ld;
  float* sim = sb + BN_F32 * ld;

  const int tid = threadIdx.x;
  const int ti = blockIdx.x, b = blockIdx.y;
  const int i0 = ti * BM_F32;
  const float* f0b = f0 + (size_t)b * L * C;
  const float* f1b = f1 + (size_t)b * S * C;
  const float* m0b = m0 + (size_t)b * L;
  const float* m1b = m1 + (size_t)b * S;

  const int rr = tid >> 2, rq = tid & 3;
  const int cc = tid & 63, cq = tid >> 6;

  load_tile(sa, ld, f0b, i0, L, C);
  if (tid < BM_F32) sm0[tid] = (i0 + tid < L) ? m0b[i0 + tid] : 0.f;

  float run_m = NEG, run_s = 0.f;     // online row stats, this thread's part
  for (int j0 = 0; j0 < S; j0 += BN_F32) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(sb, ld, f1b, j0, S, C);
    if (tid < BN_F32) sm1[tid] = (j0 + tid < S) ? m1b[j0 + tid] : 0.f;
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
    if (tid < BN_F32 && j0 + tid < S) {
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

__global__ void __launch_bounds__(THREADS_F32)
dsmax_argmax_f32(const float* __restrict__ f0, const float* __restrict__ f1,
                 const float* __restrict__ m0, const float* __restrict__ m1,
                 const float* __restrict__ colterm,
                 const float* __restrict__ rowterm,
                 float inv_t, int L, int S, int C, int n_row_tiles,
                 int* __restrict__ jbest, float* __restrict__ jval,
                 int* __restrict__ ipidx, float* __restrict__ ipval) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float sm0[BM_F32], srow[BM_F32], sm1[BN_F32], scol[BN_F32];
  __shared__ float red_v[4][BN_F32];
  __shared__ int red_i[4][BN_F32];

  const int ld = C + 1;
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sb = sa + BM_F32 * ld;
  float* sim = sb + BN_F32 * ld;

  const int tid = threadIdx.x;
  const int ti = blockIdx.x, b = blockIdx.y;
  const int i0 = ti * BM_F32;
  const float* f0b = f0 + (size_t)b * L * C;
  const float* f1b = f1 + (size_t)b * S * C;
  const float* m0b = m0 + (size_t)b * L;
  const float* m1b = m1 + (size_t)b * S;
  const float* colb = colterm + (size_t)b * S;
  const float* rowb = rowterm + (size_t)b * L;

  const int rr = tid >> 2, rq = tid & 3;
  const int cc = tid & 63, cq = tid >> 6;

  load_tile(sa, ld, f0b, i0, L, C);
  if (tid < BM_F32) {
    const bool in = i0 + tid < L;
    sm0[tid] = in ? m0b[i0 + tid] : 0.f;
    srow[tid] = in ? rowb[i0 + tid] : 0.f;
  }

  float best_v = NEG;   // row side, this thread's columns
  int best_j = 0;
  for (int j0 = 0; j0 < S; j0 += BN_F32) {
    __syncthreads();
    load_tile(sb, ld, f1b, j0, S, C);
    if (tid < BN_F32) {
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
    if (tid < BN_F32 && j0 + tid < S) {
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

int block_rows(int dtype) { return dtype == 0 ? BM : BM_F32; }

bool bad_shape(int dtype, int B, int L, int S, int C) {
  return dtype < 0 || dtype > 1 || B < 1 || B > 65535 || L < 1 || S < 1
         || C < 8 || C > 256 || C % 8 != 0;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = bf16, 1 = float32.
// Every array is contiguous: f0 (B, L, C), f1 (B, S, C), m0 (B, L),
// m1 (B, S) float32 (> 0 = valid); C a multiple of 8 up to 256. bf16
// features are read by TMA: their bases must be 16-byte aligned (the
// wrapper checks). Column partials are (B, ceil(L / dsmax_block_rows(
// dtype)), S). Returns cudaGetLastError() after the launch (0 =
// launched); what it does not take returns cudaErrorInvalidValue without
// launching.

extern "C" int dsmax_block_rows(int dtype) { return block_rows(dtype); }
#ifdef DSMAX_TIMELINE
extern "C" int dsmax_timeline(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_timeline, sizeof(g_timeline));
}
#endif

extern "C" int dsmax_stats(int dtype, const void* f0, const void* f1,
                           const void* m0, const void* m1, float inv_t,
                           int B, int L, int S, int C, void* rmax, void* rsum,
                           void* cpmax, void* cpsum, void* stream) {
  if (bad_shape(dtype, B, L, S, C)) return (int)cudaErrorInvalidValue;
  const int n_blocks = (L + block_rows(dtype) - 1) / block_rows(dtype);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args a{(const float*)m0, (const float*)m1, nullptr, nullptr,
           inv_t * LOG2E, L, S, n_blocks, (float*)rmax, (float*)rsum,
           nullptr, (float*)cpmax, (float*)cpsum, nullptr};
    return dispatch_bf16<false>(f0, f1, B, C, a, st);
  }
  const size_t smem = smem_bytes_f32(C);
  cudaError_t err = prepare(dsmax_stats_f32, smem);
  if (err != cudaSuccess) return (int)err;
  dsmax_stats_f32<<<dim3(n_blocks, B), THREADS_F32, smem, st>>>(
      (const float*)f0, (const float*)f1, (const float*)m0, (const float*)m1,
      inv_t, L, S, C, n_blocks, (float*)rmax, (float*)rsum, (float*)cpmax,
      (float*)cpsum);
  return (int)cudaGetLastError();
}

extern "C" int dsmax_argmax(int dtype, const void* f0, const void* f1,
                            const void* m0, const void* m1,
                            const void* colterm, const void* rowterm,
                            float inv_t, int B, int L, int S, int C,
                            void* jbest, void* jval, void* ipidx, void* ipval,
                            void* stream) {
  if (bad_shape(dtype, B, L, S, C)) return (int)cudaErrorInvalidValue;
  const int n_blocks = (L + block_rows(dtype) - 1) / block_rows(dtype);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args a{(const float*)m0, (const float*)m1, (const float*)rowterm,
           (const float*)colterm, 2.f * inv_t, L, S, n_blocks, (float*)jval,
           nullptr, (int*)jbest, (float*)ipval, nullptr, (int*)ipidx};
    return dispatch_bf16<true>(f0, f1, B, C, a, st);
  }
  const size_t smem = smem_bytes_f32(C);
  cudaError_t err = prepare(dsmax_argmax_f32, smem);
  if (err != cudaSuccess) return (int)err;
  dsmax_argmax_f32<<<dim3(n_blocks, B), THREADS_F32, smem, st>>>(
      (const float*)f0, (const float*)f1, (const float*)m0, (const float*)m1,
      (const float*)colterm, (const float*)rowterm, inv_t, L, S, C, n_blocks,
      (int*)jbest, (float*)jval, (int*)ipidx, (float*)ipval);
  return (int)cudaGetLastError();
}
