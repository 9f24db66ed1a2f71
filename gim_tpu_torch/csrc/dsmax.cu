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
// The float32 kernel also leaves its row outputs as partials over chunks of
// S. The partials are reduced by the caller (gim_tpu_torch/ops/kernels/
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
// float32 inputs (ZEB's path) take a SIMT kernel of their own in full
// float32, on the FMA pipes, with S cut into chunks (below).

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
// float32: register-tiled SIMT product on the FMA pipes (no TF32)
// ---------------------------------------------------------------------------
//
// What bounds it: 2 L S C FLOP of FP32 FMA per pair (ZEB's L = S = 11025,
// C = 256: 62.2 GFLOP, 0.930 ms at the H100's 66.9 TFLOP/s outside the
// tensor cores); the stats sweep's two exp2s per score (0.06 ms of MUFU)
// and the 22 MB of features do not set the pace. The path stays full
// float32 (callers turn TF32 off on purpose), so the product runs on the
// FMA pipes, and the design is about feeding them:
//   - a block owns 128 rows of f0 and one chunk of S. Its f0 rows stay in
//     shared memory for the whole chunk, staged transposed (k-major,
//     [k][row], 132 floats a k); f1 streams through a 4-stage ring of
//     128-row x 32-k slices as it lies in memory (K-contiguous, 36 floats
//     a row): 16-byte cp.async copies (zero fill past the chunk's end and
//     past C) that every thread issues and tracks on the stage's "full"
//     mbarrier (cp.async.mbarrier.arrive.noinc), slice s + 3 issued while
//     slice s is multiplied. Each warp releases a stage on its "empty"
//     mbarrier when its product is done, so the loop has no block-wide
//     barrier (with one __syncthreads per slice, waiting at the barrier
//     took 12 % of a tile: PERF.md);
//   - a thread owns 8 x 8 scores: rows wm 32 + 4 lm + {0..3, 16..19} of
//     the block, columns wn 64 + ln + 8 q of the tile (warp = wn 4 + wm,
//     lane = 8 lm + ln). Per 4 k it reads its 8 columns as float4 along K
//     (8 LDS.128, 32 registers) and, per k, its 8 rows as two float4 of
//     the k-major f0 (2 LDS.128, 8 registers): 16 LDS.128 for 256 FFMA,
//     0.25 shared words per FMA. The lanes that share ln (or lm) read one
//     address; f1's stride of 36 floats (1 mod 8 in 16-byte units) puts the
//     8 rows an instruction reads in 8 bank groups, and f0's 4 float4 are
//     contiguous, so each LDS.128 is one wavefront. With both operands
//     K-contiguous a float4 holds one row's 4 k: 64 operand registers per
//     4 k, no room to prefetch at the 255-register cap (a warp's product
//     ran at 0.77-0.80 of the FFMA rate, here 0.82-0.88); with both
//     k-major, f1's 4-byte copies cost more waiting than the product
//     gained (PERF.md).
//     f0's transpose costs 4-byte copies once per block: a warp copies
//     8 k x 4 rows (four 32-byte sectors) into 32 distinct banks (132 = 4
//     mod 32);
//   - both reductions stay on registers, as in the bf16 kernel: each
//     thread keeps an online state (max and sum in the log2 domain, or
//     best value and column) for its 8 rows across the whole chunk, merged
//     across lanes and the two column warps once, at the end; a column's
//     partial over the block's 128 rows is reduced over 8 registers, over
//     the 4 lanes of its column (shuffles), then across the 4 row warps of
//     its column half in a shared exchange behind a named barrier of those
//     4 warps, once per tile. No score goes to shared memory. Scale and
//     mask are one FFMA per score and side; the argmax keeps the first
//     index with selects (a thread's rows and columns rise with p and q);
//   - S is cut into chunks (the wrapper picks how many) so that the
//     (row block, chunk) blocks fill the card at B = 1 (ZEB: 87 row blocks
//     x 3 chunks = 261 blocks, 2 waves of 132 SMs less 3). Each block
//     leaves row partials (B, chunks, L), merged by the caller as it
//     merges the column partials.
// Every score's sum runs over k in order 0..C-1 in one thread, so equal
// feature rows give bit-equal scores and planted ties stay exact.
// What sets its pace (PERF.md): one block of 8 warps fits an SM (217 KB
// of shared memory), so each scheduler has two warps to cover the
// latencies of shared loads, ring barriers and the epilogue. A tile runs
// at 0.64 of the FFMA rate in clocks, and at 0.67 with f1's copies taken
// out; under this load the card clocks at about 1.7 GHz, not the 1.98 GHz
// of the bound. At ZEB's shape that is level with torch.bmm's SGEMM.

constexpr int BM_F32 = 128;       // rows of f0 per block
constexpr int TN_F32 = 128;       // rows of f1 per tile: columns of sim
constexpr int BK_F32 = 32;        // k per ring stage
constexpr int STAGES_F32 = 4;     // slices in the ring
constexpr int AHEAD_F32 = 3;      // slices issued ahead of the product
constexpr int THREADS_F32 = 256;  // 8 warps: 4 row warps x 2 column warps
constexpr int MAX_C_F32 = 256;    // widest C: f0's resident k rows
constexpr int LD_F32 = 128 + 4;   // floats per k of f0 in shared memory
constexpr int LDB_F32 = BK_F32 + 4;  // floats per row of an f1 slice
constexpr int STAGE_F32 = TN_F32 * LDB_F32;
// the column exchange: 2 tiles in turn x (values, sums or rows) x 4 row
// warps x 128 columns
constexpr int RED_F32 = 2 * 2 * 4 * TN_F32;
constexpr int BAR_F32 = MAX_C_F32 * LD_F32 + STAGES_F32 * STAGE_F32 + RED_F32;
constexpr size_t SMEM_F32 =
    sizeof(float) * BAR_F32 + 2 * STAGES_F32 * sizeof(uint64_t);
static_assert(SMEM_F32 <= SMEM_MAX, "shared memory");
static_assert(STAGES_F32 * STAGE_F32 >= 4 * BM_F32, "row merge buffer");
static_assert(THREADS_F32 == 256 && BK_F32 == 32 && BM_F32 == 128,
              "f0's copy map and the thread map below");

// Row of the block held in register p by lane group lm of row warp wm:
// 4 consecutive rows, then 4 more 16 rows on (two float4 of k-major f0).
__device__ __forceinline__ int row_f32(int wm, int lm, int p) {
  return wm * 32 + 4 * lm + (p & 3) + 16 * (p >> 2);
}

struct F32Args {
  const float* f0;
  const float* f1;
  const float* m0;
  const float* m1;
  const float* rowterm;
  const float* colterm;
  float scale;      // stats: inv_t log2 e; argmax: 2 inv_t
  int L, S, C;
  int n_k;          // k-slices of 32: ceil(C / 32)
  int n_blocks;     // row blocks: ceil(L / 128)
  int chunks, span; // chunks of S, columns per chunk (whole tiles)
  float* out_v;     // row partials (B, chunks, L)
  float* out_w;
  int* out_i;
  float* part_v;    // column partials (B, n_blocks, S)
  float* part_w;
  int* part_i;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// One float, global to shared; zero when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// The mbarrier counts one arrival when every cp.async this thread issued
// before has landed (and none now).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
// The 128 threads of one column half (warps 4 wn .. 4 wn + 3).
__device__ __forceinline__ void half_sync(int wn) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wn) : "memory");
}

// Built with -DDSMAX_TIMELINE, thread 0 of block (0, 0) sums the SM clocks
// of each of its first 128 tiles in three parts: waiting for the ring
// (issuing the next copies, waiting for the slice), the product, the
// epilogue; read back by
// dsmax_timeline_f32(). Off by default: the helpers compile to nothing.
#ifdef DSMAX_TIMELINE
__device__ unsigned long long g_timeline_f32[128][3];
#endif
__device__ __forceinline__ unsigned long long tl_clock() {
#ifdef DSMAX_TIMELINE
  unsigned long long clk;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(clk)::"memory");
  return clk;
#else
  return 0;
#endif
}
__device__ __forceinline__ void tl_add(int t, int part, unsigned long long d,
                                       bool first) {
#ifdef DSMAX_TIMELINE
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && t < 128)
    g_timeline_f32[t][part] = (first ? 0ull : g_timeline_f32[t][part]) + d;
#endif
}

template <bool ARGMAX>
__global__ void __launch_bounds__(THREADS_F32, 1)
dsmax_f32_kernel(const F32Args a) {
  extern __shared__ __align__(16) float smf[];
  float* sA = smf;
  float* sB = sA + MAX_C_F32 * LD_F32;
  float* red = sB + STAGES_F32 * STAGE_F32;
  const uint32_t full0 = smem_u32(smf + BAR_F32);
  auto full = [&](int st) { return full0 + 8u * st; };
  auto empty = [&](int st) { return full0 + 8u * (STAGES_F32 + st); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int lm = lane >> 3, ln = lane & 7;
  const int blk = blockIdx.x % a.n_blocks, ch = blockIdx.x / a.n_blocks;
  const int b = blockIdx.y;
  const int L = a.L, S = a.S, C = a.C, n_k = a.n_k;
  const int i0 = blk * BM_F32;
  const int jc0 = ch * a.span, jc1 = min(jc0 + a.span, S);
  const int n_steps = (jc1 - jc0 + TN_F32 - 1) / TN_F32 * n_k;
  const float* f0b = a.f0 + (size_t)b * L * C;
  const float* f1b = a.f1 + (size_t)b * S * C;
  const float sc = a.scale;

  if (tid == 0) {
    for (int st = 0; st < STAGES_F32; ++st) {
      mbar_init(full(st), THREADS_F32);   // every thread's copies
      mbar_init(empty(st), THREADS_F32 / 32);   // every warp's product
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // f0's 128 rows over all of C, k-major, zero past L and C: tracked with
  // slice 0. A thread copies one k (ck) of 16 rows (cr + 8 u) per 32 k; a
  // warp's copy is 8 k x 4 rows, four 32-byte sectors.
  const int ck = 8 * (warp & 3) + (lane & 7);
  const int cr = 4 * (warp >> 2) + (lane >> 3);
  for (int kc = 0; kc < n_k; ++kc) {
    const int k = kc * BK_F32 + ck;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int r = cr + 8 * u;
      const bool in = i0 + r < L && k < C;
      cp_async4(sA + k * LD_F32 + r, in ? f0b + (size_t)(i0 + r) * C + k : f0b,
                in);
    }
  }
  // slice s of the chunk: tile s / n_k, k-slice s % n_k; columns past the
  // chunk's end (the next chunk's or past S) and k past C read as zeros
  auto load_f1 = [&](int s) {
    const int t = s / n_k, kc = s - t * n_k;
    float* dst = sB + (s % STAGES_F32) * STAGE_F32;
#pragma unroll
    for (int u = 0; u < TN_F32 * BK_F32 / 4 / THREADS_F32; ++u) {
      const int idx = tid + THREADS_F32 * u;
      const int r = idx / (BK_F32 / 4), k4 = 4 * (idx % (BK_F32 / 4));
      const int j = jc0 + t * TN_F32 + r, k = kc * BK_F32 + k4;
      const bool in = j < jc1 && k < C;
      cp_async16(dst + r * LDB_F32 + k4, in ? f1b + (size_t)j * C + k : f1b,
                 in);
    }
    cp_async_arrive(full(s % STAGES_F32));
  };
#pragma unroll
  for (int s = 0; s < AHEAD_F32; ++s)
    if (s < n_steps) load_f1(s);

  // column side of my 8 rows: a masked row or a row past L is NEG (as the
  // plain version's padded row blocks); stats add 0, argmax -rowterm_i
  float cb[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int i = i0 + row_f32(wm, lm, p);
    const bool valid = i < L && a.m0[(size_t)b * L + i] > 0.f;
    cb[p] = !valid ? NEG : ARGMAX ? -a.rowterm[(size_t)b * L + i] : 0.f;
  }
  // row state of my 8 rows over the chunk. Argmax: best value and its
  // column (the chunk's first column while nothing beat NEG, as the plain
  // version's first index). Stats: running max and sum, log2 domain.
  float rv[8], rw[8];
  int ri[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    rv[p] = NEG;
    rw[p] = 0.f;
    ri[p] = jc0;
  }
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

  const float* m1b = a.m1 + (size_t)b * S;
  const float* ctb = ARGMAX ? a.colterm + (size_t)b * S : nullptr;
  const float* A0 = sA + wm * 32 + 4 * lm;
  const int boff = (wn * 64 + ln) * LDB_F32;

  for (int s = 0; s < n_steps; ++s) {
    const unsigned long long c0 = tl_clock();
    // slice s + 3 goes to the stage that slice s - 1 took, once every warp
    // is done with it (phase (s - 1) / 4 of its empty barrier)
    const int s2 = s + AHEAD_F32;
    if (s2 < n_steps) {
      if (s2 >= STAGES_F32)
        mbar_wait(empty(s2 % STAGES_F32), ((s2 / STAGES_F32) - 1) & 1);
      load_f1(s2);
    }
    // slice s (and, with slice 0, f0) landed from every thread's copies
    mbar_wait(full(s % STAGES_F32), (s / STAGES_F32) & 1);
    const int t = s / n_k, kc = s - t * n_k;
    const bool last = kc == n_k - 1;
    const int jq = jc0 + t * TN_F32 + wn * 64 + ln;   // my column, q = 0
    // the row side's mask and term of my 8 columns, loaded before the
    // tile's last product so that their latency hides behind it; columns
    // past the chunk take no part (-inf), masked ones are NEG
    float rb[8];
    if (last) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int jo = jq + 8 * q, j = min(jo, S - 1);
        const float mk = __ldg(m1b + j);
        const float ct = ARGMAX ? __ldg(ctb + j) : 0.f;
        rb[q] = jo >= jc1 ? -INFINITY : mk <= 0.f ? NEG : -ct;
      }
    }
    const unsigned long long c1 = tl_clock();

    const float* As = A0 + kc * BK_F32 * LD_F32;
    const float* Bs = sB + (s % STAGES_F32) * STAGE_F32 + boff;
#pragma unroll
    for (int k4 = 0; k4 < BK_F32; k4 += 4) {
      float4 bv[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        bv[q] = *reinterpret_cast<const float4*>(Bs + 8 * q * LDB_F32 + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* Ak = As + (k4 + kk) * LD_F32;
        const float4 a0 = *reinterpret_cast<const float4*>(Ak);
        const float4 a1 = *reinterpret_cast<const float4*>(Ak + 16);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float bq = kk == 0 ? bv[q].x : kk == 1 ? bv[q].y
                         : kk == 2 ? bv[q].z : bv[q].w;
#pragma unroll
          for (int p = 0; p < 8; ++p) acc[p][q] = fmaf(av[p], bq, acc[p][q]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s % STAGES_F32));
    const unsigned long long c2 = tl_clock();

    if (last) {
      // row side: columns rise with q and with t, so a strict > keeps the
      // first column
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if (ARGMAX) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float v = fmaf(acc[p][q], sc, rb[q]);
            ri[p] = v > rv[p] ? jq + 8 * q : ri[p];
            rv[p] = fmaxf(rv[p], v);
          }
        } else {
          float v[8];
          float m = -INFINITY;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            v[q] = fmaf(acc[p][q], sc, rb[q]);
            m = fmaxf(m, v[q]);
          }
          const float mn = fmaxf(rv[p], m);
          float sum = 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q) sum += fast_exp2(v[q] - mn);
          rw[p] = rw[p] * fast_exp2(rv[p] - mn) + sum;
          rv[p] = mn;
        }
      }
      // column side: over my 8 rows (rising with p), the 4 lanes of the
      // column (lm, shuffles), then the 4 row warps of my column half
      // (shared memory; the next write to this tile parity's buffer comes
      // after the next tile's barrier of the same warps)
      float* xv = red + (t & 1) * (2 * 4 * TN_F32);   // [4][TN] values
      float* xw = xv + 4 * TN_F32;                    // [4][TN] sums / rows
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float x[8];
#pragma unroll
        for (int p = 0; p < 8; ++p) x[p] = fmaf(acc[p][q], sc, cb[p]);
        float best = x[0];
        int bp = 0;
#pragma unroll
        for (int p = 1; p < 8; ++p) {
          if (ARGMAX) bp = x[p] > best ? p : bp;
          best = fmaxf(best, x[p]);
        }
        int row = row_f32(wm, lm, bp);
#pragma unroll
        for (int off = 8; off < 32; off <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, off);
          if (ARGMAX) {
            const int orow = __shfl_xor_sync(0xffffffffu, row, off);
            const bool take = ob > best || (ob == best && orow < row);
            best = take ? ob : best;
            row = take ? orow : row;
          } else {
            best = fmaxf(best, ob);
          }
        }
        float sum = 0.f;
        if (!ARGMAX) {
#pragma unroll
          for (int p = 0; p < 8; ++p) sum += fast_exp2(x[p] - best);
          sum += __shfl_xor_sync(0xffffffffu, sum, 8);
          sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        }
        if (lm == 0) {
          const int c = wm * TN_F32 + wn * 64 + ln + 8 * q;
          xv[c] = best;
          xw[c] = ARGMAX ? __int_as_float(row) : sum;
        }
      }
      half_sync(wn);
      const int col = wn * 64 + (tid & 127);
      const int j = jc0 + t * TN_F32 + col;
      if ((tid & 127) < 64 && j < jc1) {
        // row warps in order: lower warps hold lower rows, so a strict >
        // keeps the first row
        float v = xv[col], w = xw[col];
#pragma unroll
        for (int q = 1; q < 4; ++q) {
          const float ov = xv[q * TN_F32 + col], ow = xw[q * TN_F32 + col];
          if (ARGMAX) {
            w = ov > v ? ow : w;
            v = fmaxf(v, ov);
          } else {
            const float m = fmaxf(v, ov);
            w = w * fast_exp2(v - m) + ow * fast_exp2(ov - m);
            v = m;
          }
        }
        const size_t o = ((size_t)b * a.n_blocks + blk) * S + j;
        if (ARGMAX) {
          a.part_v[o] = v;
          a.part_i[o] = i0 + __float_as_int(w);
        } else {
          a.part_v[o] = to_natural(v);
          a.part_w[o] = w;
        }
      }
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
    }
    const unsigned long long c3 = tl_clock();
    tl_add(t, 0, c1 - c0, kc == 0);
    tl_add(t, 1, c2 - c1, kc == 0);
    tl_add(t, 2, c3 - c2, kc == 0);
  }

  // merge the row states: the 8 lanes of a row (ln), then the two column
  // warps through shared memory (the ring, once every copy has landed and
  // every product is done). Lanes and warps interleave columns, so ties
  // compare the columns.
#pragma unroll
  for (int p = 0; p < 8; ++p) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, rv[p], off);
      if (ARGMAX) {
        const int oi = __shfl_xor_sync(0xffffffffu, ri[p], off);
        const bool take = ov > rv[p] || (ov == rv[p] && oi < ri[p]);
        rv[p] = take ? ov : rv[p];
        ri[p] = take ? oi : ri[p];
      } else {
        const float ow = __shfl_xor_sync(0xffffffffu, rw[p], off);
        const float m = fmaxf(rv[p], ov);
        rw[p] = rw[p] * fast_exp2(rv[p] - m) + ow * fast_exp2(ov - m);
        rv[p] = m;
      }
    }
  }
  __syncthreads();                 // every slice landed and was read
  float* mv = sB;                  // [2][BM] values
  float* mw = sB + 2 * BM_F32;     // [2][BM] sums / columns
  if (ln == 0) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int r = wn * BM_F32 + row_f32(wm, lm, p);
      mv[r] = rv[p];
      mw[r] = ARGMAX ? __int_as_float(ri[p]) : rw[p];
    }
  }
  __syncthreads();
  if (tid < BM_F32 && i0 + tid < L) {
    float v = mv[tid], w = mw[tid];
    const float ov = mv[BM_F32 + tid], ow = mw[BM_F32 + tid];
    const size_t o = ((size_t)b * a.chunks + ch) * L + i0 + tid;
    if (ARGMAX) {
      const int ix = __float_as_int(w), oi = __float_as_int(ow);
      const bool take = ov > v || (ov == v && oi < ix);
      a.out_v[o] = take ? ov : v;
      a.out_i[o] = take ? oi : ix;
    } else {
      const float m = fmaxf(v, ov);
      a.out_v[o] = to_natural(m);
      a.out_w[o] = w * fast_exp2(v - m) + ow * fast_exp2(ov - m);
    }
  }
}

template <bool ARGMAX>
int launch_f32(const F32Args& a, int B, cudaStream_t stream) {
  cudaError_t err = prepare(dsmax_f32_kernel<ARGMAX>, SMEM_F32);
  if (err != cudaSuccess) return (int)err;
  dsmax_f32_kernel<ARGMAX>
      <<<dim3(a.n_blocks * a.chunks, B), THREADS_F32, SMEM_F32, stream>>>(a);
  return (int)cudaGetLastError();
}

int block_rows(int dtype) { return dtype == 0 ? BM : BM_F32; }

// Columns per chunk: whole 128-column tiles, as even as they come.
int chunk_span(int S, int chunks) {
  const int tiles = (S + TN_F32 - 1) / TN_F32;
  return TN_F32 * ((tiles + chunks - 1) / chunks);
}

bool bad_shape(int dtype, int B, int L, int S, int C, int chunks) {
  if (dtype < 0 || dtype > 1 || B < 1 || B > 65535 || L < 1 || S < 1
      || C < 8 || C > 256 || C % 8 != 0 || chunks < 1)
    return true;
  if (dtype == 0) return chunks != 1;   // the bf16 kernel sweeps all of S
  const int span = chunk_span(S, chunks);
  const long long blocks = (long long)((L + BM_F32 - 1) / BM_F32) * chunks;
  return (S + span - 1) / span != chunks || blocks > 0x7fffffff;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = bf16, 1 = float32.
// Every array is contiguous: f0 (B, L, C), f1 (B, S, C), m0 (B, L),
// m1 (B, S) float32 (> 0 = valid); C a multiple of 8 up to 256. bf16
// features are read by TMA, float32 ones by cp.async: the feature bases
// must be 16-byte aligned (the wrapper checks). S is swept in `chunks`
// chunks of dsmax_chunk_span(S, chunks) columns (float32; bf16 takes 1,
// and no chunk may be empty): row outputs are partials (B, chunks, L),
// column partials (B, ceil(L / dsmax_block_rows(dtype)), S). Returns
// cudaGetLastError() after the launch (0 = launched); what it does not
// take returns cudaErrorInvalidValue without launching.

extern "C" int dsmax_block_rows(int dtype) { return block_rows(dtype); }
extern "C" int dsmax_chunk_span(int S, int chunks) {
  return chunk_span(S, chunks);
}
#ifdef DSMAX_TIMELINE
extern "C" int dsmax_timeline(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_timeline, sizeof(g_timeline));
}
extern "C" int dsmax_timeline_f32(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_timeline_f32,
                                   sizeof(g_timeline_f32));
}
#endif

extern "C" int dsmax_stats(int dtype, const void* f0, const void* f1,
                           const void* m0, const void* m1, float inv_t,
                           int B, int L, int S, int C, int chunks, void* rmax,
                           void* rsum, void* cpmax, void* cpsum,
                           void* stream) {
  if (bad_shape(dtype, B, L, S, C, chunks)) return (int)cudaErrorInvalidValue;
  const int n_blocks = (L + block_rows(dtype) - 1) / block_rows(dtype);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args a{(const float*)m0, (const float*)m1, nullptr, nullptr,
           inv_t * LOG2E, L, S, n_blocks, (float*)rmax, (float*)rsum,
           nullptr, (float*)cpmax, (float*)cpsum, nullptr};
    return dispatch_bf16<false>(f0, f1, B, C, a, st);
  }
  F32Args a{(const float*)f0, (const float*)f1, (const float*)m0,
            (const float*)m1, nullptr, nullptr, inv_t * LOG2E, L, S, C,
            (C + BK_F32 - 1) / BK_F32, n_blocks, chunks,
            chunk_span(S, chunks), (float*)rmax, (float*)rsum, nullptr,
            (float*)cpmax, (float*)cpsum, nullptr};
  return launch_f32<false>(a, B, st);
}

extern "C" int dsmax_argmax(int dtype, const void* f0, const void* f1,
                            const void* m0, const void* m1,
                            const void* colterm, const void* rowterm,
                            float inv_t, int B, int L, int S, int C,
                            int chunks, void* jbest, void* jval, void* ipidx,
                            void* ipval, void* stream) {
  if (bad_shape(dtype, B, L, S, C, chunks)) return (int)cudaErrorInvalidValue;
  const int n_blocks = (L + block_rows(dtype) - 1) / block_rows(dtype);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args a{(const float*)m0, (const float*)m1, (const float*)rowterm,
           (const float*)colterm, 2.f * inv_t, L, S, n_blocks, (float*)jval,
           nullptr, (int*)jbest, (float*)ipval, nullptr, (int*)ipidx};
    return dispatch_bf16<true>(f0, f1, B, C, a, st);
  }
  F32Args a{(const float*)f0, (const float*)f1, (const float*)m0,
            (const float*)m1, (const float*)rowterm, (const float*)colterm,
            2.f * inv_t, L, S, C, (C + BK_F32 - 1) / BK_F32, n_blocks,
            chunks, chunk_span(S, chunks), (float*)jval, nullptr,
            (int*)jbest, (float*)ipval, nullptr, (int*)ipidx};
  return launch_f32<true>(a, B, st);
}
