// K3: flash (online-softmax) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` in gim_tpu/ops/pallas_kernels/
// flash.py (via `flash_sdpa`). For q, k, v of shape (B, H, N, D),
//   o = softmax(q k^T / sqrt(D)) v,
// unmasked self-attention, without writing the (N, N) matrix to device
// memory. Semantics kept from the TPU kernel: the running row max and row
// sum and the output accumulator are float32; p is cast to v's dtype for
// the P V product; key columns past N get -1e30 (not -inf) before the
// max and exp; o = acc / l is written in q's dtype.
//
// Layouts. q, k and v are strided (B, H, N, D) views with unit inner
// stride, such as the qkv split of a ViT block gives (row stride 3 C,
// head stride D); o is written through its own strides, which the caller
// sets to a (B, N, H, D) buffer so that the merge of the heads is a view.
// No operand is copied or padded: query rows past N are not stored, key
// rows past N are masked.
//
// What bounds it. 4 B H N^2 D FLOP (at the ViT-L shape B H = 32, N =
// 2305, D = 64: 4.35e10 FLOP, 0.044 ms at 989 TFLOP/s bf16) against
// 4 B H N D elements of traffic (38 MB, 0.011 ms), so it is bound by the
// tensor cores, and next by the softmax's exp2 and FMA work between the
// products. The bf16 kernel is FlashAttention-3's arrangement, kept
// simple:
//   - one producer warp issues TMA loads (4-D tensor maps over the strided
//     views, 128-byte swizzle, rows past N zero-filled) of Q once and of
//     K and V tiles of 128 keys into a ring of 4 (D = 64) or 3 (D = 128)
//     stages tracked by mbarriers; `setmaxnreg` moves its registers to
//     the consumers;
//   - two consumer warpgroups own 64 query rows each (128 per block).
//     S = Q K^T is one wgmma.m64n128k16 per 16 of D, both operands in
//     shared memory; P, cast to bf16, is the register A operand of
//     O += P V, wgmma.m64nDk16 with V read from shared memory through the
//     transpose bit (V row-major is MN-major for B). Each turn issues
//     S_j = Q K_j^T and O += P_{j-1} V_{j-1};
//   - the online softmax (log2 domain, on the accumulator fragments in
//     registers, one FMA and one ex2 per score; the -1e30 mask only on the
//     last key tile) of S_j runs while the warpgroup's own P V is still in
//     flight, and the two warpgroups take turns issuing (named barriers),
//     so that one's softmax also runs beside the other's products.
// What is left: at D = 64 the exp2s alone (16 a clock per SM) take as long
// as the products, the last key tile of N = 2305 holds one key, and the
// grid's last wave is partial.
//
// float32 design (gim_roma's default dtype). Semantics as above, with p
// kept in float32. Both products run on the tensor cores as 3xTF32
// (wgmma .tf32 with float32 accumulators; hopper.cuh): each operand splits
// into hi = tf32(x) and lo = tf32(x - hi), and a product sums lo.hi +
// hi.lo + hi.hi, which keeps float32's accuracy where one TF32 product
// would not (tests/test_torch_flash.py emulates both).
//   - A split pass (flash_split_f32, a small kernel before the main one)
//     splits K into hi and lo and V into hi and lo transposed, once per
//     call, into a scratch buffer, in tiles of BK keys (32 at D = 64, 48
//     at D = 128) in wgmma's K-major layout without swizzle (TF32 takes
//     no transposed operand). Split in each block instead, the same work
//     is repeated by every query block of a head, in the block's own time.
//   - A block is one warpgroup of 64 query rows (3 blocks an SM at
//     D = 64, 1 at D = 128). Q is read once (16-byte cp.async from the
//     strided view) and kept in registers as wgmma's A fragments, split
//     once at D = 64, at each use at D = 128. Split tiles stream in by one
//     bulk copy each into a 2-stage mbarrier ring.
//   - S = Q K^T is wgmma.m64nBKk8 with A from registers; S's columns come
//     in the order key_row gives the split K, so that the S registers are
//     P V's A fragments as they stand: no shuffles and no shared-memory
//     round trip for P. O += P V is wgmma.m64n64k8, 64 columns of D at a
//     time. The online softmax runs on the fragments in the log2 domain.
//   - The tensor core keeps a running sum at its own rounding, which over
//     2305 keys cost a factor of 5 in the output's error (chip_smoke.py
//     phase 7): each tile's P V (and each 4 k-steps of S) sums into a
//     fresh accumulator that is added in float32.
//   - The bf16 kernel's arrangement was built and measured in float32
//     (f32_probe.py on an edited copy; NVIDIA H100 80GB HBM3 at 700 W;
//     PERF.md section 6): a producer warpgroup streaming the split tiles
//     into a ring shared by two consumer warpgroups of 64 rows (one
//     128-row block an SM) that take turns, S_j issued beside P_{j-1} V
//     (wait-one) at D = 64. It ran 0.486 ms against 0.424 for this
//     kernel at (2, 16, 2305, 64), and 0.592-0.684 against 0.592-0.599
//     (32-key tiles) at (2, 8, 2304, 128). At D = 64 three independent
//     warpgroups an SM hide the products' latency better than two taking
//     turns (without the wait-one the two took 0.608 ms). At D = 128 the
//     registers force a wait after each group of S in either arrangement
//     (hi and lo of Q for 16 k-steps, O and a fresh P V accumulator do
//     not fit in 240), and 128-row blocks leave a last wave of 24 of 132
//     SMs. Halving the split tiles' L2 reads (a tile serving 128 rows)
//     gained nothing. So a block stays one warpgroup.
// Bounds, per gim_roma call (24 launches at (2, 16, 2305, 64), 5 at
// (2, 8, 2304, 128); chip_smoke.py computes both): the floor, the three
// TF32 products of 4 G N^2 D FLOP at 495 TFLOP/s (about 7.6 ms; exps
// and bytes are far below it), and the FP32-FMA figure, 4 G N^2 D FLOP
// at 66.9 TFLOP/s (about 18.9 ms).
//
// Masked float32 variant (LightGlue's self and cross attention,
// `flash_attention_masked`). It replaces no TPU kernel: the JAX package
// runs LightGlue's attention as plain products in XLA. It was added
// because the port's plain products wrote every (B, 4, 2048, 2048) score
// map to device memory and passed over it 4-6 times (scale, masked fill,
// softmax, nan_to_num, a second SGEMM), which made LightGlue's attention
// the largest block of device time in both gim_lightglue cells. Same
// template as the float32 kernel above, with MASK set:
//   - q is (B, H, Nq, D), k and v (B, H, Nk, D), Nq and Nk free; the
//     scale is 1 / sqrt(D), as above (the cross attention's D^-1/4 on
//     each side multiplies to it);
//   - the split pass also packs the key-validity mask (B, Nk) into one
//     bit a key, a word per 32 keys of a tile (__ballot_sync), after the
//     split tiles in the scratch buffer; the main kernel reads a tile's
//     words beside its products and sets invalid keys' scores to -1e30,
//     as the tail columns (keys past Nk are invalid bits);
//   - a row whose query is invalid, or whose batch item has no valid key,
//     is written as 0 (what the plain version's -inf fill and nan_to_num
//     give); other rows are the softmax over the valid keys.
// What bounds it: the three TF32 products of 4 B H Nq Nk D FLOP at 495
// TFLOP/s (0.026 ms at (1, 4, 2048, 64), 0.42 ms at (16, 4, 2048, 64)).
// The batch-1 wave: (1, 4, 2048, 64) is 4 x 32 blocks of 64 query rows,
// one warpgroup on each of 128 of the 132 SMs, so each SM's tensor cores
// wait on one block's loads and softmax (2.8x the floor, against 1.7x at
// batch 16, three blocks an SM). The tiling is the float32 kernel's all
// the same: splitting each block's keys over three warpgroups saved 0.016
// ms a launch, but batch 1 is the demo's and hloc's single pair, whose
// pace the host's dispatch sets (PERF.md section 6), where it moved
// nothing end to end.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Strides in elements of (B, H, N) for q, k, v and o; the last stride is 1.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, one producer warp and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int BQ = 128;           // query rows per block
constexpr int BK = 128;           // key rows per tile
constexpr int CONSUMERS = 2;      // warpgroups of 64 query rows
constexpr int THREADS_BF16 = 128 * (CONSUMERS + 1);
constexpr int ROW = 128;          // bytes per swizzled row: 64 bf16 columns

// Shared memory, offsets from a 1024-byte aligned base. Each operand tile
// is D / 64 panels of (rows x 64 columns), 128-byte rows, 128-byte swizzle
// (what TMA writes and wgmma reads with layout type 1).
template <int D>
struct Smem {
  static constexpr int P = D / 64;
  static constexpr int STAGES = D == 64 ? 4 : 3;   // K/V ring depth
  static constexpr int Q = 0;
  static constexpr int K = Q + P * BQ * ROW;
  static constexpr int V = K + STAGES * P * BK * ROW;
  static constexpr int BAR = V + STAGES * P * BK * ROW;
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

// Coordinate slots (1..3) of n, h and b in a tensor map; slot 0 is D.
struct MapPos {
  int n, h, b;
};

// Load rows [n0, n0 + rows) of head (b, h), columns [64 p, 64 p + 64), for
// p < D / 64, into consecutive panels of `panel_bytes` at dst.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, int panel_bytes,
                                         const CUtensorMap* map, MapPos pos,
                                         uint32_t bar, int n0, int h, int b) {
  const int c1 = pos.n == 1 ? n0 : pos.h == 1 ? h : b;
  const int c2 = pos.n == 2 ? n0 : pos.h == 2 ? h : b;
  const int c3 = pos.n == 3 ? n0 : pos.h == 3 ? h : b;
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    tma_load_4d(dst + p * panel_bytes, map, bar, 64 * p, c1, c2, c3);
}

// D (64 x 64) += A (64 x 16, bf16 registers) . B (16 x 64), B MN-major in
// 128-byte-swizzled shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n64(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A (64 x 16, bf16 registers) . B (16 x 128), B MN-major in
// 128-byte-swizzled shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n128(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x BK) = Q K^T for this warpgroup's 64 rows, D / 16 steps; both
// operands K-major, 16 columns = 32 bytes within a 128-byte swizzle row.
template <int D>
__device__ __forceinline__ void qk_product(float* sc, uint32_t qa,
                                           uint32_t ka) {
  const uint64_t dq = desc_sw128(qa, 16, 1024), dk = desc_sw128(ka, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {   // offsets in 16-byte units
    const uint32_t qoff = ((kk / 4) * BQ * ROW + (kk % 4) * 32) >> 4;
    const uint32_t koff = ((kk / 4) * BK * ROW + (kk % 4) * 32) >> 4;
    wgmma_ss_m64n128(sc, dq + qoff, dk + koff, kk > 0);
  }
}

// O (64 x D) += P V, 16 keys per step; V is MN-major, its 64-column
// panels BK rows apart.
template <int D>
__device__ __forceinline__ void pv_product(float* acc, const uint32_t (*pa)[4],
                                   uint32_t va) {
  const uint64_t dv = desc_sw128(va, BK * ROW, 1024);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = dv + ((kk * 16 * ROW) >> 4);
    if constexpr (D == 64)
      wgmma_rs_m64n64(acc, pa[kk], db);
    else
      wgmma_rs_m64n128(acc, pa[kk], db);
  }
}

// Online softmax of one S tile (key tile j) in the accumulator layout.
// The running max m is kept in the log2 domain (scores times
// scale log2 e); raw scores take their max first, and p = exp2(s sl2 - m)
// is one FMA and one exp2 per score. TAIL masks the key columns past N
// with -1e30 (the last tile only). Updates m and the running sum l,
// returns alpha = exp2(m_old - m_new) per row and P as bf16 A fragments
// (keys 16 c + [0, 8) in registers 0, 1 and 16 c + [8, 16) in 2, 3 of
// step c).
template <bool TAIL>
__device__ __forceinline__ void online_softmax(float* sc, int j, int N, int t,
                                               float sl2, float* m, float* l,
                                               float* alpha,
                                               uint32_t (*pa)[4]) {
  float tmax[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (TAIL && j * BK + (i / 4) * 8 + 2 * t + (i & 1) >= N) sc[i] = NEG;
    tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r] * sl2);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int c = 0; c < BK / 8; ++c) {
    const float p0 = fast_exp2(fmaf(sc[4 * c + 0], sl2, -m[0]));
    const float p1 = fast_exp2(fmaf(sc[4 * c + 1], sl2, -m[0]));
    const float p2 = fast_exp2(fmaf(sc[4 * c + 2], sl2, -m[1]));
    const float p3 = fast_exp2(fmaf(sc[4 * c + 3], sl2, -m[1]));
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    pa[c / 2][(c & 1) * 2 + 0] = pack_bf16(p0, p1);
    pa[c / 2][(c & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
}

// online_softmax with the tail mask only where the tile reaches past N.
__device__ __forceinline__ void softmax_tile(float* sc, int j, int N, int t,
                                             float sl2, float* m, float* l,
                                             float* alpha,
                                             uint32_t (*pa)[4]) {
  if ((j + 1) * BK > N)
    online_softmax<true>(sc, j, N, t, sl2, m, l, alpha, pa);
  else
    online_softmax<false>(sc, j, N, t, sl2, m, l, alpha, pa);
}

template <int D>
__global__ void __launch_bounds__(THREADS_BF16, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, MapPos pq,
                  MapPos pk, MapPos pv, bf16* __restrict__ o, Strides st,
                  int H, int N, float scale) {
  using S = Smem<D>;
  constexpr int P = S::P, STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + S::Q, sk = base + S::K, sv = base + S::V;
  const uint32_t q_full = base + S::BAR;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * STAGES + s); };

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int n_tiles = (N + BK - 1) / BK;
  // warp-uniform to the compiler, so that descriptors live in uniform
  // registers and successive wgmmas need not wait for each other
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);    // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(q_full, BQ * D * 2);
      tma_tile<D>(sq, BQ * ROW, &mq, pq, q_full, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(s), ((j / STAGES) - 1) & 1);
        mbar_expect_tx(k_full(s), BK * D * 2);
        tma_tile<D>(sk + s * P * BK * ROW, BK * ROW, &mk, pk, k_full(s),
                    j * BK, h, b);
        mbar_expect_tx(v_full(s), BK * D * 2);
        tma_tile<D>(sv + s * P * BK * ROW, BK * ROW, &mv, pv, v_full(s),
                    j * BK, h, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;                 // column pair in the fragment
    const uint32_t qa = sq + wg * 64 * ROW;
    auto ks = [&](int s) { return sk + s * P * BK * ROW; };
    auto vs = [&](int s) { return sv + s * P * BK * ROW; };

    const float sl2 = scale * LOG2E;        // scores in the log2 domain
    float m[2] = {NEG, NEG};                // running max of rows g, g + 8
    float l[2] = {0.f, 0.f};                // this thread's part of the sums
    float acc[D / 2];                       // O: 64 x D over the warpgroup
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[64];                           // S: 64 x BK over the warpgroup
    uint32_t pa[BK / 16][4];                // P of the previous tile, bf16
    float alpha[2];

    // tile 0: S, then its softmax (O is still zero: no rescale)
    scheduler_open(wg);
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    scheduler_wait(wg);
    fence_operands<64>(sc);
    wgmma_fence();
    qk_product<D>(sc, qa, ks(0));
    wgmma_commit();
    scheduler_pass(wg, wg == 1 && n_tiles == 1);
    wgmma_wait_all();
    fence_operands<64>(sc);
    softmax_tile(sc, 0, N, t, sl2, m, l, alpha, pa);

    // tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} as two groups in
    // this warpgroup's turn; the softmax of S_j runs while P V is still in
    // flight, into the other P buffer (two buffers, no register copies),
    // and O is rescaled once P V has landed
    uint32_t pb[BK / 16][4];
    auto step = [&](int j, uint32_t (*pin)[4], uint32_t (*pout)[4]) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      mbar_wait(k_full(s), (j / STAGES) & 1);
      mbar_wait(v_full(sp), ((j - 1) / STAGES) & 1);
      scheduler_wait(wg);
      fence_operands<64>(sc);
      fence_operands<D / 2>(acc);
      fence_operands<BK / 16>(pin);
      wgmma_fence();
      qk_product<D>(sc, qa, ks(s));
      wgmma_commit();
      pv_product<D>(acc, pin, vs(sp));
      wgmma_commit();
      scheduler_pass(wg, wg == 1 && j == n_tiles - 1);
      wgmma_wait_one();
      fence_operands<64>(sc);
      softmax_tile(sc, j, N, t, sl2, m, l, alpha, pout);
      wgmma_wait_all();
      fence_operands<D / 2>(acc);
      fence_operands<BK / 16>(pin);
      if (lane == 0) mbar_arrive(empty(sp));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    };
    int j = 1;
    for (; j + 1 < n_tiles; j += 2) {
      step(j, pa, pb);
      step(j + 1, pb, pa);
    }
    if (j < n_tiles) {
      step(j, pa, pb);
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[c][e] = pb[c][e];
    }
    const int sl = (n_tiles - 1) % STAGES;
    mbar_wait(v_full(sl), ((n_tiles - 1) / STAGES) & 1);
    fence_operands<D / 2>(acc);
    fence_operands<BK / 16>(pa);
    wgmma_fence();
    pv_product<D>(acc, pa, vs(sl));
    wgmma_commit();
    wgmma_wait_all();
    fence_operands<D / 2>(acc);
    if (lane == 0) mbar_arrive(empty(sl));

    // full row sums across the four threads of a row, then o = acc / l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / l[r];
    }
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
    bf16* ob = o + b * st.o[0] + h * st.o[1];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = c * 8 + 2 * t;
      if (r0 < N)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * st.o[2] + col) =
            __floats2bfloat162_rn(acc[4 * c] * l[0], acc[4 * c + 1] * l[0]);
      if (r0 + 8 < N)
        *reinterpret_cast<__nv_bfloat162*>(ob + (r0 + 8) * st.o[2] + col) =
            __floats2bfloat162_rn(acc[4 * c + 2] * l[1],
                                  acc[4 * c + 3] * l[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: K and V split once per call, 3xTF32 on wgmma
// ---------------------------------------------------------------------------

constexpr int THREADS_F32 = 128;  // one warpgroup: 64 query rows
constexpr int BQ_F32 = 64;

// Split tiles of BK keys, in wgmma's K-major layout without swizzle: core
// matrices of 8 rows x 4 words (128 contiguous bytes), CORE bytes apart
// along K and SBO bytes apart from one 8-row group to the next. A tile is
// K hi, K lo ([key][d], rows in S's key order) and V^T hi, V^T lo
// ([d][key]), TILE floats in all, the same in the scratch buffer and in
// each stage of the kernel's ring.
template <int D>
struct F32Tiles {
  // keys per tile: 48 at D = 128, where the two stages (192 KB) leave one
  // block an SM whatever the tile, and a wider S product runs closer to
  // the tensor cores' rate (0.595 -> 0.570 ms at (2, 8, 2304, 128),
  // f32_probe.py); at D = 64, 32 keys keep three blocks an SM
  static constexpr int BK = D == 64 ? 32 : 48;
  static constexpr int PART = BK * D;              // floats of one part
  static constexpr int TILE = 4 * PART;
  static constexpr int K_HI = 0, K_LO = PART, VT_HI = 2 * PART,
                       VT_LO = 3 * PART;
  static constexpr int SBO_K = D / 4 * CORE;       // K: rows are keys
  static constexpr int SBO_V = BK / 4 * CORE;      // V^T: rows are d
  static constexpr int LD = D + 4;                 // Q staging rows
  static constexpr int STAGES = 2;
  // Q is staged over stage 1 before tile 1 is loaded
  static constexpr int FLOATS =
      TILE + (TILE > BQ_F32 * LD ? TILE : BQ_F32 * LD);
  static constexpr int BYTES = FLOATS * 4 + 8 * STAGES;
  // Q's A fragments stay in registers, split once at D = 64 and at each
  // use at D = 128 (where hi and lo would not fit beside O); S is summed
  // in groups of SG k-steps, each group into a fresh accumulator
  static constexpr bool Q_SPLIT = D == 64;
  static constexpr int SG = 4;
  static constexpr int BLOCKS = D == 64 ? 3 : 1;   // per SM
  // the masked variant: key-validity words a tile
  static constexpr int WORDS = (BK + 31) / 32;
};

// The masked variant's masks (null pointers in the unmasked one): the
// queries' and keys' validity, (B, Nq) and (B, Nk) bytes, 1 = valid (a
// null pointer: all valid), and the key bits the split pass packs, WORDS
// a tile, tile j of batch item b at (b n_tiles + j) WORDS.
struct Masks {
  const unsigned char* q_valid;
  const unsigned char* k_valid;
  unsigned* k_bits;
};

// S's key order within each group of 8: the n-th column of S is key
// n / 2 + 4 (n % 2), so that a lane's columns 2 t, 2 t + 1 are keys t,
// t + 4, which is where the A fragment of P V wants P: P V then takes P
// from the S registers as they stand, with V in its own order. Key k sits
// in row key_row(k) of the split K tile.
__device__ __forceinline__ int key_row(int k) {
  return (k & ~7) + 2 * (k % 4) + (k % 8) / 4;
}

// The split pass: one block per (tile of BK keys, head, K or V) writes the
// tile's two parts, hi and lo, into the scratch buffer (tile j of head
// b H + h at (b H + h) n_tiles + j). Keys at or past N are zeros. With
// MASK, the K blocks of head 0 also write the tile's key bits (Masks).
template <int D, bool MASK>
__global__ void __launch_bounds__(THREADS_F32)
flash_split_f32(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ scratch, Strides st, int H, int N,
                Masks mk) {
  using T = F32Tiles<D>;
  constexpr int V4 = D / 4;
  const int j = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  char* tile = reinterpret_cast<char*>(
      scratch + ((size_t)bh * gridDim.x + j) * T::TILE);
  if constexpr (MASK) {
    // bit r of word w: key 32 w + r of the tile is below N and valid
    if (blockIdx.z == 0 && h == 0 && threadIdx.x < 32 * T::WORDS) {
      const int r = threadIdx.x, key = j * T::BK + r;
      const bool ok = r < T::BK && key < N
                      && (mk.k_valid == nullptr
                          || mk.k_valid[(size_t)b * N + key] != 0);
      const unsigned word = __ballot_sync(0xffffffffu, ok);
      if (r % 32 == 0)
        mk.k_bits[((size_t)b * gridDim.x + j) * T::WORDS + r / 32] = word;
    }
  }
  if (blockIdx.z == 0) {
    // consecutive threads take consecutive keys of one group of 4
    // columns: every store is a core-matrix row
    const float* kb = k + b * st.k[0] + h * st.k[1];
    for (int i = threadIdx.x; i < T::BK * V4; i += THREADS_F32) {
      const int r = i % T::BK, c = (i / T::BK) * 4, key = j * T::BK + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (key < N) x = *reinterpret_cast<const float4*>(kb + key * st.k[2] + c);
      uint4 hi, lo;
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      const int off = kmajor(key_row(r), c, T::SBO_K);
      *reinterpret_cast<uint4*>(tile + T::K_HI * 4 + off) = hi;
      *reinterpret_cast<uint4*>(tile + T::K_LO * 4 + off) = lo;
    }
  } else {
    // a lane takes one column d of 4 keys: V^T's core-matrix row
    const float* vb = v + b * st.v[0] + h * st.v[1];
    for (int i = threadIdx.x; i < T::BK * V4; i += THREADS_F32) {
      const int d = i % D, k0 = (i / D) * 4;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * T::BK + k0 + e;
        x[e] = key < N ? vb[key * st.v[2] + d] : 0.f;
      }
      uint4 hi, lo;
      split_tf32(x[0], hi.x, lo.x);
      split_tf32(x[1], hi.y, lo.y);
      split_tf32(x[2], hi.z, lo.z);
      split_tf32(x[3], hi.w, lo.w);
      const int off = kmajor(d, k0, T::SBO_V);
      *reinterpret_cast<uint4*>(tile + T::VT_HI * 4 + off) = hi;
      *reinterpret_cast<uint4*>(tile + T::VT_LO * 4 + off) = lo;
    }
  }
}

template <int D, bool MASK>
__global__ void __launch_bounds__(THREADS_F32, F32Tiles<D>::BLOCKS)
flash_f32_kernel(const float* __restrict__ q,
                 const float* __restrict__ scratch, float* __restrict__ o,
                 Strides st, int H, int N, int n_tiles, float scale,
                 Masks mk) {
  using T = F32Tiles<D>;
  constexpr int BK = T::BK, LD = T::LD, NB = BK / 8, DT = D / 8;
  constexpr int SG = T::SG;
  extern __shared__ __align__(128) float sm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ_F32;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* tiles = scratch + (size_t)blockIdx.y * n_tiles * T::TILE;
  const uint32_t s_base = smem_u32(sm);
  const uint32_t full = smem_u32(sm + T::FLOATS);
  auto stage = [&](int s) { return s_base + s * T::TILE * 4; };
  auto load = [&](int jt) {          // one thread: tile jt into its stage
    const int s = jt % T::STAGES;
    mbar_expect_tx(full + 8 * s, T::TILE * 4);
    bulk_load(stage(s), tiles + (size_t)jt * T::TILE, T::TILE * 4,
              full + 8 * s);
  };

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q rows [q0, q0 + 64) over stage 1, as 16-byte cp.async (rows at or
  // past N zero-filled)
  float* qs = sm + T::TILE;
  for (int i = tid; i < BQ_F32 * (D / 4); i += THREADS_F32) {
    const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
    const bool ok = q0 + r < N;
    cp_async16(qs + r * LD + c, ok ? qb + (q0 + r) * st.q[2] + c : qb, ok);
  }
  cp_async_commit();
  __syncthreads();                  // barriers initialised
  if (tid == 0) load(0);
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 rows of Q as A fragments: hi and lo (D = 64), or the
  // float32 bits, split where they are used (D = 128)
  uint32_t qh[DT][4], ql[T::Q_SPLIT ? DT : 1][4];
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    ldmatrix_x4(qh[kk], qs + (16 * warp + lane % 8 + 8 * ((lane / 8) % 2))
                                 * LD + 8 * kk + 4 * (lane / 16));
    if constexpr (T::Q_SPLIT) {
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(qh[kk][e], qh[kk][e], ql[kk][e]);
    }
  }
  __syncthreads();                  // stage 1 is free for tile 1
  if (tid == 0 && n_tiles > 1) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    load(1);
  }

  const float sl2 = scale * LOG2E;  // scores in the log2 domain
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
  float acc[D / 2];                 // O: 64 x D over the warpgroup
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  unsigned any_key = 0;             // MASK: the OR of the tiles' key bits

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % T::STAGES;
    // MASK: the tile's key bits, read while its products run
    unsigned kw[T::WORDS];
    if constexpr (MASK) {
#pragma unroll
      for (int w = 0; w < T::WORDS; ++w) {
        kw[w] = __ldg(mk.k_bits + ((size_t)b * n_tiles + j) * T::WORDS + w);
        any_key |= kw[w];
      }
    }
    mbar_wait(full + 8 * s, (j / T::STAGES) & 1);
    // Q's splits stay inside the loop: hoisted, those of all DT k-steps
    // (128 registers at D = 128) spilled
    fence_operands<DT>(qh);
    const uint32_t k_hi = stage(s) + T::K_HI * 4, k_lo = stage(s) + T::K_LO * 4;
    const uint32_t v_hi = stage(s) + T::VT_HI * 4,
                   v_lo = stage(s) + T::VT_LO * 4;

    // S = Q K^T (64 x BK): each group of SG k-steps sums into a fresh
    // accumulator, added to s in float32 (the tensor core's own rounding
    // of a running sum is not carried over all of D)
    float s_[4 * NB];
#pragma unroll
    for (int i = 0; i < 4 * NB; ++i) s_[i] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < DT; k0 += SG) {
      float sp[4 * NB];
      uint32_t ah[SG][4], al[SG][4];
#pragma unroll
      for (int kk = 0; kk < SG; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (T::Q_SPLIT) {
            ah[kk][e] = qh[k0 + kk][e];
            al[kk][e] = ql[k0 + kk][e];
          } else {
            split_tf32(qh[k0 + kk][e], ah[kk][e], al[kk][e]);
          }
        }
      fence_operands<4 * NB>(sp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SG; ++kk) {
        const uint32_t off = (k0 + kk) * 2 * CORE;
        wgmma_tf32<BK>(sp, al[kk], desc_plain(k_hi + off, CORE, T::SBO_K),
                       kk > 0);
        wgmma_tf32<BK>(sp, ah[kk], desc_plain(k_lo + off, CORE, T::SBO_K), 1);
        wgmma_tf32<BK>(sp, ah[kk], desc_plain(k_hi + off, CORE, T::SBO_K), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<4 * NB>(sp);
#pragma unroll
      for (int i = 0; i < 4 * NB; ++i) s_[i] += sp[i];
    }

    // online softmax in the log2 domain: the running max m holds scores
    // times scale log2 e; key columns past N (MASK: whose bit is 0) read
    // -1e30. Register i of S is row g + 8 ((i >> 1) & 1) of the warp's 16,
    // key 8 (i / 4) + t + 4 (i & 1) of the tile (key_row)
    const bool tail = !MASK && (j + 1) * BK > N;
    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 4 * NB; ++i) {
      const int kt = 8 * (i / 4) + t + 4 * (i & 1);
      if constexpr (MASK) {
        if (!((kw[kt / 32] >> (kt % 32)) & 1u)) s_[i] = NEG;
      } else {
        if (tail && j * BK + kt >= N) s_[i] = NEG;
      }
      tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s_[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m_run[r], tmax[r] * sl2);
      alpha[r] = fast_exp2(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    // P as A fragments of P V, split: key step kp is registers {0, 2, 1,
    // 3} of S's n tile kp (key_row)
    uint32_t ph[NB][4], pl[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#ifndef F32_PROBE_NO_EXP
        p[e] = fast_exp2(fmaf(s_[4 * n + e], sl2, -m_run[e >> 1]));
#else   // f32_probe.py's ablation: P = S without the MUFU's exp2
        p[e] = fmaf(s_[4 * n + e], sl2, -m_run[e >> 1]);
#endif
        l_run[e >> 1] += p[e];
      }
      split_tf32(p[0], ph[n][0], pl[n][0]);
      split_tf32(p[2], ph[n][1], pl[n][1]);
      split_tf32(p[1], ph[n][2], pl[n][2]);
      split_tf32(p[3], ph[n][3], pl[n][3]);
    }

    // O = alpha O + P V, 64 columns of D at a time: the tile's keys sum
    // into a fresh accumulator, added to O in float32
#pragma unroll
    for (int half = 0; half < D / 64; ++half) {
      float op[32];
      const uint32_t voff = half * 8 * T::SBO_V;
      fence_operands<32>(op);
      wgmma_fence();
#pragma unroll
      for (int kp = 0; kp < NB; ++kp) {
        const uint32_t off = voff + kp * 2 * CORE;
        wgmma_tf32<64>(op, pl[kp], desc_plain(v_hi + off, CORE, T::SBO_V),
                       kp > 0);
        wgmma_tf32<64>(op, ph[kp], desc_plain(v_lo + off, CORE, T::SBO_V), 1);
        wgmma_tf32<64>(op, ph[kp], desc_plain(v_hi + off, CORE, T::SBO_V), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<32>(op);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[32 * half + i] =
            fmaf(acc[32 * half + i], alpha[(i >> 1) & 1], op[i]);
    }
    __syncthreads();                // every product has read stage s ...
    if (tid == 0 && j + T::STAGES < n_tiles) load(j + T::STAGES);  // refill
  }

  // full row sums across the four lanes of a row, then o = acc / l;
  // MASK: 0 in rows whose query is invalid or which have no valid key
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
  }
  float* ob = o + b * st.o[0] + h * st.o[1];
  const int r0 = q0 + 16 * warp + g;
  bool keep[2] = {true, true};
  if constexpr (MASK) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      keep[r] = any_key != 0 && row < N
                && (mk.q_valid == nullptr
                    || mk.q_valid[(size_t)b * N + row] != 0);
      if (!keep[r]) inv[r] = 0.f;
    }
  }
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int col = 8 * n + 2 * t;
    float2 v0 = make_float2(acc[4 * n] * inv[0], acc[4 * n + 1] * inv[0]);
    float2 v1 = make_float2(acc[4 * n + 2] * inv[1], acc[4 * n + 3] * inv[1]);
    if constexpr (MASK) {
      if (!keep[0]) v0 = make_float2(0.f, 0.f);
      if (!keep[1]) v1 = make_float2(0.f, 0.f);
    }
    if (r0 < N)
      *reinterpret_cast<float2*>(ob + r0 * st.o[2] + col) = v0;
    if (r0 + 8 < N)
      *reinterpret_cast<float2*>(ob + (r0 + 8) * st.o[2] + col) = v1;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A rank-4 bf16 tensor map over one strided (B, H, N, D) view: dimension 0
// is D (unit stride), dimensions 1..3 are N, H and B ordered by increasing
// stride (a size-1 dimension takes a stride past the others). The box is
// 64 columns x `rows` rows of N, 128-byte swizzle; rows past N read as
// zeros. `pos` receives the coordinate slot of each of n, h, b.
bool make_map(CUtensorMap* map, MapPos* pos, const void* ptr,
              const long long* strides, int B, int H, int N, int D,
              int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  // (size, stride in bytes, which: 0 = n, 1 = h, 2 = b)
  long long size[3] = {N, H, B};
  long long sb[3] = {strides[2] * 2, strides[1] * 2, strides[0] * 2};
  int which[3] = {0, 1, 2};
  long long span = (long long)D * 2;
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1 && size[i] * sb[i] > span) span = size[i] * sb[i];
  span = (span + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i)
    if (size[i] == 1) sb[i] = span;
  for (int i = 0; i < 3; ++i)          // sort the three by stride
    for (int j = 0; j + 1 < 3 - i; ++j)
      if (sb[j] > sb[j + 1]) {
        long long ts = sb[j]; sb[j] = sb[j + 1]; sb[j + 1] = ts;
        long long tz = size[j]; size[j] = size[j + 1]; size[j + 1] = tz;
        int tw = which[j]; which[j] = which[j + 1]; which[j + 1] = tw;
      }
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)size[0],
                        (cuuint64_t)size[1], (cuuint64_t)size[2]};
  cuuint64_t gstrides[3] = {(cuuint64_t)sb[0], (cuuint64_t)sb[1],
                            (cuuint64_t)sb[2]};
  cuuint32_t box[4] = {64, 1, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    if (which[i] == 0) {
      box[i + 1] = (cuuint32_t)rows;
      pos->n = i + 1;
    } else if (which[i] == 1) {
      pos->h = i + 1;
    } else {
      pos->b = i + 1;
    }
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, gstrides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           void* scratch, int B, int H, int N, const Strides& st,
           float scale, cudaStream_t stream) {
  cudaError_t err;
  if (dtype == 0) {
    CUtensorMap mq, mk, mv;
    MapPos pq, pk, pv;
    if (!make_map(&mq, &pq, q, st.q, B, H, N, D, BQ)
        || !make_map(&mk, &pk, k, st.k, B, H, N, D, BK)
        || !make_map(&mv, &pv, v, st.v, B, H, N, D, BK))
      return (int)cudaErrorInvalidValue;
    const size_t smem = Smem<D>::BYTES;
    err = prepare(flash_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + BQ - 1) / BQ, B * H);
    flash_bf16_kernel<D><<<grid, THREADS_BF16, smem, stream>>>(
        mq, mk, mv, pq, pk, pv, (bf16*)o, st, H, N, scale);
  } else {
    using T = F32Tiles<D>;
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int n_tiles = (N + T::BK - 1) / T::BK;
    flash_split_f32<D, false>
        <<<dim3(n_tiles, B * H, 2), THREADS_F32, 0, stream>>>(
            (const float*)k, (const float*)v, (float*)scratch, st, H, N,
            Masks{});
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = prepare(flash_f32_kernel<D, false>, T::BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + BQ_F32 - 1) / BQ_F32, B * H);
    flash_f32_kernel<D, false><<<grid, THREADS_F32, T::BYTES, stream>>>(
        (const float*)q, (const float*)scratch, (float*)o, st, H, N, n_tiles,
        scale, Masks{});
  }
  return (int)cudaGetLastError();
}

// Split tiles of the masked variant, then the key bits (Masks), in bytes.
template <int D>
long long masked_scratch_bytes(int B, int H, int Nk) {
  using T = F32Tiles<D>;
  const long long n_tiles = (Nk + T::BK - 1) / T::BK;
  const long long bits = ((long long)B * n_tiles * T::WORDS * 4 + 15) / 16 * 16;
  return (long long)B * H * n_tiles * T::TILE * 4 + bits;
}

template <int D>
int launch_masked(const float* q, const float* k, const float* v,
                  const unsigned char* q_valid, const unsigned char* k_valid,
                  float* o, void* scratch, int B, int H, int Nq, int Nk,
                  const Strides& st, cudaStream_t stream) {
  using T = F32Tiles<D>;
  const int n_tiles = (Nk + T::BK - 1) / T::BK;
  float* tiles = (float*)scratch;
  const Masks mk{q_valid, k_valid,
                 (unsigned*)(tiles + (size_t)B * H * n_tiles * T::TILE)};
  flash_split_f32<D, true>
      <<<dim3(n_tiles, B * H, 2), THREADS_F32, 0, stream>>>(
          k, v, tiles, st, H, Nk, mk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = prepare(flash_f32_kernel<D, true>, T::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nq + BQ_F32 - 1) / BQ_F32, B * H);
  flash_f32_kernel<D, true><<<grid, THREADS_F32, T::BYTES, stream>>>(
      q, tiles, o, st, H, Nq, n_tiles, 1.f / sqrtf((float)D), mk);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = bf16, 1 = float32.
// q, k, v: (B, H, N, D) views, D in {64, 128}, unit stride along D;
// `strides` holds 12 element strides, (B, H, N) for q, k, v and o in that
// order. Operands are read by TMA (bf16) or 16-byte copies (float32):
// bases and strides must be multiples of 16 bytes (the wrapper checks).
// float32 takes `scratch` of flash_scratch_bytes(...) bytes, 16-byte
// aligned, for the split K and V; bf16 takes none. Returns
// cudaGetLastError() after the launches (0 = launched); what it does not
// take returns cudaErrorInvalidValue without launching.

extern "C" long long flash_scratch_bytes(int dtype, int B, int H, int N,
                                         int D) {
  if (dtype == 0 || B < 1 || H < 1 || N < 1) return 0;
  const int bk = D == 64 ? F32Tiles<64>::BK : F32Tiles<128>::BK;
  const long long tiles = (long long)B * H * ((N + bk - 1) / bk);
  return tiles * 4 * bk * D * 4;
}

extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* o, void* scratch, int B,
                               int H, int N, int D, const long long* strides,
                               float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(dtype, q, k, v, o, scratch, B, H, N, st, scale, s);
  if (D == 128)
    return launch<128>(dtype, q, k, v, o, scratch, B, H, N, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The masked float32 variant (LightGlue's attention): q (B, H, Nq, D), k
// and v (B, H, Nk, D) float32 views under the same rules as above, D in
// {64, 128}; q_valid (B, Nq) and k_valid (B, Nk) contiguous bytes, 1 =
// valid (null: all valid); o through its strides. `scratch` holds
// flash_masked_scratch_bytes(...) bytes, 16-byte aligned. The scale is
// 1 / sqrt(D). Launches on `device` (the operands' card; the caller's
// current device is restored) and `stream`. Returns as flash_attention
// does.

extern "C" long long flash_masked_scratch_bytes(int B, int H, int Nk, int D) {
  if (B < 1 || H < 1 || Nk < 1) return 0;
  return D == 64 ? masked_scratch_bytes<64>(B, H, Nk)
                 : masked_scratch_bytes<128>(B, H, Nk);
}

extern "C" int flash_attention_masked(const void* q, const void* k,
                                      const void* v, const void* q_valid,
                                      const void* k_valid, void* o,
                                      void* scratch, int B, int H, int Nq,
                                      int Nk, int D, const long long* strides,
                                      int device, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || (long long)B * H > 65535
      || scratch == nullptr || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qv = (const unsigned char*)q_valid;
  const auto* kv = (const unsigned char*)k_valid;
  const int ret =
      D == 64 ? launch_masked<64>((const float*)q, (const float*)k,
                                  (const float*)v, qv, kv, (float*)o, scratch,
                                  B, H, Nq, Nk, st, s)
              : launch_masked<128>((const float*)q, (const float*)k,
                                   (const float*)v, qv, kv, (float*)o,
                                   scratch, B, H, Nq, Nk, st, s);
  if (current != device) cudaSetDevice(current);
  return ret;
}
