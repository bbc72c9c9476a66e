// The backward of causal grouped-query flash attention on the tensor cores
// in float32 (3xTF32: float32 with Dh % 8 == 0, Dh <= 192), for sm_90a:
// dq, dk and dv of flash_attention.cu's function, the function
// flash_attention_bwd.cu states (its header), in the same layout:
//
//   q, out, dout   [B, S, KvH, G, Dh] float32   (query head h = kvh * G + g)
//   k, v           [B, S, KvH, Dh]    float32
//   dq             [B, S, KvH, G, Dh],  dk, dv [B, S, KvH, Dh]   float32
//
// The TPU side has no Pallas backward: the reference trains through the
// blockwise jnp attention XLA differentiates (src/repro/models/
// layers.py:114); the Pallas kernel of the forward is
// flash_attention_causal of src/repro/kernels/flash_attention.py
// (pallas_call at :88).
//
// What bounds it on an H100: operations, 10 Dh flops a (query head,
// key <= query) pair, at the float32-accurate tensor rate (495 / 3
// TFLOP/s): 976.6 us at the smollm training shape (B = 8, S = 2048,
// KvH = 5, G = 3, Dh = 64), 781.3 us at MLA's (B = 2, S = 2048, KvH = 16,
// G = 1, Dh = 192). The design is flash_attention_bwd_wgmma.cu's three
// kernels (stats -> dkdv -> dq, no float atomics, a fixed order, so two
// calls give the same bits) with every product in tf32 at float32
// accuracy, as flash_attention.cu's flash_tf32x3_kernel takes them: a.b
// = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, x_hi = cvt.rna.tf32(x), x_lo =
// cvt.rna.tf32(x - x_hi), summed in float32 by wgmma; no single-tf32
// product is taken. One consumer warpgroup a block computes, one
// producer warp streams tiles by TMA; resident operands are loaded,
// split and swizzled by the consumers. Dh^-0.5 is applied in float32:
// to S (with log2 e, as exp2's argument) and to dK and dQ at the end; lse
// is in the log2 domain, as on the bf16 route.
//
// * stats_kernel: one block per (b, kvh, 64 rows = bq = 64 / G positions
//   with their G heads); Q_hi, Q_lo resident, 64-key K tiles streamed
//   (split in place into K_hi beside K_lo): S = Q.K^T and the online max
//   and sum, lse = m + log2 l. Then D = the diagonal of dO.O^T (below).
// * dkdv_kernel: one block per (b, kvh, 64-key block[, Dh half]),
//   heaviest (the first keys) first. K and V resident (hi, lo); tiles of
//   X rows (X / G positions) of Q and dO streamed by TMA with each row's
//   lse and D (the producer's lanes write those): S^T = K.Q^T and dP^T =
//   V.dO^T from shared memory, P^T and dS^T = P^T (dP^T - D) in
//   registers, dV += P^T.dO and dK += dS^T.Q with P^T and dS^T as
//   register A operands.
// * dq_kernel: one block per (b, kvh, 64 rows[, Dh half]), heaviest (the
//   last positions) first. Q and dO resident (hi, lo); X-key K and V
//   tiles streamed: S = Q.K^T and dP = dO.V^T, dS in registers, dQ +=
//   dS.K. It recomputes S and dP so that it needs no atomics.
//
// Where the trouble is:
//
// 1. tf32 operands cannot be transposed (the descriptor's transpose bit
//    is for f16 and bf16 only). dV += P^T.dO and dK += dS^T.Q reduce over
//    rows, and dQ += dS.K over keys, where Q, dO and K hold Dh
//    contiguous; so each streamed tile is also written transposed — Q^T
//    and dO^T in dkdv (rows contiguous), K^T in dq (keys contiguous) —
//    hi and lo, [Dh][rows or keys] in 32-element 128-byte swizzled rows.
//    Each 8-element group of the reduced dimension is stored in the
//    order 0, 2, 4, 6, 1, 3, 5, 7: the m64k8 tf32 A fragment holds
//    columns c and c + 4 where the accumulator holds 2c and 2c + 1, so
//    P^T, dS^T and dS, accumulators, are their own A fragments with no
//    shuffle (as V^T in the forward). A tile is split in place (raw ->
//    hi, lo beside it), then hi and lo are transposed: the transposes are
//    data movement only (tf32(x) transposed is tf32 of x transposed).
// 2. Shared memory sets the design. Float32 doubles every tile and the lo
//    parts double it again: a resident 64-row hi/lo pair of two operands
//    is 1 KB * Dh, and each streamed row (or key) needs its raw tile, the
//    lo part and the hi and lo transposes, 24-32 B * Dh. Dh <= 64 fits one
//    block with 64-row (64-key) tiles. Above 64 the Dh columns are split
//    over a cluster of two blocks (design (a)), each holding NP panels of
//    32 columns (Dh 72-128: 2 + 2, 136-192: 3 + 3) with X = 32-row
//    (32-key) tiles: block h computes the partial S and dP over its
//    columns, the two swap them through distributed shared memory (each
//    thread stores its fragments into the other block's buffer and
//    arrives on that block's mbarrier; two buffers, each guarded by a
//    "full" and an "empty" mbarrier that the other block's 128 consumers
//    arrive on remotely), and each adds mine + other's: float addition
//    commutes, so both hold the same bits. Block h then accumulates its
//    half of dQ (or dK and dV) and writes it. Design (a) keeps every
//    product done once and the split work per block halved; streaming Dh
//    panels from L2 (design (b)) would split each resident operand again
//    for every tile it meets. The two-block cluster is scheduled as a
//    pair, so each block waits only on its twin. The stats kernel has no
//    cluster: it holds Q_hi, Q_lo at the full Dh (96 KB at Dh = 192) and
//    one 64-key K tile.
// 3. Registers. dK and dV are 16 NP floats a thread each (48 at Dh = 192
//    with the cluster's halves), beside S^T and dP^T (X / 2 each) and one
//    product's A fragments (X), so one consumer warpgroup holds them
//    without the bf16 route's split into two warpgroups: dV's product is waited on
//    before dS^T is split for dK's, so two tiles of A fragments are never
//    live together.
// 4. S = 1 gives dq = dk = 0 exactly (the plain backward does: out = v_0,
//    dout . v_0 = D). D is summed as dP and dP^T are: the diagonal of
//    dO.O^T on wgmma with the same tf32x3 terms in the same order
//    (hi.hi, dO_hi.(O or V)_lo, dO_lo.(O or V)_hi), the same k slices and
//    the same n (X) as dq's dP and dkdv's dP^T (which takes V as A and dO
//    as B, its terms ordered to match); with the cluster, per half and
//    then added as the halves are. Where out == v, dP - D is 0 and so is
//    dS.
// 5. No fallback: the wrapper (kernels/flash_attention.py::
//    flash_bwd_route) picks this route before any launch for float32
//    with Dh % 8 == 0, Dh <= 192 and all five tensors 16-byte aligned;
//    a failed launch raises.
// 6. The tensor cores' own float32 sums are not float32's round to
//    nearest: dK and dV accumulated in wgmma over a whole column of rows
//    (6,144 at smollm's S = 2,048, G = 3) erred up to 8e-5 of their
//    largest magnitude, growing with the rows a key sees. So each tile's
//    dV, dK and dQ product goes into a fresh accumulator (3 X / 8
//    products) that is added into the running sum in float32 (tile_rs),
//    as the forward's P.V is at NP <= 4: the errors fell to 1-2e-6.
//
// Rows a tile does not hold (X % G, positions past S) are zero in shared
// memory (the stages are zeroed once; TMA's zero fill) and carry lse =
// +inf, so their P and dS are exactly 0 without a test; panels wholly
// past Dh are never loaded and stay zero.
//
// Instantiations (NP panels of 32 columns a block x H blocks a cluster;
// 160 threads; nvcc -Xptxas -v, CUDA 12.8, on an H100; shared memory
// from the *_smem functions; blocks an SM by shared memory and
// registers):
//
//   kernel  Dh       NP x H  tile  stages  regs  spills  shared mem  blocks/SM
//   stats   8-32     1 x 1   64    2         80  0 B      42,016 B   5
//   stats   40-64    2 x 1   64    2         80  0 B      82,976 B   2
//   stats   72-128   4 x 2   64    2        117  0 B     164,896 B   1
//   stats   136-192  6 x 2   64    1        163  0 B     197,648 B   1
//   dkdv    8-32     1 x 1   64    2        252  0 B     116,800 B   1
//   dkdv    40-64    2 x 1   64    2        255  0 B     231,488 B   1
//   dkdv    72-128   2 x 2   32    2        211  0 B     181,824 B   1
//   dkdv    136-192  3 x 2   32    1        247  0 B     230,704 B   1
//   dq      8-32     1 x 1   64    2        128  0 B      99,392 B   2
//   dq      40-64    2 x 1   64    2        154  0 B     197,696 B   1
//   dq      72-128   2 x 2   32    2        124  0 B     164,928 B   1
//   dq      136-192  3 x 2   32    2        152  0 B     230,464 B   1
//
// (stats' tile is its K tile; dkdv's its Q/dO tile of rows; dq's its K/V
// tile of keys. "stats" has no cluster: H is the halves D is summed in.)
#include "attention.cuh"
#include "flash_bwd.cuh"
#include "hopper.cuh"

namespace {

using flash_bwd::KeyBlock;
using flash_bwd::RowBlock;
using flash_bwd::row_of;
using hopper::align1024;

constexpr int kConsumers = 128;                // one warpgroup
constexpr int kThreads = kConsumers + 32;      // + the producer warp
constexpr uint32_t kRow = hopper::kRowBytes;   // 32 float32 columns
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;            // an H100 block's

// Rows (keys) a streamed tile: 64 in one block, 32 with the cluster.
template <int H>
__host__ __device__ constexpr int tile_rows() {
  return H == 1 ? 64 : 32;
}

// Panels of 32 columns from column c0 that hold any column below dh, at
// most NP (TMA never loads a panel wholly past Dh).
template <int NP>
__device__ __forceinline__ int live_panels(int dh, int c0) {
  return min(NP, (dh - c0 + 31) / 32);
}

// A resident 64-row image pair (hi, lo) of NP panels from global rows
// row_idx(r) (-1: a zero row) of `src` ([.., dh] rows), columns c0 ..
// c0 + 32 NP - 1 (zero past dh): loaded, split and swizzled by the
// consumers. The caller fences for the async proxy and syncs.
template <int NP, typename RowIdx>
__device__ __forceinline__ void load_split(uint8_t* hi, uint8_t* lo,
                                           const float* __restrict__ src,
                                           RowIdx row_idx, int c0, int dh,
                                           int tid) {
#pragma unroll 4
  for (int i = tid; i < 64 * NP * 8; i += kConsumers) {
    const int r = i / (NP * 8), c4 = i - r * (NP * 8);
    const int col = c0 + 4 * c4;
    const long long row = row_idx(r);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= 0 && col < dh)
      v = *reinterpret_cast<const float4*>(src + row * dh + col);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint4 h, l;
    hopper::split4_tf32(x, h, l);
    const uint32_t off = 64 * kRow * (c4 >> 3) + hopper::swizzle128(r, c4 & 7);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// A landed tile of BYTES as tf32 hi (in place) and lo (same layout), all
// of a thread's loads in flight at once.
template <uint32_t BYTES>
__device__ __forceinline__ void split_inplace(uint8_t* raw, uint8_t* lo,
                                              int tid) {
  static_assert(BYTES % (16 * kConsumers) == 0, "whole rounds");
#pragma unroll
  for (int r = 0; r < static_cast<int>(BYTES / 16 / kConsumers); ++r) {
    const int i = tid + r * kConsumers;
    const float4 v = *reinterpret_cast<const float4*>(raw + 16 * i);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint4 h, l;
    hopper::split4_tf32(x, h, l);
    *reinterpret_cast<uint4*>(raw + 16 * i) = h;
    *reinterpret_cast<uint4*>(lo + 16 * i) = l;
  }
}

// The transposes of an R-row image pair of NP panels (hi, lo): [32 NP
// columns][R] in 128-byte swizzled rows, R / 32 panels of 32 reduced
// elements, each 8-element group in the order 0, 2, 4, 6, 1, 3, 5, 7
// (even elements in a slice's first 16-byte chunk, odd in its second).
template <int NP, int R>
__device__ __forceinline__ void transpose_pair(const uint8_t* hi,
                                               const uint8_t* lo,
                                               uint8_t* thi, uint8_t* tlo,
                                               int tid) {
  constexpr uint32_t kTPanel = 32 * NP * kRow;
  constexpr int kIters = 32 * NP * (R / 8) * 2 / kConsumers;
  static_assert(kIters * kConsumers == 32 * NP * (R / 8) * 2, "whole rounds");
#pragma unroll 2
  for (int it = 0; it < kIters; ++it) {
    const int i = tid + it * kConsumers;
    const int d = i % (32 * NP), rest = i / (32 * NP);
    const int par = rest & 1, sl = rest >> 1;
    const uint32_t src = (d >> 5) * R * kRow + 4 * (d & 3);
    const int c = (d & 31) >> 2;
    uint4 h, l;
    uint32_t* hp = &h.x;
    uint32_t* lp = &l.x;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t off = src + hopper::swizzle128(8 * sl + par + 2 * w, c);
      hp[w] = *reinterpret_cast<const uint32_t*>(hi + off);
      lp[w] = *reinterpret_cast<const uint32_t*>(lo + off);
    }
    const uint32_t dst = kTPanel * (sl >> 2) +
                         hopper::swizzle128(d, 2 * (sl & 3) + par);
    *reinterpret_cast<uint4*>(thi + dst) = h;
    *reinterpret_cast<uint4*>(tlo + dst) = l;
  }
}

// One wgmma m64nNk8, A and B from shared memory.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int scale_d) {
  if constexpr (N == 64)
    hopper::wgmma_m64n64k8_ss_tf32(d, a, b, scale_d);
  else
    hopper::wgmma_m64n32k8_ss_tf32(d, a, b, scale_d);
}

// One wgmma m64nNk8, A from registers.
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  if constexpr (N == 32)
    hopper::wgmma_m64n32k8_rs_tf32(d, a, b, scale_d);
  else if constexpr (N == 64)
    hopper::wgmma_m64n64k8_rs_tf32(d, a, b, scale_d);
  else
    hopper::wgmma_m64n96k8_rs_tf32(d, a, b, scale_d);
}

// d = A.B^T over NP panels (4 NP k8 slices): A a 64-row image pair, B an
// N-row one (N = 64 or 32; `a_panel` / `b_panel` bytes a panel), three
// products a slice: hi.hi, then A_hi.B_lo and A_lo.B_hi, in that order
// unless kLoFirst (then A_lo.B_hi first). d is overwritten (scale_d = 0 on
// the first). Issues the wgmmas; the caller fences and commits.
template <int N, int NP, bool kLoFirst>
__device__ __forceinline__ void chain_ss(float (&d)[N / 2], uint8_t* a_hi,
                                         uint8_t* a_lo, uint8_t* b_hi,
                                         uint8_t* b_lo, uint32_t a_panel,
                                         uint32_t b_panel) {
  const uint64_t ah = hopper::desc128(a_hi, 16, 1024);
  const uint64_t al = hopper::desc128(a_lo, 16, 1024);
  const uint64_t bh = hopper::desc128(b_hi, 16, 1024);
  const uint64_t bl = hopper::desc128(b_lo, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4 * NP; ++kk) {
    // a slice's descriptor is its tile's plus the slice's byte offset / 16
    // (the start-address field; shared addresses stay below 2^18)
    const uint32_t oa = (a_panel * (kk >> 2) + 32 * (kk & 3)) >> 4;
    const uint32_t ob = (b_panel * (kk >> 2) + 32 * (kk & 3)) >> 4;
    mma_ss<N>(d, ah + oa, bh + ob, kk > 0);
    if constexpr (kLoFirst) {
      mma_ss<N>(d, al + oa, bh + ob, 1);
      mma_ss<N>(d, ah + oa, bl + ob, 1);
    } else {
      mma_ss<N>(d, ah + oa, bl + ob, 1);
      mma_ss<N>(d, al + oa, bh + ob, 1);
    }
  }
}

// An accumulator tile of R reduced columns (X's layout: this thread's
// rows g, g + 8 at columns 8 j + 2c + {0, 1}) as tf32 A fragments hi and
// lo: slice kk holds (g, 8kk + 2c), (g + 8, ..), (g, 8kk + 2c + 1),
// (g + 8, ..) as its logical columns c, c, c + 4, c + 4.
template <int R>
__device__ __forceinline__ void to_frags(const float (&x)[R / 2],
                                         uint32_t (&h)[R / 8][4],
                                         uint32_t (&l)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    hopper::split_tf32(x[4 * kk], h[kk][0], l[kk][0]);
    hopper::split_tf32(x[4 * kk + 2], h[kk][1], l[kk][1]);
    hopper::split_tf32(x[4 * kk + 1], h[kk][2], l[kk][2]);
    hopper::split_tf32(x[4 * kk + 3], h[kk][3], l[kk][3]);
  }
}

// Keeps the compiler from writing A-fragment registers (or moving their
// reads) across the wgmma_wait_all that ends the products reading them.
template <int R>
__device__ __forceinline__ void fence_frags(uint32_t (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// One tile's X.B over R reduced elements into `t`, then added into the
// running sum `acc` in float32: X as A fragments (to_frags), B the
// transposed image pair (transpose_pair) of NP panels, N = 32 NP. A
// fresh accumulator a tile keeps the tensor cores' own float32 sums to
// one tile's 3 R / 8 products: along a whole row of 2,048 keys (6,144
// rows for dk and dv at G = 3) they missed 2e-5 (its rounding is not
// float32's nearest).
template <int NP, int R>
__device__ __forceinline__ void tile_rs(float (&acc)[16 * NP],
                                        uint32_t (&xh)[R / 8][4],
                                        uint32_t (&xl)[R / 8][4],
                                        uint8_t* t_hi, uint8_t* t_lo) {
  constexpr uint32_t kTPanel = 32 * NP * kRow;
  const uint64_t th = hopper::desc128(t_hi, 16, 1024);
  const uint64_t tl = hopper::desc128(t_lo, 16, 1024);
  float t[16 * NP];
#pragma unroll
  for (int i = 0; i < 16 * NP; ++i) t[i] = 0.f;   // overwritten (scale 0)
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    const uint32_t o = (kTPanel * (kk >> 2) + 32 * (kk & 3)) >> 4;
    mma_rs<32 * NP>(t, xh[kk], th + o, kk > 0);
    mma_rs<32 * NP>(t, xh[kk], tl + o, 1);
    mma_rs<32 * NP>(t, xl[kk], th + o, 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
  hopper::fence_regs(t);
  fence_frags(xh);
  fence_frags(xl);
#pragma unroll
  for (int i = 0; i < 16 * NP; ++i) acc[i] += t[i];
}

// The two blocks of a cluster swap their partial S and dP (X / 2 floats
// each a thread) and both add mine + other's. Buffer t % 2 of a block
// receives the other block's partials of tile t; `full` completes when
// the other's 128 consumers stored them, `empty` (in the writer's block)
// when this block's 128 consumers read them.
struct Swap {
  float* buf;              // [2][X / 4 float4][128 threads] (local)
  uint64_t* full;          // [2]
  uint64_t* empty;         // [2]
  uint32_t other;          // the other block's rank
};

template <int X>
__device__ __forceinline__ void swap_add(float (&s)[X / 2],
                                         float (&dp)[X / 2], const Swap& sw,
                                         int t, int u) {
  const int b = t & 1;
  float4* mine = reinterpret_cast<float4*>(sw.buf) + b * (X / 4) * kConsumers;
  // the other block has read what this thread wrote into its buffer b
  // two tiles ago
  if (t >= 2) hopper::mbar_wait_cluster(&sw.empty[b], ((t >> 1) - 1) & 1);
  const uint32_t dst = hopper::map_rank(hopper::smem_u32(mine), sw.other);
#pragma unroll
  for (int q = 0; q < X / 8; ++q) {
    hopper::st_cluster_f4(dst + 16 * (q * kConsumers + u), s[4 * q],
                          s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
    hopper::st_cluster_f4(dst + 16 * ((X / 8 + q) * kConsumers + u),
                          dp[4 * q], dp[4 * q + 1], dp[4 * q + 2],
                          dp[4 * q + 3]);
  }
  hopper::mbar_arrive_cluster(
      hopper::map_rank(hopper::smem_u32(&sw.full[b]), sw.other));
  hopper::mbar_wait_cluster(&sw.full[b], (t >> 1) & 1);
#pragma unroll
  for (int q = 0; q < X / 8; ++q) {
    const float4 a = mine[q * kConsumers + u];
    const float4 c = mine[(X / 8 + q) * kConsumers + u];
    s[4 * q] += a.x;
    s[4 * q + 1] += a.y;
    s[4 * q + 2] += a.z;
    s[4 * q + 3] += a.w;
    dp[4 * q] += c.x;
    dp[4 * q + 1] += c.y;
    dp[4 * q + 2] += c.z;
    dp[4 * q + 3] += c.w;
  }
  hopper::mbar_arrive_cluster(
      hopper::map_rank(hopper::smem_u32(&sw.empty[b]), sw.other));
}

// Before a block of a cluster exits: the other block's last arrivals on
// this block's `empty` barriers (after n tiles) have landed.
__device__ __forceinline__ void swap_drain(const Swap& sw, int n) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int uses = (n - b + 1) / 2;      // tiles t < n with t % 2 == b
    if (uses > 0) hopper::mbar_wait_cluster(&sw.empty[b], (uses - 1) & 1);
  }
}

// Barrier setup of a block: the TMA ring (`full` counting `producers`
// arrivals, `empty` the consumers'), and with a cluster the swap's
// barriers; then every thread of the cluster syncs (the other block
// arrives on this block's barriers).
template <int H, int ST>
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              uint64_t* sw_full,
                                              uint64_t* sw_empty,
                                              int producers) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      hopper::mbar_init(&full[st], producers);
      hopper::mbar_init(&empty[st], kConsumers);
    }
    if constexpr (H == 2) {
      for (int b = 0; b < 2; ++b) {
        hopper::mbar_init(&sw_full[b], kConsumers);
        hopper::mbar_init(&sw_empty[b], kConsumers);
      }
    }
    hopper::fence_barrier_init();
  }
  if constexpr (H == 2)
    hopper::cluster_sync();
  else
    __syncthreads();
}

// Zero `bytes` of shared memory (every thread of the block).
__device__ __forceinline__ void zero_smem(uint8_t* p, uint32_t bytes) {
  for (uint32_t i = threadIdx.x; i < bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
}

// The lane's (row0, row1) of the m64 accumulator layout and its column
// offset 2 (lane % 4).
struct Lanes {
  int row0, row1, col;
  __device__ explicit Lanes(int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    row0 = 16 * warp + (lane >> 2);
    row1 = row0 + 8;
    col = 2 * (lane & 3);
  }
};

// -- lse (log2 domain) and D of every row --------------------------------
// NPT panels of Dh in all; D summed in H halves of NPT / H panels, each
// as the dk/dv and dq kernels sum their dP over one block's panels.
template <int NPT, int H>
struct StatsCfg {
  static constexpr int kStages = NPT <= 4 ? 2 : 1;
  static constexpr uint32_t kImage = 64 * kRow * NPT;   // 64 rows, all Dh
};

template <int NPT, int H>
constexpr size_t stats_smem() {
  using C = StatsCfg<NPT, H>;
  return 1024 + (C::kStages + 3) * C::kImage + 2 * C::kStages * 8;
}

template <int NPT, int H>
__global__ void __launch_bounds__(kThreads, 1)
stats_kernel(const __grid_constant__ CUtensorMap tmap_k,
             const float* __restrict__ q, const float* __restrict__ out,
             const float* __restrict__ dout, float* __restrict__ lse,
             float* __restrict__ dvec, int B, int S, int kvh, int g, int dh,
             int bq, float scale_log2) {
  using C = StatsCfg<NPT, H>;
  constexpr int NP = NPT / H, X = tile_rows<H>(), ST = C::kStages;
  constexpr uint32_t QI = C::kImage, RI = 64 * kRow * NP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qhi = align1024(smem_raw);
  uint8_t* qlo = qhi + QI;
  uint8_t* k_s = qlo + QI;                     // [ST] K tiles, hi in place
  uint8_t* klo = k_s + ST * QI;
  uint64_t* full = reinterpret_cast<uint64_t*>(klo + QI);
  uint64_t* empty = full + ST;
  const RowBlock blk(static_cast<int>(blockIdx.x), B, S, kvh, g, bq);
  const int b = blk.b, h = blk.h, s0 = blk.s0, n_rows = blk.n_rows;
  const int n_tiles = (s0 + n_rows / g + 63) / 64;
  const int tid = threadIdx.x;

  zero_smem(k_s, ST * QI);
  init_barriers<1, ST>(full, empty, nullptr, nullptr, 1);

  if (tid >= kConsumers) {                 // the producer warp
    if (tid == kConsumers) {
      const int live = live_panels<NPT>(dh, 0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST, round = j / ST;
        if (round > 0) hopper::mbar_wait(&empty[st], (round - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[st], live * 64 * kRow);
        for (int p = 0; p < live; ++p)
          hopper::tma_load_4d(k_s + QI * st + 64 * kRow * p, &tmap_k,
                              &full[st], 32 * p, h, j * 64, b);
      }
    }
    return;
  }

  auto rows = [&](int r) -> long long {
    return r < n_rows ? row_of(b, S, kvh, h, g, s0, r) : -1;
  };
  load_split<NPT>(qhi, qlo, q, rows, 0, dh, tid);
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, kConsumers);

  const Lanes ln(tid);
  const int pos0 = s0 + ln.row0 / g, pos1 = s0 + ln.row1 / g;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % ST;
    hopper::mbar_wait(&full[st], (j / ST) & 1);
    // every warp's products of the last tile are done: K_lo is free
    hopper::named_barrier_sync(1, kConsumers);
    split_inplace<QI>(k_s + QI * st, klo, tid);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1, kConsumers);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hopper::wgmma_fence();
    chain_ss<64, NPT, false>(s, qhi, qlo, k_s + QI * st, klo, 64 * kRow,
                             64 * kRow);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);
    hopper::mbar_arrive(&empty[st]);   // stage st's K is read

    const bool diag = j * 64 + 63 > s0;  // some key > some row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = j * 64 + 8 * (i >> 2) + ln.col + (i & 1);
      const bool lo = (i & 2) == 0;
      float x = s[i] * scale_log2;
      if (diag && key > (lo ? pos0 : pos1)) x = -INFINITY;
      s[i] = x;
      if (lo) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ms0 = isfinite(mn0) ? mn0 : 0.f;
    const float ms1 = isfinite(mn1) ? mn1 : 0.f;
    const float c0 = isfinite(m0) ? exp2f(m0 - ms0) : 0.f;
    const float c1 = isfinite(m1) ? exp2f(m1 - ms1) : 0.f;
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - ((i & 2) == 0 ? ms0 : ms1));
      if ((i & 2) == 0) sum0 += p;
      else sum1 += p;
    }
    l0 = l0 * c0 + sum0;          // this thread's columns; summed below
    l1 = l1 * c1 + sum1;
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }

  // D = the diagonal of dO.O^T, half by half as dP is summed (the same
  // terms, slices and n = X); row r's entry sits in the quad lane whose
  // columns hold r, (r % 8) / 2. Shared memory is free again: every
  // tile was waited on.
  uint8_t* dohi = qhi;
  uint8_t* dolo = dohi + RI;
  uint8_t* ohi = dolo + RI;
  uint8_t* olo = ohi + RI;
  const int lane = tid & 31;
  const int src0 = (lane & ~3) | ((ln.row0 & 7) >> 1);
  const int src1 = (lane & ~3) | ((ln.row1 & 7) >> 1);
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int half = 0; half < H; ++half) {
    hopper::named_barrier_sync(1, kConsumers);   // the last reads are done
    load_split<NP>(dohi, dolo, dout, rows, 32 * NP * half, dh, tid);
    load_split<NP>(ohi, olo, out, rows, 32 * NP * half, dh, tid);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1, kConsumers);
    float e0 = 0.f, e1 = 0.f;
#pragma unroll
    for (int c = 0; c < 64 / X; ++c) {           // O's rows c X .. c X + X - 1
      float dd[X / 2];
#pragma unroll
      for (int i = 0; i < X / 2; ++i) dd[i] = 0.f;
      hopper::wgmma_fence();
      chain_ss<X, NP, false>(dd, dohi, dolo, ohi + c * X * kRow,
                             olo + c * X * kRow, 64 * kRow, 64 * kRow);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(dd);
#pragma unroll
      for (int i = 0; i < X / 2; ++i) {
        const int cc = c * X + 8 * (i >> 2) + ln.col + (i & 1);
        if ((i & 2) == 0 && cc == ln.row0) e0 = dd[i];
        if ((i & 2) != 0 && cc == ln.row1) e1 = dd[i];
      }
    }
    e0 = __shfl_sync(0xffffffffu, e0, src0);
    e1 = __shfl_sync(0xffffffffu, e1, src1);
    d0 = half == 0 ? e0 : d0 + e0;
    d1 = half == 0 ? e1 : d1 + e1;
  }
  // key 0 is visible to every row: m finite, l >= 1
  if ((lane & 3) == 0) {
    if (ln.row0 < n_rows) {
      const long long idx = row_of(b, S, kvh, h, g, s0, ln.row0);
      lse[idx] = m0 + log2f(l0);
      dvec[idx] = d0;
    }
    if (ln.row1 < n_rows) {
      const long long idx = row_of(b, S, kvh, h, g, s0, ln.row1);
      lse[idx] = m1 + log2f(l1);
      dvec[idx] = d1;
    }
  }
}

// -- dk and dv: one block (or cluster) a 64-key block ----------------------
template <int NP, int H>
struct DkdvCfg {
  static constexpr int kX = tile_rows<H>();            // rows a Q/dO tile
  static constexpr int kStages = NP == 3 ? 1 : 2;
  static constexpr uint32_t kRes = 64 * kRow * NP;     // K or V, hi or lo
  static constexpr uint32_t kTile = kX * kRow * NP;    // a Q/dO tile image
  static constexpr uint32_t kSwapBytes = H == 2 ? 2 * kX * kConsumers * 4 : 0;
};

template <int NP, int H>
constexpr size_t dkdv_smem() {
  using C = DkdvCfg<NP, H>;
  return 1024 + 4 * C::kRes + (2 * C::kStages + 6) * C::kTile + C::kSwapBytes +
         C::kStages * 2 * C::kX * 4 + (2 * C::kStages + 4) * 8;
}

template <int NP, int H>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tmap_q,
            const __grid_constant__ CUtensorMap tmap_do,
            const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ lse, const float* __restrict__ dvec,
            float* __restrict__ dk, float* __restrict__ dv, int B, int S,
            int kvh, int g, int dh, int bq, float scale_log2, float scale) {
  using C = DkdvCfg<NP, H>;
  constexpr int X = C::kX, ST = C::kStages;
  constexpr uint32_t RI = C::kRes, TI = C::kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* khi = align1024(smem_raw);
  uint8_t* klo = khi + RI;
  uint8_t* vhi = klo + RI;
  uint8_t* vlo = vhi + RI;
  uint8_t* q_s = vlo + RI;                   // [ST] Q tiles, hi in place
  uint8_t* do_s = q_s + ST * TI;             // [ST] dO tiles, hi in place
  uint8_t* qlo = do_s + ST * TI;
  uint8_t* dolo = qlo + TI;
  uint8_t* qthi = dolo + TI;                 // the transposes
  uint8_t* qtlo = qthi + TI;
  uint8_t* dothi = qtlo + TI;
  uint8_t* dotlo = dothi + TI;
  float* swap_buf = reinterpret_cast<float*>(dotlo + TI);
  float* stat = reinterpret_cast<float*>(dotlo + TI + C::kSwapBytes);  // [ST][2X]
  uint64_t* full = reinterpret_cast<uint64_t*>(stat + ST * 2 * X);
  uint64_t* empty = full + ST;
  uint64_t* sw_full = empty + ST;
  uint64_t* sw_empty = sw_full + 2;
  const int rank = H == 2 ? static_cast<int>(hopper::cluster_ctarank()) : 0;
  const KeyBlock blk(static_cast<int>(blockIdx.x) / H, B, S, kvh, bq);
  const int b = blk.b, h = blk.h, j0 = blk.j0, n_qt = blk.n_qt;
  const int c0 = 32 * NP * rank;             // this block's first column
  const int tid = threadIdx.x;

  zero_smem(q_s, 2 * ST * TI);
  init_barriers<H, ST>(full, empty, sw_full, sw_empty, 32);

  if (tid >= kConsumers) {                 // the producer warp
    const int lane = tid - kConsumers;
    const int rows = bq * g;
    const int live = live_panels<NP>(dh, c0);
    for (int t = 0; t < n_qt; ++t) {
      const int st = t % ST, round = t / ST;
      const int p0 = j0 + t * bq;
      if (round > 0) hopper::mbar_wait(&empty[st], (round - 1) & 1);
      float* ls = stat + st * 2 * X;
#pragma unroll
      for (int r = lane; r < X; r += 32) {
        const bool valid = r < rows && p0 + r / g < S;
        const long long idx = valid ? row_of(b, S, kvh, h, g, p0, r) : 0;
        ls[r] = valid ? lse[idx] : INFINITY;      // P = 0 in absent rows
        ls[X + r] = valid ? dvec[idx] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[st], 2 * live * kRow * rows);
        for (int p = 0; p < live; ++p) {
          hopper::tma_load_5d(q_s + TI * st + X * kRow * p, &tmap_q,
                              &full[st], c0 + 32 * p, 0, h, p0, b);
          hopper::tma_load_5d(do_s + TI * st + X * kRow * p, &tmap_do,
                              &full[st], c0 + 32 * p, 0, h, p0, b);
        }
      } else {
        hopper::mbar_arrive(&full[st]);
      }
    }
    return;
  }

  auto keys = [&](int r) -> long long {
    return j0 + r < S
               ? (static_cast<long long>(b) * S + j0 + r) * kvh + h
               : -1;
  };
  load_split<NP>(khi, klo, k, keys, c0, dh, tid);
  load_split<NP>(vhi, vlo, v, keys, c0, dh, tid);
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, kConsumers);

  // This thread's two keys (rows of the m64 accumulator) and its columns
  // 8 jn + col + {0, 1} (tile rows) of every n8 block jn.
  const Lanes ln(tid);
  const int key0 = j0 + ln.row0, col = ln.col;
  const Swap sw{swap_buf, sw_full, sw_empty, static_cast<uint32_t>(rank ^ 1)};
  float acc_k[16 * NP], acc_v[16 * NP];
#pragma unroll
  for (int i = 0; i < 16 * NP; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int t = 0; t < n_qt; ++t) {
    const int st = t % ST;
    const int p0 = j0 + t * bq;
    hopper::mbar_wait(&full[st], (t / ST) & 1);
    uint8_t* qhi = q_s + TI * st;
    uint8_t* dohi = do_s + TI * st;
    const float* ls = stat + st * 2 * X;
    // every warp's products of the last tile are done: the lo parts and
    // the transposes are free
    hopper::named_barrier_sync(1, kConsumers);
    split_inplace<TI>(qhi, qlo, tid);
    split_inplace<TI>(dohi, dolo, tid);
    hopper::named_barrier_sync(1, kConsumers);
    transpose_pair<NP, X>(qhi, qlo, qthi, qtlo, tid);
    transpose_pair<NP, X>(dohi, dolo, dothi, dotlo, tid);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1, kConsumers);

    float s[X / 2], dp[X / 2];
#pragma unroll
    for (int i = 0; i < X / 2; ++i) s[i] = dp[i] = 0.f;
    hopper::wgmma_fence();
    // S^T = K.Q^T; dP^T = V.dO^T with its terms in dP's order
    chain_ss<X, NP, false>(s, khi, klo, qhi, qlo, 64 * kRow, X * kRow);
    chain_ss<X, NP, true>(dp, vhi, vlo, dohi, dolo, 64 * kRow, X * kRow);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    if constexpr (H == 2) swap_add<X>(s, dp, sw, t, tid);

    // P^T (keys key0, key0 + 8; tile rows 8 jn + col + {0, 1}) and dS^T =
    // P^T (dP^T - D); row c (position p0 + c / g) sees key j iff
    // c >= (j - p0) g
    const bool diag = p0 < j0 + 63;
    const int lim0 = (key0 - p0) * g, lim1 = lim0 + 8 * g;
#pragma unroll
    for (int jn = 0; jn < X / 8; ++jn) {
      const int c = 8 * jn + col;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
      const float2 d2 = *reinterpret_cast<const float2*>(ls + X + c);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 4 * jn + x;
        float p = exp2f(s[i] * scale_log2 - ((x & 1) ? l2.y : l2.x));
        if (diag && c + (x & 1) < (x >= 2 ? lim1 : lim0)) p = 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - ((x & 1) ? d2.y : d2.x));
      }
    }
    hopper::mbar_arrive(&empty[st]);   // stage st (tiles, lse, D) is read

    uint32_t xh[X / 8][4], xl[X / 8][4];
    to_frags<X>(s, xh, xl);
    tile_rs<NP, X>(acc_v, xh, xl, dothi, dotlo);    // dV += P^T.dO
    hopper::fence_regs(dp);            // dS^T's split stays below dV's wait
    to_frags<X>(dp, xh, xl);
    tile_rs<NP, X>(acc_k, xh, xl, qthi, qtlo);      // dK += dS^T.Q
  }
  if constexpr (H == 2) swap_drain(sw, n_qt);

  const int key1 = key0 + 8;
  const long long base0 = ((static_cast<long long>(b) * S + key0) * kvh + h) *
                          dh;
  const long long base1 = ((static_cast<long long>(b) * S + key1) * kvh + h) *
                          dh;
#pragma unroll
  for (int jn = 0; jn < 4 * NP; ++jn) {
    const int d = c0 + 8 * jn + col;
    if (d >= dh) continue;
    if (key0 < S) {
      *reinterpret_cast<float2*>(dk + base0 + d) =
          make_float2(acc_k[4 * jn] * scale, acc_k[4 * jn + 1] * scale);
      *reinterpret_cast<float2*>(dv + base0 + d) =
          make_float2(acc_v[4 * jn], acc_v[4 * jn + 1]);
    }
    if (key1 < S) {
      *reinterpret_cast<float2*>(dk + base1 + d) =
          make_float2(acc_k[4 * jn + 2] * scale, acc_k[4 * jn + 3] * scale);
      *reinterpret_cast<float2*>(dv + base1 + d) =
          make_float2(acc_v[4 * jn + 2], acc_v[4 * jn + 3]);
    }
  }
}

// -- dq: one block (or cluster) a block of 64 rows -------------------------
template <int NP, int H>
struct DqCfg {
  static constexpr int kX = tile_rows<H>();            // keys a K/V tile
  static constexpr int kStages = 2;
  static constexpr uint32_t kRes = 64 * kRow * NP;     // Q or dO, hi or lo
  static constexpr uint32_t kTile = kX * kRow * NP;    // a K/V tile image
  static constexpr uint32_t kSwapBytes = H == 2 ? 2 * kX * kConsumers * 4 : 0;
};

template <int NP, int H>
constexpr size_t dq_smem() {
  using C = DqCfg<NP, H>;
  return 1024 + 4 * C::kRes + (2 * C::kStages + 4) * C::kTile + C::kSwapBytes +
         (2 * C::kStages + 4) * 8;
}

template <int NP, int H>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tmap_k,
          const __grid_constant__ CUtensorMap tmap_v,
          const float* __restrict__ q, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dvec,
          float* __restrict__ dq, int B, int S, int kvh, int g, int dh,
          int bq, float scale_log2, float scale) {
  using C = DqCfg<NP, H>;
  constexpr int X = C::kX, ST = C::kStages;
  constexpr uint32_t RI = C::kRes, TI = C::kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qhi = align1024(smem_raw);
  uint8_t* qlo = qhi + RI;
  uint8_t* dohi = qlo + RI;
  uint8_t* dolo = dohi + RI;
  uint8_t* k_s = dolo + RI;                  // [ST] K tiles, hi in place
  uint8_t* v_s = k_s + ST * TI;              // [ST] V tiles, hi in place
  uint8_t* klo = v_s + ST * TI;
  uint8_t* vlo = klo + TI;
  uint8_t* kthi = vlo + TI;                  // K's transposes
  uint8_t* ktlo = kthi + TI;
  float* swap_buf = reinterpret_cast<float*>(ktlo + TI);
  uint64_t* full = reinterpret_cast<uint64_t*>(ktlo + TI + C::kSwapBytes);
  uint64_t* empty = full + ST;
  uint64_t* sw_full = empty + ST;
  uint64_t* sw_empty = sw_full + 2;
  const int rank = H == 2 ? static_cast<int>(hopper::cluster_ctarank()) : 0;
  const RowBlock blk(static_cast<int>(blockIdx.x) / H, B, S, kvh, g, bq);
  const int b = blk.b, h = blk.h, s0 = blk.s0, n_rows = blk.n_rows;
  const int n_tiles = (s0 + n_rows / g + X - 1) / X;
  const int c0 = 32 * NP * rank;
  const int tid = threadIdx.x;

  zero_smem(k_s, 2 * ST * TI);
  init_barriers<H, ST>(full, empty, sw_full, sw_empty, 1);

  if (tid >= kConsumers) {                 // the producer warp
    if (tid == kConsumers) {
      const int live = live_panels<NP>(dh, c0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST, round = j / ST;
        if (round > 0) hopper::mbar_wait(&empty[st], (round - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[st], 2 * live * X * kRow);
        for (int p = 0; p < live; ++p) {
          hopper::tma_load_4d(k_s + TI * st + X * kRow * p, &tmap_k,
                              &full[st], c0 + 32 * p, h, j * X, b);
          hopper::tma_load_4d(v_s + TI * st + X * kRow * p, &tmap_v,
                              &full[st], c0 + 32 * p, h, j * X, b);
        }
      }
    }
    return;
  }

  auto rows = [&](int r) -> long long {
    return r < n_rows ? row_of(b, S, kvh, h, g, s0, r) : -1;
  };
  load_split<NP>(qhi, qlo, q, rows, c0, dh, tid);
  load_split<NP>(dohi, dolo, dout, rows, c0, dh, tid);

  const Lanes ln(tid);
  const int pos0 = s0 + ln.row0 / g, pos1 = s0 + ln.row1 / g;
  const int col = ln.col;
  // absent rows: lse = +inf, so P = dS = 0
  const long long idx0 = rows(ln.row0), idx1 = rows(ln.row1);
  const float lse0 = idx0 >= 0 ? lse[idx0] : INFINITY;
  const float lse1 = idx1 >= 0 ? lse[idx1] : INFINITY;
  const float d0 = idx0 >= 0 ? dvec[idx0] : 0.f;
  const float d1 = idx1 >= 0 ? dvec[idx1] : 0.f;
  const Swap sw{swap_buf, sw_full, sw_empty, static_cast<uint32_t>(rank ^ 1)};
  float acc[16 * NP];
#pragma unroll
  for (int i = 0; i < 16 * NP; ++i) acc[i] = 0.f;
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, kConsumers);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % ST;
    hopper::mbar_wait(&full[st], (j / ST) & 1);
    uint8_t* khi = k_s + TI * st;
    uint8_t* vhi = v_s + TI * st;
    // every warp's dQ product of the last tile is done: the lo parts and
    // K's transposes are free
    hopper::named_barrier_sync(1, kConsumers);
    split_inplace<TI>(khi, klo, tid);
    split_inplace<TI>(vhi, vlo, tid);
    hopper::named_barrier_sync(1, kConsumers);
    transpose_pair<NP, X>(khi, klo, kthi, ktlo, tid);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1, kConsumers);

    float s[X / 2], dp[X / 2];
#pragma unroll
    for (int i = 0; i < X / 2; ++i) s[i] = dp[i] = 0.f;
    hopper::wgmma_fence();
    chain_ss<X, NP, false>(s, qhi, qlo, khi, klo, 64 * kRow, X * kRow);
    chain_ss<X, NP, false>(dp, dohi, dolo, vhi, vlo, 64 * kRow, X * kRow);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::mbar_arrive(&empty[st]);   // stage st's K and V are read
    if constexpr (H == 2) swap_add<X>(s, dp, sw, j, tid);

    const bool diag = j * X + X - 1 > s0;  // some key > some row
#pragma unroll
    for (int i = 0; i < X / 2; ++i) {
      const int key = j * X + 8 * (i >> 2) + col + (i & 1);
      const bool lo = (i & 2) == 0;
      float p = exp2f(s[i] * scale_log2 - (lo ? lse0 : lse1));
      if (diag && key > (lo ? pos0 : pos1)) p = 0.f;
      s[i] = p * (dp[i] - (lo ? d0 : d1));          // dS
    }
    uint32_t xh[X / 8][4], xl[X / 8][4];
    to_frags<X>(s, xh, xl);
    tile_rs<NP, X>(acc, xh, xl, kthi, ktlo);        // dQ += dS.K
  }
  if constexpr (H == 2) swap_drain(sw, n_tiles);

#pragma unroll
  for (int jn = 0; jn < 4 * NP; ++jn) {
    const int d = c0 + 8 * jn + col;
    if (d >= dh) continue;
    if (idx0 >= 0)
      *reinterpret_cast<float2*>(dq + idx0 * dh + d) =
          make_float2(acc[4 * jn] * scale, acc[4 * jn + 1] * scale);
    if (idx1 >= 0)
      *reinterpret_cast<float2*>(dq + idx1 * dh + d) =
          make_float2(acc[4 * jn + 2] * scale, acc[4 * jn + 3] * scale);
  }
}

static_assert(stats_smem<1, 1>() == 42016 && stats_smem<2, 1>() == 82976 &&
                  stats_smem<4, 2>() == 164896 &&
                  stats_smem<6, 2>() == 197648,
              "the header's table");
static_assert(dkdv_smem<1, 1>() == 116800 && dkdv_smem<2, 1>() == 231488 &&
                  dkdv_smem<2, 2>() == 181824 && dkdv_smem<3, 2>() == 230704,
              "the header's table");
static_assert(dq_smem<1, 1>() == 99392 && dq_smem<2, 1>() == 197696 &&
                  dq_smem<2, 2>() == 164928 && dq_smem<3, 2>() == 230464,
              "the header's table");
static_assert(dkdv_smem<2, 1>() <= kMaxSmem && dkdv_smem<3, 2>() <= kMaxSmem &&
                  dq_smem<3, 2>() <= kMaxSmem,
              "every instantiation must fit an H100 block's shared memory");

// -- launches -----------------------------------------------------------------
// One launch of `kernel` on `blocks` blocks of kThreads, as clusters of H
// (the cluster dimension a launch attribute); `args` exactly the kernel's
// parameter types (tensor maps, pointers, int, float), passed by address.
template <int H, typename Kernel, typename... Args>
int launch(Kernel kernel, unsigned blocks, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t e = attn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = H;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = H > 1 ? 1 : 0;
  void* argv[] = {static_cast<void*>(&args)...};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), argv);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

inline unsigned row_blocks(int B, int S, int kvh, int bq) {
  return static_cast<unsigned>(static_cast<long long>(B) * kvh *
                               ((S + bq - 1) / bq));
}

template <int NPT, int H>
int stats_cfg(const float* q, const float* k, const float* out,
              const float* dout, float* lse, float* dvec, int B, int S,
              int kvh, int g, int dh, float scale, cudaStream_t stream) {
  const int bq = 64 / g;
  CUtensorMap tmap_k;
  const int err = hopper::encode_bshd_f32(&tmap_k, k, B, S, kvh, dh, 64);
  if (err != 0) return err;
  return launch<1>(stats_kernel<NPT, H>, row_blocks(B, S, kvh, bq),
                   stats_smem<NPT, H>(), stream, tmap_k, q, out, dout, lse,
                   dvec, B, S, kvh, g, dh, bq, scale * kLog2e);
}

template <int NP, int H>
int dkdv_cfg(const float* q, const float* k, const float* v,
             const float* dout, const float* lse, const float* dvec,
             float* dk, float* dv, int B, int S, int kvh, int g, int dh,
             float scale, cudaStream_t stream) {
  const int bq = DkdvCfg<NP, H>::kX / g;
  CUtensorMap tmap_q, tmap_do;
  int err = hopper::encode_bshgd_f32(&tmap_q, q, B, S, kvh, g, dh, bq);
  if (err == 0)
    err = hopper::encode_bshgd_f32(&tmap_do, dout, B, S, kvh, g, dh, bq);
  if (err != 0) return err;
  const unsigned blocks = static_cast<unsigned>(
      static_cast<long long>(H) * B * kvh * ((S + 63) / 64));
  return launch<H>(dkdv_kernel<NP, H>, blocks, dkdv_smem<NP, H>(), stream,
                   tmap_q, tmap_do, k, v, lse, dvec, dk, dv, B, S, kvh, g,
                   dh, bq, scale * kLog2e, scale);
}

template <int NP, int H>
int dq_cfg(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* dvec, float* dqo, int B, int S,
           int kvh, int g, int dh, float scale, cudaStream_t stream) {
  const int bq = 64 / g;
  constexpr int X = DqCfg<NP, H>::kX;
  CUtensorMap tmap_k, tmap_v;
  int err = hopper::encode_bshd_f32(&tmap_k, k, B, S, kvh, dh, X);
  if (err == 0) err = hopper::encode_bshd_f32(&tmap_v, v, B, S, kvh, dh, X);
  if (err != 0) return err;
  return launch<H>(dq_kernel<NP, H>, H * row_blocks(B, S, kvh, bq),
                   dq_smem<NP, H>(), stream, tmap_k, tmap_v, q, dout, lse,
                   dvec, dqo, B, S, kvh, g, dh, bq, scale * kLog2e, scale);
}

// The instantiation of a Dh: 0 (Dh <= 32: one panel), 1 (<= 64: two
// panels), 2 (<= 128: two panels a block, a cluster of two), 3 (<= 192:
// three panels a block, a cluster of two).
inline int config(int dh) {
  return dh <= 32 ? 0 : dh <= 64 ? 1 : dh <= 128 ? 2 : 3;
}

}  // namespace

// Plain C interface (loaded with ctypes), the other routes' signatures.
// Each function returns the cudaError_t of its launch (or
// hopper::kEncodeError + a CUresult); 0 means the launch was accepted.
// Shapes are checked by the Python wrapper: float32, 1 <= G <= 32,
// Dh % 8 == 0 and Dh <= 192, every tensor 16-byte aligned. lse (in the
// log2 domain) and dvec are float32 [B, S, KvH, G] scratch: written by
// the stats function, read by the other two.
extern "C" {

int flash_attention_causal_bwd_stats_f32_tf32x3(
    const float* q, const float* k, const float* out, const float* dout,
    float* lse, float* dvec, int B, int S, int kvh, int g, int dh,
    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config(dh)) {
    case 0:
      return stats_cfg<1, 1>(q, k, out, dout, lse, dvec, B, S, kvh, g, dh,
                             scale, s);
    case 1:
      return stats_cfg<2, 1>(q, k, out, dout, lse, dvec, B, S, kvh, g, dh,
                             scale, s);
    case 2:
      return stats_cfg<4, 2>(q, k, out, dout, lse, dvec, B, S, kvh, g, dh,
                             scale, s);
    default:
      return stats_cfg<6, 2>(q, k, out, dout, lse, dvec, B, S, kvh, g, dh,
                             scale, s);
  }
}

int flash_attention_causal_bwd_dkdv_f32_tf32x3(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* dvec, float* dk, float* dv, int B, int S,
    int kvh, int g, int dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config(dh)) {
    case 0:
      return dkdv_cfg<1, 1>(q, k, v, dout, lse, dvec, dk, dv, B, S, kvh, g,
                            dh, scale, s);
    case 1:
      return dkdv_cfg<2, 1>(q, k, v, dout, lse, dvec, dk, dv, B, S, kvh, g,
                            dh, scale, s);
    case 2:
      return dkdv_cfg<2, 2>(q, k, v, dout, lse, dvec, dk, dv, B, S, kvh, g,
                            dh, scale, s);
    default:
      return dkdv_cfg<3, 2>(q, k, v, dout, lse, dvec, dk, dv, B, S, kvh, g,
                            dh, scale, s);
  }
}

int flash_attention_causal_bwd_dq_f32_tf32x3(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* dvec, float* dqo, int B, int S, int kvh,
    int g, int dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config(dh)) {
    case 0:
      return dq_cfg<1, 1>(q, k, v, dout, lse, dvec, dqo, B, S, kvh, g, dh,
                          scale, s);
    case 1:
      return dq_cfg<2, 1>(q, k, v, dout, lse, dvec, dqo, B, S, kvh, g, dh,
                          scale, s);
    case 2:
      return dq_cfg<2, 2>(q, k, v, dout, lse, dvec, dqo, B, S, kvh, g, dh,
                          scale, s);
    default:
      return dq_cfg<3, 2>(q, k, v, dout, lse, dvec, dqo, B, S, kvh, g, dh,
                          scale, s);
  }
}

}  // extern "C"
