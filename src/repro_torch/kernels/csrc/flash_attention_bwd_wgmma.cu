// The backward of causal grouped-query flash attention on the tensor
// cores (bf16, Dh % 16 == 0, Dh <= 192), for sm_90a: dq, dk and dv of
// flash_attention.cu's function, the same function as
// flash_attention_bwd.cu's CUDA-core kernels compute (its header states
// it), in the same layout:
//
//   q, out, dout   [B, S, KvH, G, Dh] bf16   (query head h = kvh * G + g)
//   k, v           [B, S, KvH, Dh]    bf16
//   dq             [B, S, KvH, G, Dh],  dk, dv [B, S, KvH, Dh]   bf16
//
// The TPU side has no Pallas backward: the reference trains through the
// blockwise jnp attention XLA differentiates (src/repro/models/
// layers.py:114); the Pallas kernel of the forward is
// flash_attention_causal of src/repro/kernels/flash_attention.py
// (pallas_call at :88).
//
// What bounds it on an H100: operations. The causal backward needs about
// 10 Dh flops a (query head, key <= query) pair (S and dP recomputed, then
// dv, dk and dq); at the training shape (B = 8, S = 2048, KvH = 5, G = 3,
// Dh = 64) that is 161 GFLOP against ~0.1 ms of bytes, at MLA's (B = 2,
// S = 2048, KvH = 16, G = 1, Dh = 192) 129 GFLOP. The CUDA-core design
// computed them in float32 from shared memory at ~11 TFLOP/s, bound by
// shared-memory loads. This design puts every product on wgmma (bf16
// operands, float32 accumulators) and every tile load on TMA. Dh is
// held as NP = ceil(Dh / 64) panels of 64 columns (NP = 3 above 128);
// columns past Dh are TMA's zero fill, so nothing assumes the caller
// padded Dh:
//
// * stats_wgmma_kernel: one block per (b, kvh, tile of bq = 64 / G
//   positions: bq * G rows ordered (position, head), as the forward);
//   one producer warp streams 64-key K tiles by TMA into a ring of
//   kStages stages, one consumer warpgroup computes S = Q.K^T
//   (m64n64k16, Q and K from shared memory) and keeps the online max and
//   sum in registers, as the forward does without P.V. Writes each row's
//   lse in the log2 domain (log2 sum_j 2^(s_ij log2 e)) and D = dout . out
//   (the diagonal of dO.O^T on wgmma, summed as dP is), float32
//   [B, S, KvH, G].
// * dkdv_wgmma_kernel (NP = 1, 2): one block per (b, kvh, 64-key tile),
//   heaviest (the first keys) first. K and V stay in shared memory; Q,
//   dO, lse and D tiles of bq positions (the G heads of each) stream in
//   from a TMA ring (the producer warp writes lse and D beside each
//   tile). Per tile: S^T = K.Q^T and dP^T = V.dO^T (ss); P^T and dS^T =
//   P^T (dP^T - D) in registers, the causal mask as an index test;
//   dV += P^T.dO and dK += dS^T.Q with P^T and dS^T rounded to bf16 as the
//   register A operand and dO, Q read MN-major through the descriptor's
//   transpose, as the forward reads V. One consumer warpgroup holds
//   dK and dV (2 x 32 NP floats a thread) beside S^T and dP^T (32 each).
// * dkdv_split_kernel (NP = 3): the same block, ring and products, split
//   over two consumer warpgroups, because one cannot hold dK and dV at
//   Dh = 192 (96 + 96 + 32 + 32 = 256 floats a thread, over the 255
//   registers a thread may have). Warpgroup A computes S^T, forms P^T,
//   hands it to warpgroup B through shared memory and accumulates
//   dV += P^T.dO; warpgroup B computes dP^T, reads P^T, forms dS^T and
//   accumulates dK += dS^T.Q. Each holds one 96-float accumulator and
//   one 64 x 64 tile; no pair is computed twice (8 Dh flops a pair, as
//   at NP = 1, 2). P^T goes over in float32 (16 KB a tile, each thread
//   reading back the very elements its twin wrote), so dS^T is formed
//   from the same float32 P as at NP = 1, 2 and the route rounds the
//   same way at every Dh; two buffers (32 KB) let A run one tile ahead.
//   Named barriers guard them (A arrives "full" after writing and syncs
//   on "empty" before reusing a buffer; B syncs on "full" and arrives
//   "empty" after reading). Shared memory: K, V (6 panels) + the Q/dO
//   ring (18) = 196,608 B, lse/D 1,536 B, the P^T buffers 32,768 B, 7
//   mbarriers and 1,024 B of alignment slack: 231,992 of the 232,448 B
//   a block may have. Registers: 384 threads (the two consumer
//   warpgroups and a producer warpgroup, of which one warp loads) would
//   get 168 a thread, where the consumers spill; setmaxnreg gives the
//   producer warpgroup 56 and each consumer 224.
// * dq_wgmma_kernel: one block per (b, kvh, tile of bq positions),
//   heaviest (the last positions) first; Q and dO once by TMA, K and V
//   tiles streamed as in the forward: S = Q.K^T and dP = dO.V^T (ss),
//   dS in registers, dQ += dS.K (dS in registers, K MN-major). It
//   recomputes S and dP (6 of the 16 Dh flops it does a pair) so that it
//   needs no float atomics and no dq-sized scratch. At NP = 3 one
//   warpgroup holds dQ (96 floats) beside S and dP (32 each).
//
// Dh^-0.5 is applied in float32, to S (with log2 e, as exp2's argument)
// and to dK and dQ at the end. P and dS are rounded to bf16 for the three
// products: the only roundings the plain version does not make. No
// atomics and a fixed order everywhere, so two calls give the same bits.
// Rows a tile does not hold (bq * G < 64, positions past S) are zero in
// shared memory (TMA's zero fill, and a once-written zero tail) and carry
// lse = +inf, so their P and dS are exactly 0 without a test.
#include "attention.cuh"
#include "flash_bwd.cuh"
#include "hopper.cuh"

namespace {

using flash_bwd::KeyBlock;
using flash_bwd::RowBlock;
using flash_bwd::row_of;
using hopper::align1024;

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;          // keys a K/V tile; at most 64 rows a Q tile
constexpr int kStages = 3;         // ring depth
constexpr int kConsumers = 128;    // one warpgroup
constexpr int kThreads = kConsumers + 32;          // + the producer warp
constexpr uint32_t kPanel = 64 * hopper::kRowBytes;  // [64 rows][64 cols]
constexpr float kLog2e = 1.4426950408889634f;

// d (=) A . B^T over Dh (4 NP k16 slices): A and B 64-row K-major tiles of
// NP 64-column panels. Issues the wgmmas; the caller fences and commits.
template <int NP>
__device__ __forceinline__ void mma_ss(float (&d)[32], const uint8_t* a,
                                       const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4 * NP; ++kk) {
    const uint32_t off = kPanel * (kk >> 2) + 32 * (kk & 3);
    hopper::wgmma_m64n64k16_ss(d, hopper::desc128(a + off, 16, 1024),
                               hopper::desc128(b + off, 16, 1024), kk > 0);
  }
}

// A 64 x 64 accumulator tile as bf16 A fragments: slice kk holds its
// columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void to_a(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = hopper::pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// d += A . B over 64 rows of B: A in registers (to_a), B a 64-row tile of
// NP panels read MN-major (N = 64 NP columns).
template <int NP>
__device__ __forceinline__ void mma_rs(float (&d)[32 * NP],
                                       const uint32_t (&a)[4][4],
                                       const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = hopper::desc128(b + 16 * hopper::kRowBytes * kk,
                                          kPanel, hopper::kAtomBytes);
    if constexpr (NP == 1)
      hopper::wgmma_m64n64k16_rs_tb(d, a[kk], desc);
    else if constexpr (NP == 2)
      hopper::wgmma_m64n128k16_rs_tb(d, a[kk], desc);
    else
      hopper::wgmma_m64n192k16_rs_tb(d, a[kk], desc);
  }
}

// Zero rows [from, 64) of `n` consecutive tiles of NP panels (the
// `threads` consumer threads; the caller fences for the async proxy and
// syncs).
template <int NP, int threads = kConsumers>
__device__ __forceinline__ void zero_tail(uint8_t* tiles, int n, int from,
                                          int tid) {
  const int per_panel = (kTile - from) * 8;          // 16-byte chunks
  for (int i = tid; i < n * NP * per_panel; i += threads) {
    const int panel = i / per_panel, c = i - panel * per_panel;
    *reinterpret_cast<uint4*>(tiles + kPanel * panel +
                              (from + c / 8) * hopper::kRowBytes +
                              16 * (c % 8)) = make_uint4(0, 0, 0, 0);
  }
}

// -- lse (log2 domain) and D of every row ------------------------------------
template <int NP>
constexpr size_t stats_smem() {
  return 1024 + kPanel * NP * (3 + kStages) + (2 * kStages + 1) * 8;
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
stats_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                   const __grid_constant__ CUtensorMap tmap_o,
                   const __grid_constant__ CUtensorMap tmap_do,
                   const __grid_constant__ CUtensorMap tmap_k,
                   float* __restrict__ lse, float* __restrict__ dvec, int B,
                   int S, int kvh, int g, int bq, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);                 // [NP] panels
  uint8_t* o_s = q_s + kPanel * NP;                   // [NP]
  uint8_t* do_s = o_s + kPanel * NP;                  // [NP]
  uint8_t* k_s = do_s + kPanel * NP;                  // [kStages][NP]
  uint64_t* full = reinterpret_cast<uint64_t*>(k_s + kPanel * NP * kStages);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  const RowBlock blk(static_cast<int>(blockIdx.x), B, S, kvh, g, bq);
  const int b = blk.b, h = blk.h, s0 = blk.s0, n_rows = blk.n_rows;
  const int n_tiles = (s0 + n_rows / g + kTile - 1) / kTile;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kConsumers);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {                 // the producer warp
    if (tid == kConsumers) {
      hopper::mbar_arrive_expect_tx(qbar,
                                    3 * NP * hopper::kRowBytes * bq * g);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        hopper::tma_load_5d(q_s + kPanel * p, &tmap_q, qbar, 64 * p, 0, h, s0,
                            b);
        hopper::tma_load_5d(o_s + kPanel * p, &tmap_o, qbar, 64 * p, 0, h, s0,
                            b);
        hopper::tma_load_5d(do_s + kPanel * p, &tmap_do, qbar, 64 * p, 0, h,
                            s0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages, round = j / kStages;
        if (round > 0) hopper::mbar_wait(&empty[st], (round - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[st], NP * kPanel);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          hopper::tma_load_4d(k_s + kPanel * (st * NP + p), &tmap_k,
                              &full[st], 64 * p, h, j * kTile, b);
      }
    }
    return;
  }

  zero_tail<NP>(q_s, 3, bq * g, tid);      // q_s, o_s and do_s
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, kConsumers);
  hopper::mbar_wait(qbar, 0);

  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = 16 * warp + (lane >> 2), row1 = row0 + 8;
  const int pos0 = s0 + row0 / g, pos1 = s0 + row1 / g;
  const int col = 2 * (lane & 3);

  // D = the diagonal of dO . O^T, on the tensor cores as dP = dO . V^T is
  // (the same bf16 products summed the same way, so where a row's out is
  // its one visible v, at S = 1, dP - D is exactly 0 as in the plain
  // version); row r's entry sits in the thread whose columns hold r
  float d0 = 0.f, d1 = 0.f;
  {
    float dd[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dd[i] = 0.f;
    hopper::wgmma_fence();
    mma_ss<NP>(dd, do_s, o_s);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(dd);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + col + (i & 1);
      if ((i & 2) == 0 && c == row0) d0 = dd[i];
      if ((i & 2) != 0 && c == row1) d1 = dd[i];
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {   // adds zeros: exact
      d0 += __shfl_xor_sync(0xffffffffu, d0, o_);
      d1 += __shfl_xor_sync(0xffffffffu, d1, o_);
    }
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    hopper::mbar_wait(&full[st], (j / kStages) & 1);
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;   // overwritten (scale_d = 0)
    hopper::wgmma_fence();
    mma_ss<NP>(s, q_s, k_s + kPanel * st * NP);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);
    hopper::mbar_arrive(&empty[st]);   // this thread is done with stage st

    const bool diag = j * kTile + kTile - 1 > s0;  // some key > some row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = j * kTile + 8 * (i >> 2) + col + (i & 1);
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
  // key 0 is visible to every row: m finite, l >= 1
  if ((lane & 3) == 0) {
    if (row0 < n_rows) {
      const long long idx = row_of(b, S, kvh, h, g, s0, row0);
      lse[idx] = m0 + log2f(l0);
      dvec[idx] = d0;
    }
    if (row1 < n_rows) {
      const long long idx = row_of(b, S, kvh, h, g, s0, row1);
      lse[idx] = m1 + log2f(l1);
      dvec[idx] = d1;
    }
  }
}

// -- dk and dv: one block a 64-key tile ---------------------------------------
// Shared memory of a dk/dv block: K and V ([NP] panels each), the Q and dO
// ring ([kStages][NP] each), lse and D beside each stage, `n_pt` float32
// 64 x 64 P^T buffers (the split kernel's hand-over; none at NP = 1, 2),
// then the mbarriers.
template <int NP, int n_pt = 0>
constexpr size_t dkdv_smem() {
  return 1024 + kPanel * NP * (2 + 2 * kStages) + kStages * 2 * kTile * 4 +
         n_pt * kTile * kTile * 4 + (2 * kStages + 1) * 8;
}

template <int NP>
struct DkdvSmem {
  uint8_t *k_s, *v_s, *q_s, *do_s;
  float* stat_s;           // [kStages][lse 64 | D 64]
  float* p_s;              // [n_pt][64 * 64]
  uint64_t *full, *empty, *kvbar;
  __device__ DkdvSmem(uint8_t* raw, int n_pt) {
    k_s = align1024(raw);                       // [NP]
    v_s = k_s + kPanel * NP;                    // [NP]
    q_s = v_s + kPanel * NP;                    // [kStages][NP]
    do_s = q_s + kPanel * NP * kStages;         // [kStages][NP]
    stat_s = reinterpret_cast<float*>(do_s + kPanel * NP * kStages);
    p_s = stat_s + kStages * 2 * kTile;
    full = reinterpret_cast<uint64_t*>(p_s + n_pt * kTile * kTile);
    empty = full + kStages;
    kvbar = empty + kStages;
  }
};

// The dk/dv producer warp (`lane` 0-31): K and V once, then for each tile
// of bq positions its lse and D (written by the lanes) and its Q and dO
// boxes by TMA into ring stage t % kStages, once every consumer freed it.
template <int NP>
__device__ __forceinline__ void dkdv_produce(
    const DkdvSmem<NP>& sm, const CUtensorMap* tmap_q,
    const CUtensorMap* tmap_do, const CUtensorMap* tmap_k,
    const CUtensorMap* tmap_v, const float* __restrict__ lse,
    const float* __restrict__ dvec, const KeyBlock& blk, int S, int kvh,
    int g, int bq, int lane) {
  const int b = blk.b, h = blk.h, j0 = blk.j0;
  const int rows = bq * g;                   // rows a full tile
  if (lane == 0) {
    hopper::mbar_arrive_expect_tx(sm.kvbar, 2 * NP * kPanel);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      hopper::tma_load_4d(sm.k_s + kPanel * p, tmap_k, sm.kvbar, 64 * p, h,
                          j0, b);
      hopper::tma_load_4d(sm.v_s + kPanel * p, tmap_v, sm.kvbar, 64 * p, h,
                          j0, b);
    }
  }
  for (int t = 0; t < blk.n_qt; ++t) {
    const int st = t % kStages, round = t / kStages;
    const int p0 = j0 + t * bq;
    if (round > 0) hopper::mbar_wait(&sm.empty[st], (round - 1) & 1);
    float* ls = sm.stat_s + st * 2 * kTile;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lane + 32 * half;
      const bool valid = r < rows && p0 + r / g < S;
      const long long idx = valid ? row_of(b, S, kvh, h, g, p0, r) : 0;
      ls[r] = valid ? lse[idx] : INFINITY;      // P = 0 in absent rows
      ls[kTile + r] = valid ? dvec[idx] : 0.f;
    }
    __syncwarp();
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&sm.full[st],
                                    2 * NP * hopper::kRowBytes * rows);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        hopper::tma_load_5d(sm.q_s + kPanel * (st * NP + p), tmap_q,
                            &sm.full[st], 64 * p, 0, h, p0, b);
        hopper::tma_load_5d(sm.do_s + kPanel * (st * NP + p), tmap_do,
                            &sm.full[st], 64 * p, 0, h, p0, b);
      }
    } else {
      hopper::mbar_arrive(&sm.full[st]);
    }
  }
}

// Ring barriers of a dk/dv block: `full` completes when the producer's 32
// lanes arrived and the stage's TMA bytes landed, `empty` when all
// `consumers` threads are done with the stage.
template <int NP>
__device__ __forceinline__ void dkdv_init(const DkdvSmem<NP>& sm,
                                          int consumers) {
  for (int st = 0; st < kStages; ++st) {
    hopper::mbar_init(&sm.full[st], 32);      // the producer warp's lanes
    hopper::mbar_init(&sm.empty[st], consumers);
  }
  hopper::mbar_init(sm.kvbar, 1);
  hopper::fence_barrier_init();
}

// P^T for keys key0 and key0 + 8 (this thread's rows of the m64 tile)
// and tile rows 8 jn + col + {0, 1} from S^T (in place): exp2 of the
// scaled score less the row's lse, 0 above the diagonal (rows before the
// key).
__device__ __forceinline__ void form_p(float (&s)[32], const float* ls,
                                       int key0, int j0, int p0, int g,
                                       int col, float scale_log2) {
  // column c (row p0 + c / g) is visible to key j iff j <= p0 + c / g,
  // i.e. c >= (j - p0) g
  const bool diag = p0 < j0 + kTile - 1;
  const int lim0 = (key0 - p0) * g, lim1 = lim0 + 8 * g;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const int c = 8 * jn + col;
    const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = 4 * jn + x;
      float p = exp2f(s[i] * scale_log2 - ((x & 1) ? l2.y : l2.x));
      if (diag && c + (x & 1) < (x >= 2 ? lim1 : lim0)) p = 0.f;
      s[i] = p;
    }
  }
}

// dK (scaled) and dV of keys key0 / key1 in bf16, columns below dh.
template <int NP>
__device__ __forceinline__ void store_keys(bf16* __restrict__ out,
                                           const float (&acc)[32 * NP],
                                           float scale, int b, int S,
                                           int kvh, int h, int dh, int key0,
                                           int col) {
  const int key1 = key0 + 8;
  const long long base0 = ((static_cast<long long>(b) * S + key0) * kvh + h) *
                          dh;
  const long long base1 = ((static_cast<long long>(b) * S + key1) * kvh + h) *
                          dh;
#pragma unroll
  for (int jn = 0; jn < 8 * NP; ++jn) {
    const int d = 8 * jn + col;
    if (d >= dh) continue;
    if (key0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + base0 + d) =
          __floats2bfloat162_rn(acc[4 * jn] * scale, acc[4 * jn + 1] * scale);
    if (key1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + base1 + d) =
          __floats2bfloat162_rn(acc[4 * jn + 2] * scale,
                                acc[4 * jn + 3] * scale);
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads, NP == 1 ? 2 : 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                  const __grid_constant__ CUtensorMap tmap_do,
                  const __grid_constant__ CUtensorMap tmap_k,
                  const __grid_constant__ CUtensorMap tmap_v,
                  const float* __restrict__ lse,
                  const float* __restrict__ dvec, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int B, int S, int kvh, int g,
                  int dh, int bq, float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const DkdvSmem<NP> sm(smem_raw, 0);
  const KeyBlock blk(static_cast<int>(blockIdx.x), B, S, kvh, bq);
  const int j0 = blk.j0;
  const int tid = threadIdx.x;

  if (tid == 0) dkdv_init(sm, kConsumers);
  __syncthreads();

  if (tid >= kConsumers) {                 // the producer warp
    dkdv_produce(sm, &tmap_q, &tmap_do, &tmap_k, &tmap_v, lse, dvec, blk, S,
                 kvh, g, bq, tid - kConsumers);
    return;
  }

  zero_tail<NP>(sm.q_s, kStages, bq * g, tid);
  zero_tail<NP>(sm.do_s, kStages, bq * g, tid);
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, kConsumers);

  // This thread's two keys (rows of the m64 accumulator) and its columns
  // 8 jn + col + {0, 1} (tile rows) of every n8 block jn.
  const int warp = tid >> 5, lane = tid & 31;
  const int key0 = j0 + 16 * warp + (lane >> 2);
  const int col = 2 * (lane & 3);
  float acc_k[32 * NP], acc_v[32 * NP];
#pragma unroll
  for (int i = 0; i < 32 * NP; ++i) acc_k[i] = acc_v[i] = 0.f;
  hopper::mbar_wait(sm.kvbar, 0);

  for (int t = 0; t < blk.n_qt; ++t) {
    const int st = t % kStages;
    const int p0 = j0 + t * bq;
    hopper::mbar_wait(&sm.full[st], (t / kStages) & 1);
    const uint8_t* qt = sm.q_s + kPanel * st * NP;
    const uint8_t* dt = sm.do_s + kPanel * st * NP;
    const float* ls = sm.stat_s + st * 2 * kTile;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    hopper::wgmma_fence();
    mma_ss<NP>(s, sm.k_s, qt);        // S^T = K . Q^T
    mma_ss<NP>(dp, sm.v_s, dt);       // dP^T = V . dO^T
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    form_p(s, ls, key0, j0, p0, g, col, scale_log2);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {       // dS^T = P^T (dP^T - D)
      const float2 d2 =
          *reinterpret_cast<const float2*>(ls + kTile + 8 * jn + col);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        dp[4 * jn + x] = s[4 * jn + x] *
                         (dp[4 * jn + x] - ((x & 1) ? d2.y : d2.x));
    }
    uint32_t pa[4][4], da[4][4];
    to_a(s, pa);
    to_a(dp, da);
    hopper::wgmma_fence();
    mma_rs<NP>(acc_v, pa, dt);        // dV += P^T . dO
    mma_rs<NP>(acc_k, da, qt);        // dK += dS^T . Q
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc_v);
    hopper::fence_regs(acc_k);
    hopper::mbar_arrive(&sm.empty[st]);   // this thread is done with stage st
  }

  store_keys<NP>(dk, acc_k, scale, blk.b, S, kvh, blk.h, dh, key0, col);
  store_keys<NP>(dv, acc_v, 1.f, blk.b, S, kvh, blk.h, dh, key0, col);
}

// -- dk and dv at NP = 3: two consumer warpgroups -------------------------------
constexpr int kSplitConsumers = 2 * kConsumers;            // A and B
// + a producer warpgroup (one warp of it loads), so that setmaxnreg can
// give it few registers and the consumers 224 of the file's 65,536
constexpr int kSplitThreads = kSplitConsumers + kConsumers;
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(kProducerRegs * kConsumers + kConsumerRegs * kSplitConsumers <=
                  65536,
              "the split kernel's register budgets exceed an SM's file");
constexpr int kPtBuffers = 2;
// named barriers (0 is __syncthreads): the consumers' start, then per P^T
// buffer "full" (A wrote it) and "empty" (B read it)
constexpr int kBarConsumers = 1, kBarFull = 2, kBarEmpty = 2 + kPtBuffers;

__global__ void __launch_bounds__(kSplitThreads, 1)
dkdv_split_kernel(const __grid_constant__ CUtensorMap tmap_q,
                  const __grid_constant__ CUtensorMap tmap_do,
                  const __grid_constant__ CUtensorMap tmap_k,
                  const __grid_constant__ CUtensorMap tmap_v,
                  const float* __restrict__ lse,
                  const float* __restrict__ dvec, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int B, int S, int kvh, int g,
                  int dh, int bq, float scale_log2, float scale) {
  constexpr int NP = 3;
  extern __shared__ uint8_t smem_raw[];
  const DkdvSmem<NP> sm(smem_raw, kPtBuffers);
  const KeyBlock blk(static_cast<int>(blockIdx.x), B, S, kvh, bq);
  const int j0 = blk.j0, n_qt = blk.n_qt;
  const int tid = threadIdx.x;

  if (tid == 0) dkdv_init(sm, kSplitConsumers);
  __syncthreads();

  if (tid >= kSplitConsumers) {            // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid < kSplitConsumers + 32)        // its first warp loads
      dkdv_produce(sm, &tmap_q, &tmap_do, &tmap_k, &tmap_v, lse, dvec, blk,
                   S, kvh, g, bq, tid - kSplitConsumers);
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  zero_tail<NP, kSplitConsumers>(sm.q_s, kStages, bq * g, tid);
  zero_tail<NP, kSplitConsumers>(sm.do_s, kStages, bq * g, tid);
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(kBarConsumers, kSplitConsumers);

  // Warpgroup A (wg 0): S^T = K.Q^T, P^T, dV += P^T.dO; warpgroup B (wg 1):
  // dP^T = V.dO^T, dS^T, dK += dS^T.Q. Thread u of each holds the same
  // keys and tile rows (the m64 accumulator layout), so B's thread u reads
  // P^T exactly where A's thread u wrote it.
  const bool wg_a = tid < kConsumers;
  const int u = tid % kConsumers;
  const int warp = u >> 5, lane = u & 31;
  const int key0 = j0 + 16 * warp + (lane >> 2);
  const int col = 2 * (lane & 3);
  const uint8_t* left = wg_a ? sm.k_s : sm.v_s;
  float acc[32 * NP];
#pragma unroll
  for (int i = 0; i < 32 * NP; ++i) acc[i] = 0.f;
  hopper::mbar_wait(sm.kvbar, 0);

  for (int t = 0; t < n_qt; ++t) {
    const int st = t % kStages, buf = t % kPtBuffers;
    const int p0 = j0 + t * bq;
    hopper::mbar_wait(&sm.full[st], (t / kStages) & 1);
    const uint8_t* qt = sm.q_s + kPanel * st * NP;
    const uint8_t* dt = sm.do_s + kPanel * st * NP;
    const float* ls = sm.stat_s + st * 2 * kTile;
    float4* pt = reinterpret_cast<float4*>(sm.p_s + buf * kTile * kTile) + u;

    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    hopper::wgmma_fence();
    mma_ss<NP>(x, left, wg_a ? qt : dt);   // S^T = K.Q^T | dP^T = V.dO^T
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(x);

    if (wg_a) {
      form_p(x, ls, key0, j0, p0, g, col, scale_log2);
      // B is done with this buffer's previous tile (t - kPtBuffers)
      if (t >= kPtBuffers)
        hopper::named_barrier_sync(kBarEmpty + buf, kSplitConsumers);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pt[i * kConsumers] =
            make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
      hopper::named_barrier_arrive(kBarFull + buf, kSplitConsumers);
    } else {
      // dS^T = P^T (dP^T - D), P^T read a float4 (one n8 block) at a
      // time: no second 32-float tile beside dP^T and dK
      hopper::named_barrier_sync(kBarFull + buf, kSplitConsumers);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float4 p4 = pt[jn * kConsumers];
        const float2 d2 =
            *reinterpret_cast<const float2*>(ls + kTile + 8 * jn + col);
        x[4 * jn] = p4.x * (x[4 * jn] - d2.x);
        x[4 * jn + 1] = p4.y * (x[4 * jn + 1] - d2.y);
        x[4 * jn + 2] = p4.z * (x[4 * jn + 2] - d2.x);
        x[4 * jn + 3] = p4.w * (x[4 * jn + 3] - d2.y);
      }
      // A writes this buffer again only for tile t + kPtBuffers
      if (t + kPtBuffers < n_qt)
        hopper::named_barrier_arrive(kBarEmpty + buf, kSplitConsumers);
    }
    uint32_t xa[4][4];
    to_a(x, xa);
    hopper::wgmma_fence();
    mma_rs<NP>(acc, xa, wg_a ? dt : qt);  // dV += P^T.dO | dK += dS^T.Q
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&sm.empty[st]);   // this thread is done with stage st
  }

  if (wg_a)
    store_keys<NP>(dv, acc, 1.f, blk.b, S, kvh, blk.h, dh, key0, col);
  else
    store_keys<NP>(dk, acc, scale, blk.b, S, kvh, blk.h, dh, key0, col);
}

// -- dq: one block a tile of rows ---------------------------------------------
template <int NP>
constexpr size_t dq_smem() {
  return 1024 + kPanel * NP * (2 + 2 * kStages) + (2 * kStages + 1) * 8;
}

template <int NP>
__global__ void __launch_bounds__(kThreads, NP == 1 ? 2 : 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                const __grid_constant__ CUtensorMap tmap_do,
                const __grid_constant__ CUtensorMap tmap_k,
                const __grid_constant__ CUtensorMap tmap_v,
                const float* __restrict__ lse,
                const float* __restrict__ dvec, bf16* __restrict__ dq, int B,
                int S, int kvh, int g, int dh, int bq, float scale_log2,
                float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);                 // [NP]
  uint8_t* do_s = q_s + kPanel * NP;                  // [NP]
  uint8_t* k_s = do_s + kPanel * NP;                  // [kStages][NP]
  uint8_t* v_s = k_s + kPanel * NP * kStages;         // [kStages][NP]
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kPanel * NP * kStages);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  const RowBlock blk(static_cast<int>(blockIdx.x), B, S, kvh, g, bq);
  const int b = blk.b, h = blk.h, s0 = blk.s0, n_rows = blk.n_rows;
  const int n_tiles = (s0 + n_rows / g + kTile - 1) / kTile;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kConsumers);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {                 // the producer warp
    if (tid == kConsumers) {
      hopper::mbar_arrive_expect_tx(qbar,
                                    2 * NP * hopper::kRowBytes * bq * g);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        hopper::tma_load_5d(q_s + kPanel * p, &tmap_q, qbar, 64 * p, 0, h, s0,
                            b);
        hopper::tma_load_5d(do_s + kPanel * p, &tmap_do, qbar, 64 * p, 0, h,
                            s0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages, round = j / kStages;
        if (round > 0) hopper::mbar_wait(&empty[st], (round - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[st], 2 * NP * kPanel);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          hopper::tma_load_4d(k_s + kPanel * (st * NP + p), &tmap_k,
                              &full[st], 64 * p, h, j * kTile, b);
          hopper::tma_load_4d(v_s + kPanel * (st * NP + p), &tmap_v,
                              &full[st], 64 * p, h, j * kTile, b);
        }
      }
    }
    return;
  }

  zero_tail<NP>(q_s, 1, bq * g, tid);
  zero_tail<NP>(do_s, 1, bq * g, tid);
  hopper::fence_proxy_async();

  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = 16 * warp + (lane >> 2), row1 = row0 + 8;
  const int pos0 = s0 + row0 / g, pos1 = s0 + row1 / g;
  const int col = 2 * (lane & 3);
  const long long idx0 = row_of(b, S, kvh, h, g, s0, row0);
  const long long idx1 = row_of(b, S, kvh, h, g, s0, row1);
  // absent rows: lse = +inf, so P = dS = 0
  const float lse0 = row0 < n_rows ? lse[idx0] : INFINITY;
  const float lse1 = row1 < n_rows ? lse[idx1] : INFINITY;
  const float d0 = row0 < n_rows ? dvec[idx0] : 0.f;
  const float d1 = row1 < n_rows ? dvec[idx1] : 0.f;
  float acc[32 * NP];
#pragma unroll
  for (int i = 0; i < 32 * NP; ++i) acc[i] = 0.f;
  hopper::named_barrier_sync(1, kConsumers);
  hopper::mbar_wait(qbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    hopper::mbar_wait(&full[st], (j / kStages) & 1);
    const uint8_t* kt = k_s + kPanel * st * NP;
    const uint8_t* vt = v_s + kPanel * st * NP;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    hopper::wgmma_fence();
    mma_ss<NP>(s, q_s, kt);           // S = Q . K^T
    mma_ss<NP>(dp, do_s, vt);         // dP = dO . V^T
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    const bool diag = j * kTile + kTile - 1 > s0;  // some key > some row
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = j * kTile + 8 * (i >> 2) + col + (i & 1);
      const bool lo = (i & 2) == 0;
      float p = exp2f(s[i] * scale_log2 - (lo ? lse0 : lse1));
      if (diag && key > (lo ? pos0 : pos1)) p = 0.f;
      s[i] = p * (dp[i] - (lo ? d0 : d1));          // dS
    }
    uint32_t da[4][4];
    to_a(s, da);
    hopper::wgmma_fence();
    mma_rs<NP>(acc, da, kt);          // dQ += dS . K
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[st]);   // this thread is done with stage st
  }

#pragma unroll
  for (int jn = 0; jn < 8 * NP; ++jn) {
    const int d = 8 * jn + col;
    if (d >= dh) continue;
    if (row0 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(dq + idx0 * dh + d) =
          __floats2bfloat162_rn(acc[4 * jn] * scale, acc[4 * jn + 1] * scale);
    if (row1 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(dq + idx1 * dh + d) =
          __floats2bfloat162_rn(acc[4 * jn + 2] * scale,
                                acc[4 * jn + 3] * scale);
  }
}

// -- launches -----------------------------------------------------------------
inline unsigned row_blocks(int B, int S, int kvh, int bq) {
  return static_cast<unsigned>(static_cast<long long>(B) * kvh *
                               ((S + bq - 1) / bq));
}

template <int NP>
int stats_np(const bf16* q, const bf16* k, const bf16* out, const bf16* dout,
             float* lse, float* dvec, int B, int S, int kvh, int g, int dh,
             float scale, cudaStream_t stream) {
  const int bq = kTile / g;
  CUtensorMap maps[4];
  int err = hopper::encode_bshgd(&maps[0], q, B, S, kvh, g, dh, bq);
  if (err == 0) err = hopper::encode_bshgd(&maps[1], out, B, S, kvh, g, dh, bq);
  if (err == 0)
    err = hopper::encode_bshgd(&maps[2], dout, B, S, kvh, g, dh, bq);
  if (err == 0) err = hopper::encode_bshd(&maps[3], k, B, S, kvh, dh);
  if (err != 0) return err;
  auto kernel = stats_wgmma_kernel<NP>;
  cudaError_t e = attn::allow_smem(kernel, stats_smem<NP>());
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<row_blocks(B, S, kvh, bq), kThreads, stats_smem<NP>(), stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dvec, B, S, kvh, g, bq,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// The four tensor maps of the dk/dv and dq kernels.
inline int encode_all(CUtensorMap (&maps)[4], const bf16* q, const bf16* k,
                      const bf16* v, const bf16* dout, int B, int S, int kvh,
                      int g, int dh, int bq) {
  int err = hopper::encode_bshgd(&maps[0], q, B, S, kvh, g, dh, bq);
  if (err == 0) err = hopper::encode_bshgd(&maps[1], dout, B, S, kvh, g, dh, bq);
  if (err == 0) err = hopper::encode_bshd(&maps[2], k, B, S, kvh, dh);
  if (err == 0) err = hopper::encode_bshd(&maps[3], v, B, S, kvh, dh);
  return err;
}

template <int NP>
int dkdv_np(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
            const float* lse, const float* dvec, bf16* dk, bf16* dv, int B,
            int S, int kvh, int g, int dh, float scale, cudaStream_t stream) {
  const int bq = kTile / g;
  CUtensorMap maps[4];
  const int err = encode_all(maps, q, k, v, dout, B, S, kvh, g, dh, bq);
  if (err != 0) return err;
  // NP = 3: the two-warpgroup kernel and its P^T buffers
  auto kernel = dkdv_split_kernel;
  size_t smem = dkdv_smem<NP, kPtBuffers>();
  int threads = kSplitThreads;
  if constexpr (NP < 3) {
    kernel = dkdv_wgmma_kernel<NP>;
    smem = dkdv_smem<NP>();
    threads = kThreads;
  }
  cudaError_t e = attn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>(
      static_cast<long long>(B) * kvh * ((S + kTile - 1) / kTile));
  kernel<<<blocks, threads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dvec, dk, dv, B, S, kvh, g, dh,
      bq, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NP>
int dq_np(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
          const float* lse, const float* dvec, bf16* dqo, int B, int S,
          int kvh, int g, int dh, float scale, cudaStream_t stream) {
  const int bq = kTile / g;
  CUtensorMap maps[4];
  const int err = encode_all(maps, q, k, v, dout, B, S, kvh, g, dh, bq);
  if (err != 0) return err;
  auto kernel = dq_wgmma_kernel<NP>;
  cudaError_t e = attn::allow_smem(kernel, dq_smem<NP>());
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<row_blocks(B, S, kvh, bq), kThreads, dq_smem<NP>(), stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dvec, dqo, B, S, kvh, g, dh,
      bq, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

static_assert(kTile == flash_bwd::kKeyBlock,
              "a dk/dv block is one K/V tile");
static_assert(dkdv_smem<2>() <= 232448 && dq_smem<2>() <= 232448,
              "NP = 2 must fit an H100 block's shared memory");
static_assert(dkdv_smem<3, kPtBuffers>() <= 232448 && dq_smem<3>() <= 232448 &&
                  stats_smem<3>() <= 232448,
              "NP = 3 must fit an H100 block's shared memory");

// Dh <= 64, <= 128, <= 192: one, two or three 64-column panels.
inline int panels(int dh) { return dh <= 64 ? 1 : dh <= 128 ? 2 : 3; }

}  // namespace

// Plain C interface (loaded with ctypes), the CUDA-core kernels'
// signatures. Each function returns the cudaError_t of its launch (or
// hopper::kEncodeError + a CUresult); 0 means the launch was accepted.
// Shapes are checked by the Python wrapper: bf16, 1 <= G <= 32,
// Dh % 16 == 0 and Dh <= 192, every tensor 16-byte aligned. lse (in the
// log2 domain) and dvec are float32 [B, S, KvH, G] scratch: written by
// the stats function, read by the other two.
extern "C" {

int flash_attention_causal_bwd_stats_bf16_wgmma(
    const bf16* q, const bf16* k, const bf16* out, const bf16* dout,
    float* lse, float* dvec, int B, int S, int kvh, int g, int dh,
    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (panels(dh)) {
    case 1:
      return stats_np<1>(q, k, out, dout, lse, dvec, B, S, kvh, g, dh, scale,
                         s);
    case 2:
      return stats_np<2>(q, k, out, dout, lse, dvec, B, S, kvh, g, dh, scale,
                         s);
    default:
      return stats_np<3>(q, k, out, dout, lse, dvec, B, S, kvh, g, dh, scale,
                         s);
  }
}

int flash_attention_causal_bwd_dkdv_bf16_wgmma(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* dvec, bf16* dk, bf16* dv, int B, int S,
    int kvh, int g, int dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (panels(dh)) {
    case 1:
      return dkdv_np<1>(q, k, v, dout, lse, dvec, dk, dv, B, S, kvh, g, dh,
                        scale, s);
    case 2:
      return dkdv_np<2>(q, k, v, dout, lse, dvec, dk, dv, B, S, kvh, g, dh,
                        scale, s);
    default:
      return dkdv_np<3>(q, k, v, dout, lse, dvec, dk, dv, B, S, kvh, g, dh,
                        scale, s);
  }
}

int flash_attention_causal_bwd_dq_bf16_wgmma(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* dvec, bf16* dqo, int B, int S, int kvh,
    int g, int dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (panels(dh)) {
    case 1:
      return dq_np<1>(q, k, v, dout, lse, dvec, dqo, B, S, kvh, g, dh, scale,
                      s);
    case 2:
      return dq_np<2>(q, k, v, dout, lse, dvec, dqo, B, S, kvh, g, dh, scale,
                      s);
    default:
      return dq_np<3>(q, k, v, dout, lse, dvec, dqo, B, S, kvh, g, dh, scale,
                      s);
  }
}

}  // extern "C"
