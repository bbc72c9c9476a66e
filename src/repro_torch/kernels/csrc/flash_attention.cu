// Causal grouped-query flash attention (prefill), for sm_90a.
//
// Replaces the Pallas TPU kernel flash_attention_causal of
// src/repro/kernels/flash_attention.py (_flash_kernel, pallas_call at
// :88): causal self-attention over a sequence with a float32 online
// softmax, key blocks strictly above the diagonal skipped.
//
//   q      [B, S, KvH, G, Dh]   (query head h = kvh * G + g)
//   k, v   [B, S, KvH, Dh]
//   out    [B, S, KvH, G, Dh]   in q's dtype
//
// As in the Pallas kernel, the G query heads of a block's bq positions
// fill the row dimension together (row r = (position s0 + r / G, head
// r % G), bq = 64 / G positions, at most 64 rows), so every K/V tile
// loaded serves all of them; the block walks keys [0, last row + 1), so
// tiles strictly above the diagonal are never loaded, and the triangular
// mask (key <= query position) and the ragged edge are index tests — S
// need not be a multiple of bq (the Pallas wrapper asserts that it is).
//
// What bounds it: operations. The causal work is 4 * Dh flops per (query
// head, key <= query) pair, S (S + 1) / 2 pairs a head; the bytes (q, k,
// v read once, out written once) the H100 moves in about a microsecond
// at the serving shapes (B = 1, S = 128-512, KvH = 5, G = 3, Dh = 64).
// Dh runs to 192 on every route: DeepSeek-V2's MLA attends at 128 + 64
// (q_nope | q_rope) with v zero-padded to it, G = 1. Three kernels,
// chosen by the wrapper by dtype, Dh and alignment (never as a fallback):
//
// * flash_wgmma_kernel (bf16, Dh % 16 == 0): the tensor cores. One
//   producer warp streams 64-key K and V tiles with TMA into a ring of
//   kStages stages (one mbarrier pair a stage); one consumer warpgroup
//   computes S = Q.K^T with wgmma m64n64k16 (Q and K from shared memory,
//   128B-swizzled, Dh padded to 64-column panels by TMA's zero fill),
//   scales S by Dh^-0.5 in float32, runs the online softmax on the
//   accumulator fragments in registers (a row's 16 values a thread,
//   reduced over the 4 threads of a row), and adds P.V with wgmma whose
//   A operand is P rounded to bf16 in registers (the accumulator layout
//   is the A-fragment layout) and whose B operand is the V tile read
//   MN-major (the descriptor's transpose). P's bf16 rounding is the only
//   rounding the plain version does not make. Blocks run heaviest first
//   (the last q-blocks get the lowest blockIdx), so the long diagonal
//   blocks start first: at the serving shape 125 blocks, one wave.
// * flash_tf32x3_kernel (float32, Dh % 8 == 0): the tensor cores in tf32
//   with float32 accuracy, the same block shape, producer warp, rows and
//   order. One tf32 product keeps 10 mantissa bits and misses float32's
//   1e-5; so every product a.b is a_hi.b_hi + a_hi.b_lo + a_lo.b_hi
//   (CUTLASS's 3xTF32), x_hi = cvt.rna.tf32.f32(x) and x_lo =
//   cvt.rna.tf32.f32(x - x_hi) (x - x_hi is exact; both rounded
//   explicitly, so nothing rests on what the tensor cores do with a
//   float32's low 13 bits), summed in float32 by wgmma; the dropped
//   a_lo.b_lo is below 2^-22 |a||b|. No single-tf32 product is taken.
//   - S = Q.K^T, wgmma m64nKTk8 from shared memory: a float32 row of 32
//     columns is one 128-byte swizzled row, so Q and K are NP = ceil(Dh /
//     32) 32-column panels and a k8 slice steps 32 bytes as bf16's k16
//     does. Q * Dh^-0.5 * log2(e) is split once into Q_hi, Q_lo; TMA
//     lands each K tile as it is ([keys][Dh], K-major for B) and the
//     consumers rewrite it as K_hi in place beside K_lo.
//   - O += P.V: tf32 operands cannot be transposed (the descriptor's
//     transpose bit is f16/bf16 only), so the same pass writes each
//     landed V tile as V^T_hi and V^T_lo ([Dh][keys], keys contiguous,
//     swizzled). P comes from registers: the m64k8 tf32 A fragment holds
//     columns c and c + 4 (c = lane % 4) where the accumulator holds 2c
//     and 2c + 1, so V^T stores the keys of each 8-key group as 0, 2, 4,
//     6, 1, 3, 5, 7 and P needs no shuffle (the sum over keys has no
//     order to keep). P_hi, P_lo are formed in registers. At NP <= 4 a
//     tile's P.V goes into a fresh accumulator, added into O in float32,
//     so the tensor cores' own sum never runs along the whole row (at
//     llava's S = 2,560 that gave the smaller error). At NP = 6 a fresh
//     accumulator beside O's 96 registers spills, even 32 columns at a
//     time, so O accumulates in the tensor cores; at MLA's rows, S = 512
//     and 2,048 (chip_smoke.py phase 3), its error is what a fresh
//     accumulator gives.
//   - Shared memory, the hard part (float32 doubles every tile, the lo
//     parts double them again): Q_hi and Q_lo, kStages K and V tiles and
//     one derived set (K_lo, V^T_hi, V^T_lo) of kTile keys. Dh <= 64
//     takes 64-key tiles in two stages; Dh 128 32-key tiles in two; Dh
//     192 32-key tiles in one stage (Q_hi and Q_lo alone are 96 KB).
//   - The split pass runs on the one consumer warpgroup in series with
//     the products, so its loops are unrolled whole: a thread's loads
//     are all in flight at once.
//   Instantiations on an H100 (nvcc -Xptxas -v, CUDA 12.8; shared memory
//   from tf32_smem_bytes; blocks an SM by shared memory and registers):
//
//     NP  Dh       keys x stages  threads  regs  spills  shared mem  blocks/SM
//      1  8-32     64 x 2         160      202   0 B      74,784 B   1 (regs)
//      2  40-64    64 x 2         160      241   0 B     148,512 B   1
//      4  72-128   32 x 2         160      255   0 B     181,280 B   1
//      6  136-192  32 x 1         160      254   0 B     222,224 B   1
//
// * flash_kernel (the rest: bf16 with Dh % 16 != 0, float32 with Dh % 8
//   != 0, tensors not 16-byte aligned): the CUDA cores in float32
//   (attention.cuh's attend_rows), 8 warps a block.
#include "attention.cuh"
#include "hopper.cuh"

namespace {

// -- the CUDA-core kernel (the shapes the tensor-core kernels do not take) -
constexpr int kWarps = 8;

template <typename T, int DPL, int RPW>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int kvh,
             int g, int dh, int bq, float scale) {
  extern __shared__ float smem[];
  __shared__ long long rows_q[attn::kMaxRows];
  __shared__ int rows_limit[attn::kMaxRows];
  const int n_qb = (S + bq - 1) / bq;
  const int qb = blockIdx.x % n_qb;
  const int bh = blockIdx.x / n_qb;
  const int b = bh / kvh;
  const int h = bh - b * kvh;
  const int s0 = qb * bq;
  const int n_pos = min(bq, S - s0);
  const int n_rows = n_pos * g;          // rows ordered (position, head)
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
    const int pos = s0 + r / g;
    rows_q[r] = (((static_cast<long long>(b) * S + pos) * kvh + h) * g +
                 r % g) * dh;
    rows_limit[r] = pos + 1;             // causal: keys <= pos
  }
  __syncthreads();
  const long long kv_base = (static_cast<long long>(b) * S * kvh + h) * dh;
  attn::attend_rows<T, DPL, RPW>(q, k, v, out, rows_q, rows_limit, n_rows,
                                 s0 + n_pos, kv_base,
                                 static_cast<long long>(kvh) * dh, dh, scale,
                                 smem);
}

// bq * G <= kMaxRows = 64 rows over 8 warps: at most 8 rows a warp.
template <typename T, int DPL>
int launch_dpl(const T* q, const T* k, const T* v, T* out, int B, int S,
               int kvh, int g, int dh, float scale, cudaStream_t stream) {
  const int bq = attn::kMaxRows / g;
  const size_t smem = attn::smem_bytes(bq * g, dh);
  auto kernel = flash_kernel<T, DPL, attn::kMaxRows / kWarps>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(B) * kvh * ((S + bq - 1) / bq);
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      q, k, v, out, S, kvh, g, dh, bq, scale);
  return static_cast<int>(cudaGetLastError());
}

// Shapes are checked by the Python wrapper: 1 <= G <= 32, 1 <= Dh <= 192
// (MLA's 128 + 64); DPL = ceil(Dh / 32) rounded up to 1, 2, 4 or 6.
template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int B, int S, int kvh,
           int g, int dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 32)
    return launch_dpl<T, 1>(q, k, v, out, B, S, kvh, g, dh, scale, s);
  if (dh <= 64)
    return launch_dpl<T, 2>(q, k, v, out, B, S, kvh, g, dh, scale, s);
  if (dh <= 128)
    return launch_dpl<T, 4>(q, k, v, out, B, S, kvh, g, dh, scale, s);
  return launch_dpl<T, 6>(q, k, v, out, B, S, kvh, g, dh, scale, s);
}

// -- the tensor-core kernel (bf16, Dh % 16 == 0) ----------------------------
using bf16 = __nv_bfloat16;
constexpr int kTileK = 64;        // keys a tile (the wgmma N of Q.K^T)
constexpr int kStages = 4;        // K/V ring depth
constexpr int kConsumers = 128;   // one warpgroup
constexpr int kWgThreads = kConsumers + 32;   // + the producer warp
constexpr uint32_t kPanel = 64 * hopper::kRowBytes;  // [64 rows][64 cols]

// Dynamic shared memory of a block with NP 64-column panels: Q, the K and
// V rings, 2 * kStages mbarriers, and 1024 bytes to align the tiles. At
// NP = 3 (Dh 129-192) that is 222,272 bytes, under the 232,448 a block
// may take on an H100.
template <int NP>
constexpr size_t wgmma_smem_bytes() {
  return 1024 + kPanel * NP * (1 + 2 * kStages) + 2 * kStages * 8;
}

static_assert(wgmma_smem_bytes<3>() <= 232448,
              "NP = 3 must fit an H100 block's shared memory");

template <int NP>   // Dh padded to 64 * NP columns
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_k,
                   const __grid_constant__ CUtensorMap tmap_v,
                   const bf16* __restrict__ q, bf16* __restrict__ out, int B,
                   int S, int kvh, int g, int dh, int bq, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) &
                              1023);
  uint8_t* q_s = base;                                  // [NP][64][128 B]
  uint8_t* k_s = q_s + kPanel * NP;                     // [kStages][NP]...
  uint8_t* v_s = k_s + kPanel * NP * kStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kPanel * NP * kStages);
  uint64_t* empty = full + kStages;

  const int n_qb = (S + bq - 1) / bq;
  const int bhs = B * kvh;
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x) / bhs;  // heavy 1st
  const int bh = static_cast<int>(blockIdx.x) % bhs;
  const int b = bh / kvh;
  const int h = bh - b * kvh;
  const int s0 = qb * bq;
  const int n_pos = min(bq, S - s0);
  const int n_rows = n_pos * g;
  const int n_tiles = (s0 + n_pos + kTileK - 1) / kTileK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {                 // the producer warp
    if (tid == kConsumers) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages, round = j / kStages;
        if (round > 0) hopper::mbar_wait(&empty[st], (round - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[st], 2 * NP * kPanel);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          hopper::tma_load_4d(k_s + kPanel * (st * NP + p), &tmap_k,
                              &full[st], 64 * p, h, j * kTileK, b);
          hopper::tma_load_4d(v_s + kPanel * (st * NP + p), &tmap_v,
                              &full[st], 64 * p, h, j * kTileK, b);
        }
      }
    }
    return;
  }

  // Q -> shared memory, swizzled, zero in padding rows and columns.
  for (int i = tid; i < 64 * NP * 8; i += kConsumers) {
    const int r = i / (NP * 8), c8 = i - r * (NP * 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n_rows && c8 * 8 < dh) {
      const long long row = ((static_cast<long long>(b) * S + s0 + r / g) *
                                 kvh + h) * g + r % g;
      val = *reinterpret_cast<const uint4*>(q + row * dh + c8 * 8);
    }
    *reinterpret_cast<uint4*>(q_s + kPanel * (c8 >> 3) +
                              hopper::swizzle128(r, c8 & 7)) = val;
  }
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, kConsumers);

  // This thread's two rows of the m64 accumulator layout, and its columns
  // 8 j + 2 (lane % 4) + {0, 1} of every n8 block j.
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = 16 * warp + (lane >> 2), row1 = row0 + 8;
  const int pos0 = s0 + row0 / g, pos1 = s0 + row1 / g;
  const int col = 2 * (lane & 3);
  float o[32 * NP];
#pragma unroll
  for (int i = 0; i < 32 * NP; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    hopper::mbar_wait(&full[st], (j / kStages) & 1);
    const uint8_t* kt = k_s + kPanel * st * NP;
    const uint8_t* vt = v_s + kPanel * st * NP;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;   // overwritten (scale_d = 0)
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {      // k16 slices of Dh
      const uint32_t off = kPanel * (kk >> 2) + 32 * (kk & 3);
      hopper::wgmma_m64n64k16_ss(s, hopper::desc128(q_s + off, 16, 1024),
                                 hopper::desc128(kt + off, 16, 1024),
                                 kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);

    // scale (float32, log2 domain), mask, online softmax per row
    const bool diag = j * kTileK + kTileK - 1 > s0;  // some key > some row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = j * kTileK + 8 * (i >> 2) + col + (i & 1);
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
      const bool lo = (i & 2) == 0;
      const float p = exp2f(s[i] - (lo ? ms0 : ms1));   // -inf -> exactly 0
      s[i] = p;
      if (lo) sum0 += p;
      else sum1 += p;
    }
    l0 = l0 * c0 + sum0;          // this thread's columns; summed at the end
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int i = 0; i < 32 * NP; ++i) o[i] *= (i & 2) == 0 ? c0 : c1;

    // O += P . V, P as bf16 A fragments: slice kk holds keys 16 kk ..
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = hopper::pack_bf16(s[8 * kk + 2 * x],
                                      s[8 * kk + 2 * x + 1]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = hopper::desc128(vt + 16 * hopper::kRowBytes * kk,
                                          kPanel, hopper::kAtomBytes);
      if constexpr (NP == 1)
        hopper::wgmma_m64n64k16_rs_tb(o, pa[kk], dv);
      else if constexpr (NP == 2)
        hopper::wgmma_m64n128k16_rs_tb(o, pa[kk], dv);
      else
        hopper::wgmma_m64n192k16_rs_tb(o, pa[kk], dv);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(o);
    hopper::mbar_arrive(&empty[st]);   // this thread is done with stage st
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const long long out0 =
      (((static_cast<long long>(b) * S + pos0) * kvh + h) * g + row0 % g) *
      dh;
  const long long out1 =
      (((static_cast<long long>(b) * S + pos1) * kvh + h) * g + row1 % g) *
      dh;
#pragma unroll
  for (int jn = 0; jn < 8 * NP; ++jn) {     // n8 blocks of the output
    const int d = 8 * jn + col;
    if (d >= dh) continue;
    if (row0 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + out0 + d) =
          __floats2bfloat162_rn(o[4 * jn] / den0, o[4 * jn + 1] / den0);
    if (row1 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + out1 + d) =
          __floats2bfloat162_rn(o[4 * jn + 2] / den1, o[4 * jn + 3] / den1);
  }
}

template <int NP>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                 int B, int S, int kvh, int g, int dh, float scale,
                 cudaStream_t stream) {
  CUtensorMap tmap_k, tmap_v;
  int err = hopper::encode_bshd(&tmap_k, k, B, S, kvh, dh);
  if (err != 0) return err;
  err = hopper::encode_bshd(&tmap_v, v, B, S, kvh, dh);
  if (err != 0) return err;
  const size_t smem = wgmma_smem_bytes<NP>();
  auto kernel = flash_wgmma_kernel<NP>;
  cudaError_t e = attn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bq = attn::kMaxRows / g;
  const long long blocks =
      static_cast<long long>(B) * kvh * ((S + bq - 1) / bq);
  kernel<<<static_cast<unsigned>(blocks), kWgThreads, smem, stream>>>(
      tmap_k, tmap_v, q, out, B, S, kvh, g, dh, bq,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// -- the 3xTF32 tensor-core kernel (float32, Dh % 8 == 0) -------------------
// Tiles a block: NP 32-column panels of Dh (32 float32 columns are one
// 128-byte swizzled row), kTile keys a K/V tile, kStages TMA stages.
template <int NP>
struct Tf32Cfg;
template <>
struct Tf32Cfg<1> { static constexpr int kTile = 64, kStages = 2; };
template <>
struct Tf32Cfg<2> { static constexpr int kTile = 64, kStages = 2; };
template <>
struct Tf32Cfg<4> { static constexpr int kTile = 32, kStages = 2; };
template <>
struct Tf32Cfg<6> { static constexpr int kTile = 32, kStages = 1; };

constexpr uint32_t kQPanel32 = 64 * hopper::kRowBytes;  // [64 rows][32 f32]

// Bytes of one tile-sized buffer: a K or V tile ([NP][kTile keys][128 B])
// and a transposed V tile ([kTile / 32][32 NP columns][128 B]) alike.
template <int NP>
__host__ __device__ constexpr uint32_t tf32_tile_bytes() {
  return Tf32Cfg<NP>::kTile * NP * hopper::kRowBytes;
}

// Dynamic shared memory of a block: Q_hi and Q_lo, kStages K and V tiles,
// the derived K_lo, V^T_hi and V^T_lo, 2 * kStages mbarriers, and 1024
// bytes to align the tiles (the header's table).
template <int NP>
constexpr size_t tf32_smem_bytes() {
  return 1024 + 2 * kQPanel32 * NP +
         tf32_tile_bytes<NP>() * (2 * Tf32Cfg<NP>::kStages + 3) +
         2 * Tf32Cfg<NP>::kStages * 8;
}

static_assert(tf32_smem_bytes<1>() == 74784, "the header's table");
static_assert(tf32_smem_bytes<2>() == 148512, "the header's table");
static_assert(tf32_smem_bytes<4>() == 181280, "the header's table");
static_assert(tf32_smem_bytes<6>() == 222224, "the header's table");
static_assert(tf32_smem_bytes<6>() <= 232448,
              "NP = 6 must fit an H100 block's shared memory");

template <int NP>   // Dh padded to 32 * NP columns
__global__ void __launch_bounds__(kWgThreads, 1)
flash_tf32x3_kernel(const __grid_constant__ CUtensorMap tmap_k,
                    const __grid_constant__ CUtensorMap tmap_v,
                    const float* __restrict__ q, float* __restrict__ out,
                    int B, int S, int kvh, int g, int dh, int bq,
                    float scale_log2) {
  constexpr int KT = Tf32Cfg<NP>::kTile, ST = Tf32Cfg<NP>::kStages;
  // P.V: at NP <= 4 into a fresh accumulator a tile, NCH chunks of NC
  // output columns, added into O in float32; at NP = 6 into O itself (a
  // chunk's accumulator beside O's 96 registers spills)
  constexpr bool kFresh = NP <= 4;
  constexpr int NCH = NP <= 2 ? 1 : 2, NC = 32 * NP / NCH;
  constexpr uint32_t T = tf32_tile_bytes<NP>();
  constexpr uint32_t kKPanel = KT * hopper::kRowBytes;        // 32 columns
  constexpr uint32_t kVtPanel = 32 * NP * hopper::kRowBytes;  // 32 keys
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) &
                              1023);
  uint8_t* qhi = base;                      // [NP][64][128 B]
  uint8_t* qlo = qhi + kQPanel32 * NP;
  uint8_t* k_s = qlo + kQPanel32 * NP;      // [ST] K tiles, tf32 hi in place
  uint8_t* v_s = k_s + T * ST;              // [ST] V tiles
  uint8_t* klo = v_s + T * ST;              // K_lo, K's layout
  uint8_t* vthi = klo + T;                  // [KT / 32][32 NP][128 B]
  uint8_t* vtlo = vthi + T;
  uint64_t* full = reinterpret_cast<uint64_t*>(vtlo + T);
  uint64_t* empty = full + ST;

  const int n_qb = (S + bq - 1) / bq;
  const int bhs = B * kvh;
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x) / bhs;  // heavy 1st
  const int bh = static_cast<int>(blockIdx.x) % bhs;
  const int b = bh / kvh;
  const int h = bh - b * kvh;
  const int s0 = qb * bq;
  const int n_pos = min(bq, S - s0);
  const int n_rows = n_pos * g;
  const int n_tiles = (s0 + n_pos + KT - 1) / KT;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < ST; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {                 // the producer warp
    if (tid == kConsumers) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST, round = j / ST;
        if (round > 0) hopper::mbar_wait(&empty[st], (round - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[st], 2 * T);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          hopper::tma_load_4d(k_s + T * st + kKPanel * p, &tmap_k, &full[st],
                              32 * p, h, j * KT, b);
          hopper::tma_load_4d(v_s + T * st + kKPanel * p, &tmap_v, &full[st],
                              32 * p, h, j * KT, b);
        }
      }
    }
    return;
  }

  // Q * Dh^-0.5 * log2(e) as tf32 hi and lo, swizzled, zero in padding
  // rows and columns.
  for (int i = tid; i < 64 * NP * 8; i += kConsumers) {
    const int r = i / (NP * 8), c4 = i - r * (NP * 8);
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n_rows && c4 * 4 < dh) {
      const long long row = ((static_cast<long long>(b) * S + s0 + r / g) *
                                 kvh + h) * g + r % g;
      const float4 val =
          *reinterpret_cast<const float4*>(q + row * dh + c4 * 4);
      x[0] = val.x * scale_log2;
      x[1] = val.y * scale_log2;
      x[2] = val.z * scale_log2;
      x[3] = val.w * scale_log2;
    }
    uint4 hi, lo;
    hopper::split4_tf32(x, hi, lo);
    const uint32_t off = kQPanel32 * (c4 >> 3) + hopper::swizzle128(r, c4 & 7);
    *reinterpret_cast<uint4*>(qhi + off) = hi;
    *reinterpret_cast<uint4*>(qlo + off) = lo;
  }
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, kConsumers);

  // This thread's two rows of the m64 accumulator layout, and its columns
  // 8 j + 2 (lane % 4) + {0, 1} of every n8 block j.
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = 16 * warp + (lane >> 2), row1 = row0 + 8;
  const int pos0 = s0 + row0 / g, pos1 = s0 + row1 / g;
  const int col = 2 * (lane & 3);
  float o[16 * NP];
#pragma unroll
  for (int i = 0; i < 16 * NP; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const uint64_t q_hi_desc = hopper::desc128(qhi, 16, 1024);
  const uint64_t q_lo_desc = hopper::desc128(qlo, 16, 1024);
  const uint64_t k_lo_desc = hopper::desc128(klo, 16, 1024);
  const uint64_t vt_hi_desc = hopper::desc128(vthi, 16, 1024);
  const uint64_t vt_lo_desc = hopper::desc128(vtlo, 16, 1024);
  const uint64_t k_hi_desc = hopper::desc128(k_s, 16, 1024);  // stage 0

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % ST;
    hopper::mbar_wait(&full[st], (j / ST) & 1);
    uint8_t* kt = k_s + T * st;
    const uint8_t* vt = v_s + T * st;
    // every warp's P.V of the last tile is done: K_lo and V^T are free
    hopper::named_barrier_sync(1, kConsumers);

    // K as tf32 hi (in place) and lo (same layout); both loops unrolled
    // whole, so that a thread's loads are all in flight at once
#pragma unroll
    for (int r = 0; r < static_cast<int>(T / 16) / kConsumers; ++r) {
      const int i = tid + r * kConsumers;
      const float4 v4 = *reinterpret_cast<const float4*>(kt + 16 * i);
      const float x[4] = {v4.x, v4.y, v4.z, v4.w};
      uint4 hi, lo;
      hopper::split4_tf32(x, hi, lo);
      *reinterpret_cast<uint4*>(kt + 16 * i) = hi;
      *reinterpret_cast<uint4*>(klo + 16 * i) = lo;
    }
    // V -> V^T hi and lo, K-major for the P.V product: column d's row of a
    // 32-key panel holds the keys of k8 slice sl at bytes 32 (sl % 4) ..,
    // even keys (2w) in its first 16-byte chunk, odd keys (2w + 1) in its
    // second: logical k < 4 is key 2k, k >= 4 key 2(k - 4) + 1, the order
    // in which P's accumulator columns sit in its tf32 A fragment.
#pragma unroll
    for (int r = 0; r < 32 * NP * (KT / 8) * 2 / kConsumers; ++r) {
      const int i = tid + r * kConsumers;
      const int d = i % (32 * NP), rest = i / (32 * NP);
      const int par = rest & 1, sl = rest >> 1;
      const uint8_t* src = vt + kKPanel * (d >> 5) + 4 * (d & 3);
      const int c = (d & 31) >> 2;
      float x[4];
#pragma unroll
      for (int w = 0; w < 4; ++w)
        x[w] = *reinterpret_cast<const float*>(
            src + hopper::swizzle128(8 * sl + par + 2 * w, c));
      uint4 hi, lo;
      hopper::split4_tf32(x, hi, lo);
      const uint32_t off =
          kVtPanel * (sl >> 2) + hopper::swizzle128(d, 2 * (sl & 3) + par);
      *reinterpret_cast<uint4*>(vthi + off) = hi;
      *reinterpret_cast<uint4*>(vtlo + off) = lo;
    }
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1, kConsumers);

    // S = Q.K^T: Q_hi K_hi + Q_hi K_lo + Q_lo K_hi a k8 slice of Dh
    float s[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;   // overwritten (scale_d 0)
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      // a slice's descriptor is its tile's plus the slice's byte offset / 16
      // (the start-address field; shared addresses stay below 2^18)
      const uint32_t oq = (kQPanel32 * (kk >> 2) + 32 * (kk & 3)) >> 4;
      const uint32_t ok = (kKPanel * (kk >> 2) + 32 * (kk & 3)) >> 4;
      const uint64_t qh = q_hi_desc + oq, ql = q_lo_desc + oq;
      const uint64_t kh = k_hi_desc + (T >> 4) * st + ok;
      const uint64_t kl = k_lo_desc + ok;
      if constexpr (KT == 32) {
        hopper::wgmma_m64n32k8_ss_tf32(s, qh, kh, kk > 0);
        hopper::wgmma_m64n32k8_ss_tf32(s, qh, kl, 1);
        hopper::wgmma_m64n32k8_ss_tf32(s, ql, kh, 1);
      } else {
        hopper::wgmma_m64n64k8_ss_tf32(s, qh, kh, kk > 0);
        hopper::wgmma_m64n64k8_ss_tf32(s, qh, kl, 1);
        hopper::wgmma_m64n64k8_ss_tf32(s, ql, kh, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);
    hopper::mbar_arrive(&empty[st]);   // stage st's K and V are read

    // mask, online softmax per row (log2 domain: Q carries log2(e))
    const bool diag = j * KT + KT - 1 > s0;  // some key > some row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int key = j * KT + 8 * (i >> 2) + col + (i & 1);
      const bool lo = (i & 2) == 0;
      float x = s[i];
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
    for (int i = 0; i < KT / 2; ++i) {
      const bool lo = (i & 2) == 0;
      const float p = exp2f(s[i] - (lo ? ms0 : ms1));   // -inf -> exactly 0
      s[i] = p;
      if (lo) sum0 += p;
      else sum1 += p;
    }
    l0 = l0 * c0 + sum0;          // this thread's columns; summed at the end
    l1 = l1 * c1 + sum1;

    // P . V^T: P's tf32 A fragments in registers, slice kk = keys 8 kk ..:
    // (row0, 2c), (row1, 2c), (row0, 2c + 1), (row1, 2c + 1) as logical
    // columns c, c, c + 4, c + 4
    uint32_t ph[KT / 8][4], pl[KT / 8][4];
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      hopper::split_tf32(s[4 * kk], ph[kk][0], pl[kk][0]);
      hopper::split_tf32(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
      hopper::split_tf32(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
      hopper::split_tf32(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }
    // kFresh: into a fresh accumulator a chunk of NC output columns, then
    // O = O * corr + chunk in float32, so that the tensor cores' own sum
    // runs over one tile's keys, never along the whole row
    if constexpr (kFresh) {
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        float t[NC / 2];
#pragma unroll
        for (int i = 0; i < NC / 2; ++i) t[i] = 0.f;  // overwritten (scale 0)
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk) {
          const uint32_t ov = (kVtPanel * (kk >> 2) +
                               NC * ch * hopper::kRowBytes + 32 * (kk & 3)) >>
                              4;
          const uint64_t vh = vt_hi_desc + ov, vl = vt_lo_desc + ov;
          if constexpr (NC == 32) {
            hopper::wgmma_m64n32k8_rs_tf32(t, ph[kk], vh, kk > 0);
            hopper::wgmma_m64n32k8_rs_tf32(t, ph[kk], vl, 1);
            hopper::wgmma_m64n32k8_rs_tf32(t, pl[kk], vh, 1);
          } else {
            hopper::wgmma_m64n64k8_rs_tf32(t, ph[kk], vh, kk > 0);
            hopper::wgmma_m64n64k8_rs_tf32(t, ph[kk], vl, 1);
            hopper::wgmma_m64n64k8_rs_tf32(t, pl[kk], vh, 1);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(t);
#pragma unroll
        for (int i = 0; i < NC / 2; ++i)
          o[NC / 2 * ch + i] =
              fmaf(o[NC / 2 * ch + i], (i & 2) == 0 ? c0 : c1, t[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16 * NP; ++i) o[i] *= (i & 2) == 0 ? c0 : c1;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 8; ++kk) {
        const uint32_t ov = (kVtPanel * (kk >> 2) + 32 * (kk & 3)) >> 4;
        const uint64_t vh = vt_hi_desc + ov, vl = vt_lo_desc + ov;
        hopper::wgmma_m64n192k8_rs_tf32(o, ph[kk], vh, 1);
        hopper::wgmma_m64n192k8_rs_tf32(o, ph[kk], vl, 1);
        hopper::wgmma_m64n192k8_rs_tf32(o, pl[kk], vh, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(o);
    }
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const long long out0 =
      (((static_cast<long long>(b) * S + pos0) * kvh + h) * g + row0 % g) *
      dh;
  const long long out1 =
      (((static_cast<long long>(b) * S + pos1) * kvh + h) * g + row1 % g) *
      dh;
#pragma unroll
  for (int jn = 0; jn < 4 * NP; ++jn) {     // n8 blocks of the output
    const int d = 8 * jn + col;
    if (d >= dh) continue;
    if (row0 < n_rows)
      *reinterpret_cast<float2*>(out + out0 + d) =
          make_float2(o[4 * jn] / den0, o[4 * jn + 1] / den0);
    if (row1 < n_rows)
      *reinterpret_cast<float2*>(out + out1 + d) =
          make_float2(o[4 * jn + 2] / den1, o[4 * jn + 3] / den1);
  }
}

template <int NP>
int launch_tf32x3(const float* q, const float* k, const float* v,
                  float* out, int B, int S, int kvh, int g, int dh,
                  float scale, cudaStream_t stream) {
  CUtensorMap tmap_k, tmap_v;
  int err = hopper::encode_bshd_f32(&tmap_k, k, B, S, kvh, dh,
                                    Tf32Cfg<NP>::kTile);
  if (err != 0) return err;
  err = hopper::encode_bshd_f32(&tmap_v, v, B, S, kvh, dh,
                                Tf32Cfg<NP>::kTile);
  if (err != 0) return err;
  const size_t smem = tf32_smem_bytes<NP>();
  auto kernel = flash_tf32x3_kernel<NP>;
  cudaError_t e = attn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bq = attn::kMaxRows / g;
  const long long blocks =
      static_cast<long long>(B) * kvh * ((S + bq - 1) / bq);
  kernel<<<static_cast<unsigned>(blocks), kWgThreads, smem, stream>>>(
      tmap_k, tmap_v, q, out, B, S, kvh, g, dh, bq,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Each function returns the
// cudaError_t of its launch (or hopper::kEncodeError + a CUresult); 0
// means the launch was accepted.
extern "C" {

int flash_attention_causal_f32(const float* q, const float* k,
                               const float* v, float* out, int B, int S,
                               int kvh, int g, int dh, float scale,
                               void* stream) {
  return launch<float>(q, k, v, out, B, S, kvh, g, dh, scale, stream);
}

int flash_attention_causal_bf16(const bf16* q, const bf16* k, const bf16* v,
                                bf16* out, int B, int S, int kvh, int g,
                                int dh, float scale, void* stream) {
  return launch<bf16>(q, k, v, out, B, S, kvh, g, dh, scale, stream);
}

// The tensor-core route: bf16, Dh % 16 == 0 (Dh <= 192), q, k, v and out
// 16-byte aligned (checked by the wrapper).
int flash_attention_causal_bf16_wgmma(const bf16* q, const bf16* k,
                                      const bf16* v, bf16* out, int B,
                                      int S, int kvh, int g, int dh,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return launch_wgmma<1>(q, k, v, out, B, S, kvh, g, dh, scale, s);
  if (dh <= 128)
    return launch_wgmma<2>(q, k, v, out, B, S, kvh, g, dh, scale, s);
  return launch_wgmma<3>(q, k, v, out, B, S, kvh, g, dh, scale, s);
}

// The 3xTF32 tensor-core route: float32, Dh % 8 == 0 (Dh <= 192), q, k, v
// and out 16-byte aligned (checked by the wrapper).
int flash_attention_causal_f32_tf32x3(const float* q, const float* k,
                                      const float* v, float* out, int B,
                                      int S, int kvh, int g, int dh,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 32)
    return launch_tf32x3<1>(q, k, v, out, B, S, kvh, g, dh, scale, s);
  if (dh <= 64)
    return launch_tf32x3<2>(q, k, v, out, B, S, kvh, g, dh, scale, s);
  if (dh <= 128)
    return launch_tf32x3<4>(q, k, v, out, B, S, kvh, g, dh, scale, s);
  return launch_tf32x3<6>(q, k, v, out, B, S, kvh, g, dh, scale, s);
}

}  // extern "C"
