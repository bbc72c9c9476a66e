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
// Dh runs to 192 on both routes: DeepSeek-V2's MLA attends at 128 + 64
// (q_nope | q_rope) with v zero-padded to it, G = 1. Two kernels, chosen
// by the wrapper by dtype and Dh:
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
// * flash_kernel (float32, and bf16 with other Dh): the CUDA cores in
//   float32 (attention.cuh's attend_rows), 8 warps a block; float32 stays
//   there because TF32 would not hold the float32 tolerance (1e-5).
#include "attention.cuh"
#include "hopper.cuh"

namespace {

// -- the CUDA-core kernel (float32; bf16 with Dh % 16 != 0) ---------------
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

}  // extern "C"
