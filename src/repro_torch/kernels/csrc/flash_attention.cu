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
// Design: one thread block of 8 warps per (b, kv-head, q-block). As in the
// Pallas kernel, the G query heads of the block's bq positions fill the
// row dimension together (bq * G <= 64 rows, bq = 64 / G), so every K/V
// tile loaded serves all of them. The block walks keys [0, last row + 1):
// tiles strictly above the diagonal are never loaded, and the triangular
// mask (key <= query position) is an index test, as is the ragged edge —
// S need not be a multiple of bq (the Pallas wrapper asserts that it is).
// The tile loop and the softmax are attention.cuh's.
//
// What bounds it: at the serving shapes (B = 1, S = 128-512, KvH = 5,
// G = 3, Dh = 64) operations. The causal work is 4 * Dh flops per
// (query head, key <= query) pair, S (S + 1) / 2 pairs a head; the bytes
// are q, k, v read once and out written once, which the H100 moves in
// about a microsecond. This kernel computes those flops on the CUDA cores
// in float32 (67 TFLOP/s peak), with two shared-memory loads per score
// FMA, not on the tensor cores with wgmma; that, TMA tile loads and a
// persistent schedule are later work (ROADMAP.md).
#include "attention.cuh"

namespace {

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

// Shapes are checked by the Python wrapper: 1 <= G <= 32, 1 <= Dh <= 128.
template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int B, int S, int kvh,
           int g, int dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 32)
    return launch_dpl<T, 1>(q, k, v, out, B, S, kvh, g, dh, scale, s);
  if (dh <= 64)
    return launch_dpl<T, 2>(q, k, v, out, B, S, kvh, g, dh, scale, s);
  return launch_dpl<T, 4>(q, k, v, out, B, S, kvh, g, dh, scale, s);
}

}  // namespace

// Plain C interface (loaded with ctypes). Each function returns the
// cudaError_t of its launch; 0 means the launch was accepted.
extern "C" {

int flash_attention_causal_f32(const float* q, const float* k,
                               const float* v, float* out, int B, int S,
                               int kvh, int g, int dh, float scale,
                               void* stream) {
  return launch<float>(q, k, v, out, B, S, kvh, g, dh, scale, stream);
}

int flash_attention_causal_bf16(const __nv_bfloat16* q,
                                const __nv_bfloat16* k,
                                const __nv_bfloat16* v, __nv_bfloat16* out,
                                int B, int S, int kvh, int g, int dh,
                                float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, S, kvh, g, dh, scale,
                               stream);
}

}  // extern "C"
