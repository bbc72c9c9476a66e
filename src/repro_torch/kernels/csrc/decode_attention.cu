// Grouped-query flash-decode attention, for sm_90a.
//
// Replaces the Pallas TPU kernel decode_attention of
// src/repro/kernels/decode_attention.py (_decode_kernel, pallas_call at
// :81): one query token per sequence attending over its KV cache, masked
// at kv_len, with a float32 online softmax.
//
//   q      [B, KvH, G, Dh]   (query head h = kvh * G + g)
//   k, v   [B, T, KvH, Dh]
//   kv_len [B] i32           keys [0, kv_len[b]) are visible (clamped to T)
//   out    [B, KvH, G, Dh]   in q's dtype; a row with kv_len = 0 is zeros
//
// Design: one thread block of 4 warps per (b, kv-head); the block's G
// query rows share every K/V tile it loads (the GQA reuse the Pallas
// kernel gets from its [G, Dh] q block), rows go to the warps round-robin
// (RPW = ceil(G / 4) rows a warp). Where the Pallas grid walks every T
// block of the padded cache, this block stops at kv_len[b]: positions past
// it are never read, so T needs no padding and a short sequence in a long
// cache costs its own length. The tile loop and the softmax are
// attention.cuh's.
//
// What bounds it: bytes. The call must read q, the first kv_len[b] rows of
// K and V of each sequence, and write out; per key it does 4 * G * Dh
// flops against 2 * Dh elements read, G <= 32 flops per byte of bf16, far
// under the H100's ~295 (bf16 tensor cores) or ~20 (float32 CUDA cores)
// flops per byte of HBM bandwidth. At the serving shapes (B = 8 slots,
// KvH = 5, G = 3, Dh = 64, T = 1024) only B * KvH = 40 blocks run, one per
// SM on 40 of the 132 SMs, each loading its tiles synchronously: the
// kernel is latency-bound well above its byte bound. Splitting T across
// blocks with a combine step, and reading the page table inside the
// kernel instead of a gathered [S, T, KvH, Dh] copy, are later work
// (ROADMAP.md).
#include "attention.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T, int DPL, int RPW>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ out, int T_len, int kvh, int g, int dh,
              float scale) {
  extern __shared__ float smem[];
  __shared__ long long rows_q[attn::kMaxRows];
  __shared__ int rows_limit[attn::kMaxRows];
  const int b = blockIdx.x / kvh;
  const int h = blockIdx.x - b * kvh;
  const int len = min(max(kv_len[b], 0), T_len);
  for (int r = threadIdx.x; r < g; r += blockDim.x) {
    rows_q[r] = ((static_cast<long long>(b) * kvh + h) * g + r) * dh;
    rows_limit[r] = len;
  }
  __syncthreads();
  const long long kv_base = (static_cast<long long>(b) * T_len * kvh + h) * dh;
  attn::attend_rows<T, DPL, RPW>(q, k, v, out, rows_q, rows_limit, g, len,
                                 kv_base, static_cast<long long>(kvh) * dh,
                                 dh, scale, smem);
}

template <typename T, int DPL, int RPW>
int launch_rpw(const T* q, const T* k, const T* v, const int* kv_len, T* out,
               int B, int T_len, int kvh, int g, int dh, float scale,
               cudaStream_t stream) {
  const size_t smem = attn::smem_bytes(g, dh);
  auto kernel = decode_kernel<T, DPL, RPW>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * kvh, kWarps * 32, smem, stream>>>(q, k, v, kv_len, out, T_len,
                                                 kvh, g, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DPL>
int launch_dpl(const T* q, const T* k, const T* v, const int* kv_len, T* out,
               int B, int T_len, int kvh, int g, int dh, float scale,
               cudaStream_t stream) {
  const int rpw = (g + kWarps - 1) / kWarps;
  if (rpw <= 1)
    return launch_rpw<T, DPL, 1>(q, k, v, kv_len, out, B, T_len, kvh, g, dh,
                                 scale, stream);
  if (rpw <= 2)
    return launch_rpw<T, DPL, 2>(q, k, v, kv_len, out, B, T_len, kvh, g, dh,
                                 scale, stream);
  if (rpw <= 4)
    return launch_rpw<T, DPL, 4>(q, k, v, kv_len, out, B, T_len, kvh, g, dh,
                                 scale, stream);
  return launch_rpw<T, DPL, 8>(q, k, v, kv_len, out, B, T_len, kvh, g, dh,
                               scale, stream);
}

// Shapes are checked by the Python wrapper: 1 <= G <= 32, 1 <= Dh <= 128.
template <typename T>
int launch(const T* q, const T* k, const T* v, const int* kv_len, T* out,
           int B, int T_len, int kvh, int g, int dh, float scale,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 32)
    return launch_dpl<T, 1>(q, k, v, kv_len, out, B, T_len, kvh, g, dh,
                            scale, s);
  if (dh <= 64)
    return launch_dpl<T, 2>(q, k, v, kv_len, out, B, T_len, kvh, g, dh,
                            scale, s);
  return launch_dpl<T, 4>(q, k, v, kv_len, out, B, T_len, kvh, g, dh, scale,
                          s);
}

}  // namespace

// Plain C interface (loaded with ctypes). Each function returns the
// cudaError_t of its launch; 0 means the launch was accepted.
extern "C" {

int decode_attention_f32(const float* q, const float* k, const float* v,
                         const int* kv_len, float* out, int B, int T_len,
                         int kvh, int g, int dh, float scale, void* stream) {
  return launch<float>(q, k, v, kv_len, out, B, T_len, kvh, g, dh, scale,
                       stream);
}

int decode_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const int* kv_len,
                          __nv_bfloat16* out, int B, int T_len, int kvh,
                          int g, int dh, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, out, B, T_len, kvh, g, dh,
                               scale, stream);
}

}  // extern "C"
