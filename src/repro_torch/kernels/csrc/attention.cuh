// The CUDA-core body of flash_attention.cu's flash_kernel (the shapes its
// tensor-core kernels do not take: bf16 with Dh % 16 != 0, float32 with
// Dh % 8 != 0, unaligned tensors): one thread block owns a set of query
// rows of one (batch, kv-head) pair and streams that head's keys and
// values through shared memory in tiles of kTileT positions, carrying a
// float32 online softmax per row, exactly as the Pallas kernels do:
//
//   q      = q * Dh^-0.5 (in float32)
//   s      = q . k                      masked positions at -inf
//   m_new  = max(m, max_t s)
//   m_safe = m_new if finite else 0     (a fully masked row stays finite)
//   p      = exp(s - m_safe), masked p = 0
//   corr   = exp(m - m_safe) if m finite else 0
//   l      = l * corr + sum_t p
//   acc    = acc * corr + p . v
//   out    = acc / max(l, 1e-30)        in q's dtype
//
// so a row with nothing visible gives zeros. Positions past a row's last
// visible key are never loaded: the tile loop stops at the block's last
// visible key, and an index test masks the rest of the last tile and,
// for causal rows, the diagonal. (Pallas also walks the fully masked
// tiles; there corr = 1 and p = 0, so the result is the same.) The
// tensor-core flash kernel and the decode kernel keep these semantics
// with their own bodies (flash_attention.cu, decode_attention.cu).
//
// Work split: the block's warps take the rows round-robin (row = warp +
// n_warps * r for r < RPW, so a warp holds RPW rows). In a tile, lane t
// scores key t for each of its rows (a kTileT = 32 key tile is one key per
// lane), the row max and sum are warp reductions, and for the P.V product
// each lane owns DPL = ceil(Dh / 32) output columns (d = lane + 32 j), with
// p broadcast from the key's lane by a shuffle. Q (scaled, float32) sits in
// shared memory for the whole loop; K rows are padded to Dh + 1 floats so
// that 32 lanes reading 32 keys hit 32 banks.
//
// What bounds it on an H100: operations (each K/V tile is reused by up to
// 64 rows). It computes them on the CUDA cores in float32 with plain
// coalesced loads, far from the card's rates: the common shapes take the
// tensor-core kernels instead (flash_attention.cu's header).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace attn {

constexpr int kTileT = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A block holds at most this many query rows.
constexpr int kMaxRows = 64;

// Shared-memory bytes for n_rows query rows of width dh.
inline size_t smem_bytes(int n_rows, int dh) {
  return sizeof(float) * (static_cast<size_t>(n_rows) * dh +
                          static_cast<size_t>(kTileT) * (dh + 1) +
                          static_cast<size_t>(kTileT) * dh);
}

// The block body. rows_q[r] is the element offset of row r in q (and in
// out, which has q's layout), rows_limit[r] the row's visible keys
// [0, limit); both live in shared memory, filled by the caller and
// followed by __syncthreads(). Key position t of the block's head is the
// K/V row at element offset kv_base + t * kv_stride; keys [0, key_end)
// are walked.
template <typename T, int DPL, int RPW>
__device__ void attend_rows(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            const long long* rows_q, const int* rows_limit,
                            int n_rows, int key_end, long long kv_base,
                            long long kv_stride, int dh, float scale,
                            float* smem) {
  float* qs = smem;                                  // [n_rows][dh]
  float* ks = qs + static_cast<size_t>(n_rows) * dh;  // [kTileT][dh + 1]
  float* vs = ks + static_cast<size_t>(kTileT) * (dh + 1);  // [kTileT][dh]
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_warps = n_threads >> 5;

  for (int i = tid; i < n_rows * dh; i += n_threads) {
    const int r = i / dh, d = i - r * dh;
    qs[i] = to_f32(q[rows_q[r] + d]) * scale;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }

  for (int t0 = 0; t0 < key_end; t0 += kTileT) {
    const int n_t = min(kTileT, key_end - t0);
    __syncthreads();  // previous tile consumed (and qs written, first time)
    for (int i = tid; i < n_t * dh; i += n_threads) {
      const int t = i / dh, d = i - t * dh;
      const long long off = kv_base + (t0 + t) * kv_stride + d;
      ks[t * (dh + 1) + d] = to_f32(k[off]);
      vs[t * dh + d] = to_f32(v[off]);
    }
    __syncthreads();

    const int key = t0 + lane;
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    if (lane < n_t) {
      const float* krow = ks + lane * (dh + 1);
      for (int d = 0; d < dh; ++d) {
        const float kd = krow[d];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int row = warp + n_warps * r;
          if (row < n_rows) s[r] = fmaf(qs[row * dh + d], kd, s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp + n_warps * r;
      if (row >= n_rows) continue;          // warp-uniform
      const bool visible = lane < n_t && key < rows_limit[row];
      const float sr = visible ? s[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float p = visible ? expf(sr - m_safe) : 0.f;
      const float corr = isfinite(m[r]) ? expf(m[r] - m_safe) : 0.f;
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] *= corr;
      for (int t = 0; t < n_t; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < dh) acc[r][j] = fmaf(pt, vs[t * dh + d], acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp + n_warps * r;
    if (row >= n_rows) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < dh) out[rows_q[row] + d] = from_f32<T>(acc[r][j] / den);
    }
  }
}

// Allow more than 48 KB of dynamic shared memory where a launch needs it.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace attn
