// The backward of causal grouped-query flash attention (prefill), for
// sm_90a: dq, dk and dv of flash_attention.cu's function.
//
// The TPU side has no Pallas backward: the reference trains through the
// blockwise jnp attention that XLA differentiates
// (src/repro/models/layers.py:109-138), and the Pallas kernel it replaces
// in the forward is flash_attention_causal of
// src/repro/kernels/flash_attention.py (pallas_call at :88). This is the
// gradient of that function, in the port's layout:
//
//   q, out, dout   [B, S, KvH, G, Dh]   (query head h = kvh * G + g)
//   k, v           [B, S, KvH, Dh]
//   dq             [B, S, KvH, G, Dh],  dk, dv [B, S, KvH, Dh]   in q's dtype
//
// with s_ij = (Dh^-0.5 q_i) . k_j in float32 (q scaled first, as the
// forward scales it), key j visible to query position i iff j <= i, and
//
//   P_ij  = exp(s_ij - lse_i)            lse_i = log sum_j<=i exp(s_ij)
//   D_i   = sum_d dout_id out_id
//   dP_ij = dout_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dv_j  = sum_{i >= j, g} P_ij dout_i
//   dk_j  = sum_{i >= j, g} dS_ij (Dh^-0.5 q_i)
//   dq_i  = Dh^-0.5 sum_{j <= i} dS_ij k_j
//
// all accumulated in float32. Three kernels, launched in this order by
// the wrapper (kernels/flash_attention.py), none with an atomic, so two
// calls on the same inputs give the same bits:
//
// * stats_kernel: one block per (b, kvh, tile of kBR query rows), rows
//   ordered (position, head) as in the forward; walks the key tiles up to
//   the tile's last position and writes each row's lse and D (float32,
//   [B, S, KvH, G]). The forward's bits stay as they are: it writes no
//   statistics.
// * dkdv_kernel: one block per (b, kvh, tile of kBK keys), heaviest (the
//   first keys) first; holds its K and V tile and walks every query row
//   at or below the tile's first key, the G heads of the group included,
//   accumulating dk and dv in registers.
// * dq_kernel: one block per (b, kvh, tile of kBR query rows), heaviest
//   (the last rows) first; walks the key tiles on or below the diagonal,
//   accumulating dq in registers.
//
// Each tile's scores and dP come from tile_dots, which the three kernels
// share, so P is computed by the same float32 operations in the same
// order everywhere; exp is the accurate expf (no fast math).
//
// What bounds it on an H100: operations. The causal backward does about
// 8 Dh flops a (query head, key <= query) pair (recomputing S and dP,
// then dv, dk and dq), S (S + 1) / 2 pairs a head; its bytes (q, k, v,
// out, dout read once, dq, dk, dv written once) take ~0.1 ms at the
// training shape (B = 8, S = 2048, KvH = 5, G = 3, Dh = 64), its flops
// milliseconds even on the tensor cores. This design computes them on
// the CUDA cores in float32 from shared memory (each thread a 2 x 4
// block of (row, key) scores, then a key's (or row's) slice of columns),
// bound by shared-memory loads, and recomputes S and dP once more for
// dq. It serves what the tensor-core kernels do not take: float32 with
// Dh not a multiple of 8, bf16 with Dh not a multiple of 16, and any
// tensor not 16-byte aligned (TMA needs it). bf16 with Dh % 16 == 0 (up
// to 192) takes flash_attention_bwd_wgmma.cu, float32 with Dh % 8 == 0
// (up to 192) flash_attention_bwd_tf32x3.cu (3xTF32 on the tensor cores:
// one TF32 product would not hold the tolerance); the wrapper picks by
// dtype, shape and alignment before the launch.
#include "attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBR = 32;          // query rows a tile
constexpr int kBK = 64;          // keys a tile
constexpr int kLdP = kBK + 1;    // row stride of the P / dS tiles

using attn::from_f32;
using attn::to_f32;
using bf16 = __nv_bfloat16;

// Floats of dynamic shared memory: K and V tiles [kBK][dh + 1], Q and dO
// tiles [kBR][dh + 1], P and dS tiles [kBR][kLdP].
inline size_t smem_floats(int dh) {
  const size_t ld = static_cast<size_t>(dh) + 1;
  return 2 * kBK * ld + 2 * kBR * ld + 2 * kBR * kLdP;
}

// Row r of a (b, kvh) pair's query rows: position r / g, head r % g.
__device__ __forceinline__ long long row_index(int b, int S, int kvh, int h,
                                               int g, int r) {
  const int pos = r / g;
  return ((static_cast<long long>(b) * S + pos) * kvh + h) * g + (r - pos * g);
}

// Thread t scores rows ry = t / 16 and ry + 16 of the tile against keys
// kx = t % 16 + 16 c (c < 4): s = Qs . Ks and, with kDp, dp = dOs . Vs,
// summed over d in order with fmaf.
template <bool kDp>
__device__ __forceinline__ void tile_dots(const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs,
                                          int dh, int ld, float (&s)[2][4],
                                          float (&dp)[2][4]) {
  const int kx = threadIdx.x & 15, ry = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
  for (int d = 0; d < dh; ++d) {
    float qv[2], kv[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) qv[i] = Qs[(ry + 16 * i) * ld + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) kv[c] = Ks[(kx + 16 * c) * ld + d];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    if (kDp) {
      float ov[2], vv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ov[i] = dOs[(ry + 16 * i) * ld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = Vs[(kx + 16 * c) * ld + d];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
    }
  }
}

// P and dS of the tile: keys j0 + key for key < n_keys, visible to row r
// iff j0 + key <= rpos[r] (rpos = -1 for rows past the end). Writes dS,
// and P with kWantP.
template <bool kWantP>
__device__ __forceinline__ void tile_p_ds(const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs,
                                          const float* lse_s,
                                          const float* d_s, const int* rpos,
                                          int j0, int n_keys, int dh, int ld,
                                          float* Ps, float* dSs) {
  float s[2][4], dp[2][4];
  tile_dots<true>(Qs, dOs, Ks, Vs, dh, ld, s, dp);
  const int kx = threadIdx.x & 15, ry = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ry + 16 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = kx + 16 * c;
      const bool vis = key < n_keys && j0 + key <= rpos[r];
      const float p = vis ? expf(s[i][c] - lse_s[r]) : 0.f;
      if (kWantP) Ps[r * kLdP + key] = p;
      dSs[r * kLdP + key] = vis ? p * (dp[i][c] - d_s[r]) : 0.f;
    }
  }
}

// Load rows [r0, r0 + n_r) of the (b, h) pair: their metadata, q scaled
// into Qs and dout into dOs (zeros past n_r). Ends before a barrier.
template <typename T>
__device__ void load_rows(const T* q, const T* dout, const float* lse,
                          const float* dvec, int b, int S, int kvh, int h,
                          int g, int dh, int ld, float scale, int r0, int n_r,
                          float* Qs, float* dOs, float* lse_s, float* d_s,
                          int* rpos) {
  for (int r = threadIdx.x; r < kBR; r += blockDim.x) {
    if (r < n_r) {
      const long long idx = row_index(b, S, kvh, h, g, r0 + r);
      rpos[r] = (r0 + r) / g;
      if (lse != nullptr) {
        lse_s[r] = lse[idx];
        d_s[r] = dvec[idx];
      }
    } else {
      rpos[r] = -1;
      if (lse != nullptr) lse_s[r] = d_s[r] = 0.f;
    }
  }
  for (int i = threadIdx.x; i < kBR * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh;
    float qv = 0.f, ov = 0.f;
    if (r < n_r) {
      const long long off = row_index(b, S, kvh, h, g, r0 + r) * dh + d;
      qv = to_f32(q[off]) * scale;
      if (dout != nullptr) ov = to_f32(dout[off]);
    }
    Qs[r * ld + d] = qv;
    if (dOs != nullptr) dOs[r * ld + d] = ov;
  }
}

// Load keys [j0, j0 + n_keys) of the (b, h) pair into Ks (and Vs), zeros
// past n_keys.
template <typename T>
__device__ void load_keys(const T* k, const T* v, long long kv_base,
                          long long kv_stride, int dh, int ld, int j0,
                          int n_keys, float* Ks, float* Vs) {
  for (int i = threadIdx.x; i < kBK * dh; i += blockDim.x) {
    const int key = i / dh, d = i - key * dh;
    float kx = 0.f, vx = 0.f;
    if (key < n_keys) {
      const long long off = kv_base + (j0 + key) * kv_stride + d;
      kx = to_f32(k[off]);
      if (v != nullptr) vx = to_f32(v[off]);
    }
    Ks[key * ld + d] = kx;
    if (Vs != nullptr) Vs[key * ld + d] = vx;
  }
}

// -- lse and D of every query row -------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ lse, float* __restrict__ dvec, int B, int S,
             int kvh, int g, int dh, float scale) {
  extern __shared__ float smem[];
  __shared__ float red_m[kBR][16], red_l[kBR][16];
  __shared__ int rpos[kBR];
  const int ld = dh + 1;
  float* Ks = smem;
  float* Qs = Ks + kBK * ld;
  const int n_rt = (S * g + kBR - 1) / kBR;
  const int bh = blockIdx.x % (B * kvh);
  const int rt = n_rt - 1 - static_cast<int>(blockIdx.x / (B * kvh));
  const int b = bh / kvh, h = bh - b * kvh;
  const int r0 = rt * kBR;
  const int n_r = min(kBR, S * g - r0);
  const long long kv_base = (static_cast<long long>(b) * S * kvh + h) * dh;
  const long long kv_stride = static_cast<long long>(kvh) * dh;
  load_rows<T>(q, nullptr, nullptr, nullptr, b, S, kvh, h, g, dh, ld, scale,
               r0, n_r, Qs, nullptr, nullptr, nullptr, rpos);

  const int kx = threadIdx.x & 15, ry = threadIdx.x >> 4;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int key_end = (r0 + n_r - 1) / g + 1;
  for (int j0 = 0; j0 < key_end; j0 += kBK) {
    const int n_keys = min(kBK, key_end - j0);
    __syncthreads();                 // previous tile consumed
    load_keys<T>(k, nullptr, kv_base, kv_stride, dh, ld, j0, n_keys, Ks,
                 nullptr);
    __syncthreads();
    float s[2][4], unused[2][4];
    tile_dots<false>(Qs, nullptr, Ks, nullptr, dh, ld, s, unused);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ry + 16 * i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kx + 16 * c;
        if (key < n_keys && j0 + key <= rpos[r]) {
          const float m_new = fmaxf(m[i], s[i][c]);
          l[i] = l[i] * expf(m[i] - m_new) + expf(s[i][c] - m_new);
          m[i] = m_new;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    red_m[ry + 16 * i][kx] = m[i];
    red_l[ry + 16 * i][kx] = l[i];
  }
  __syncthreads();
  if (threadIdx.x < n_r) {
    const int r = threadIdx.x;
    float mx = -INFINITY;
    for (int x = 0; x < 16; ++x) mx = fmaxf(mx, red_m[r][x]);
    float sum = 0.f;
    for (int x = 0; x < 16; ++x)
      if (red_l[r][x] > 0.f) sum += red_l[r][x] * expf(red_m[r][x] - mx);
    const long long idx = row_index(b, S, kvh, h, g, r0 + r);
    lse[idx] = mx + logf(sum);       // key 0 is visible: sum >= 1
    // D = sum_d dout . out: one fmaf chain in order of d on the float32
    // values of dout and out, as tile_dots sums dP = dout . v. Where out
    // is a key's v (S = 1: P = 1, out = v_0), dP - D is then exactly 0,
    // as the true dS is.
    float dsum = 0.f;
    for (int d = 0; d < dh; ++d)
      dsum = fmaf(to_f32(dout[idx * dh + d]), to_f32(out[idx * dh + d]),
                  dsum);
    dvec[idx] = dsum;
  }
}

// -- dk and dv: one block a key tile ---------------------------------------
// NC = ceil(Dh / 4) columns a thread (16, 32 or 48).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dvec,
            T* __restrict__ dk, T* __restrict__ dv, int B, int S, int kvh,
            int g, int dh, float scale) {
  extern __shared__ float smem[];
  __shared__ float lse_s[kBR], d_s[kBR];
  __shared__ int rpos[kBR];
  const int ld = dh + 1;
  float* Ks = smem;
  float* Vs = Ks + kBK * ld;
  float* Qs = Vs + kBK * ld;
  float* dOs = Qs + kBR * ld;
  float* Ps = dOs + kBR * ld;
  float* dSs = Ps + kBR * kLdP;
  const int bh = blockIdx.x % (B * kvh);
  const int kt = static_cast<int>(blockIdx.x / (B * kvh));
  const int b = bh / kvh, h = bh - b * kvh;
  const int j0 = kt * kBK;
  const int n_keys = min(kBK, S - j0);
  const long long kv_base = (static_cast<long long>(b) * S * kvh + h) * dh;
  const long long kv_stride = static_cast<long long>(kvh) * dh;
  load_keys<T>(k, v, kv_base, kv_stride, dh, ld, j0, n_keys, Ks, Vs);

  const int key = threadIdx.x & (kBK - 1), dg = threadIdx.x / kBK;
  float acc_k[NC], acc_v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc_k[c] = acc_v[c] = 0.f;

  const int n_rows = S * g;
  for (int r0 = j0 * g; r0 < n_rows; r0 += kBR) {
    const int n_r = min(kBR, n_rows - r0);
    __syncthreads();                 // previous tile consumed
    load_rows<T>(q, dout, lse, dvec, b, S, kvh, h, g, dh, ld, scale, r0, n_r,
                 Qs, dOs, lse_s, d_s, rpos);
    __syncthreads();
    tile_p_ds<true>(Qs, dOs, Ks, Vs, lse_s, d_s, rpos, j0, n_keys, dh, ld, Ps,
                    dSs);
    __syncthreads();
    for (int r = 0; r < n_r; ++r) {
      const float p = Ps[r * kLdP + key];
      const float ds = dSs[r * kLdP + key];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = dg + 4 * c;
        if (d < dh) {
          acc_v[c] = fmaf(p, dOs[r * ld + d], acc_v[c]);
          acc_k[c] = fmaf(ds, Qs[r * ld + d], acc_k[c]);
        }
      }
    }
  }
  if (key < n_keys) {
    const long long base = kv_base + (j0 + key) * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = dg + 4 * c;
      if (d < dh) {
        dk[base + d] = from_f32<T>(acc_k[c]);
        dv[base + d] = from_f32<T>(acc_v[c]);
      }
    }
  }
}

// -- dq: one block a query-row tile ----------------------------------------
// NC = ceil(Dh / 8) columns a thread (8, 16 or 24).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dvec,
          T* __restrict__ dq, int B, int S, int kvh, int g, int dh,
          float scale) {
  extern __shared__ float smem[];
  __shared__ float lse_s[kBR], d_s[kBR];
  __shared__ int rpos[kBR];
  const int ld = dh + 1;
  float* Ks = smem;
  float* Vs = Ks + kBK * ld;
  float* Qs = Vs + kBK * ld;
  float* dOs = Qs + kBR * ld;
  float* dSs = dOs + kBR * ld;
  const int n_rt = (S * g + kBR - 1) / kBR;
  const int bh = blockIdx.x % (B * kvh);
  const int rt = n_rt - 1 - static_cast<int>(blockIdx.x / (B * kvh));
  const int b = bh / kvh, h = bh - b * kvh;
  const int r0 = rt * kBR;
  const int n_r = min(kBR, S * g - r0);
  const long long kv_base = (static_cast<long long>(b) * S * kvh + h) * dh;
  const long long kv_stride = static_cast<long long>(kvh) * dh;
  load_rows<T>(q, dout, lse, dvec, b, S, kvh, h, g, dh, ld, scale, r0, n_r,
               Qs, dOs, lse_s, d_s, rpos);

  const int r = threadIdx.x & (kBR - 1), dg = threadIdx.x / kBR;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  const int key_end = (r0 + n_r - 1) / g + 1;
  for (int j0 = 0; j0 < key_end; j0 += kBK) {
    const int n_keys = min(kBK, key_end - j0);
    __syncthreads();                 // previous tile consumed
    load_keys<T>(k, v, kv_base, kv_stride, dh, ld, j0, n_keys, Ks, Vs);
    __syncthreads();
    tile_p_ds<false>(Qs, dOs, Ks, Vs, lse_s, d_s, rpos, j0, n_keys, dh, ld,
                     nullptr, dSs);
    __syncthreads();
    for (int key = 0; key < n_keys; ++key) {
      const float ds = dSs[r * kLdP + key];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = dg + 8 * c;
        if (d < dh) acc[c] = fmaf(ds, Ks[key * ld + d], acc[c]);
      }
    }
  }
  if (r < n_r) {
    const long long base = row_index(b, S, kvh, h, g, r0 + r) * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = dg + 8 * c;
      if (d < dh) dq[base + d] = from_f32<T>(acc[c] * scale);
    }
  }
}

inline long long row_blocks(int B, int S, int kvh, int g) {
  return static_cast<long long>(B) * kvh * ((static_cast<long long>(S) * g +
                                             kBR - 1) / kBR);
}

// Shapes are checked by the Python wrapper: 1 <= G <= 32, 1 <= Dh <= 192.
template <typename T>
int stats(const T* q, const T* k, const T* out, const T* dout, float* lse,
          float* dvec, int B, int S, int kvh, int g, int dh, float scale,
          void* stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBK) + kBR) * (dh + 1);
  auto kernel = stats_kernel<T>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(row_blocks(B, S, kvh, g)), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(q, k, out, dout, lse, dvec,
                                                B, S, kvh, g, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
int dkdv_nc(const T* q, const T* k, const T* v, const T* dout,
            const float* lse, const float* dvec, T* dk, T* dv, int B, int S,
            int kvh, int g, int dh, float scale, void* stream) {
  const size_t smem = sizeof(float) * smem_floats(dh);
  auto kernel = dkdv_kernel<T, NC>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(B) * kvh * ((S + kBK - 1) / kBK);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(q, k, v, dout, lse, dvec, dk,
                                                dv, B, S, kvh, g, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dkdv(const T* q, const T* k, const T* v, const T* dout, const float* lse,
         const float* dvec, T* dk, T* dv, int B, int S, int kvh, int g,
         int dh, float scale, void* stream) {
  if (dh <= 64)
    return dkdv_nc<T, 16>(q, k, v, dout, lse, dvec, dk, dv, B, S, kvh, g, dh,
                          scale, stream);
  if (dh <= 128)
    return dkdv_nc<T, 32>(q, k, v, dout, lse, dvec, dk, dv, B, S, kvh, g, dh,
                          scale, stream);
  return dkdv_nc<T, 48>(q, k, v, dout, lse, dvec, dk, dv, B, S, kvh, g, dh,
                        scale, stream);
}

template <typename T, int NC>
int dq_nc(const T* q, const T* k, const T* v, const T* dout, const float* lse,
          const float* dvec, T* dq, int B, int S, int kvh, int g, int dh,
          float scale, void* stream) {
  const size_t smem = sizeof(float) * smem_floats(dh);
  auto kernel = dq_kernel<T, NC>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(row_blocks(B, S, kvh, g)), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(q, k, v, dout, lse, dvec, dq,
                                                B, S, kvh, g, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq(const T* q, const T* k, const T* v, const T* dout, const float* lse,
       const float* dvec, T* dqo, int B, int S, int kvh, int g, int dh,
       float scale, void* stream) {
  if (dh <= 64)
    return dq_nc<T, 8>(q, k, v, dout, lse, dvec, dqo, B, S, kvh, g, dh, scale,
                       stream);
  if (dh <= 128)
    return dq_nc<T, 16>(q, k, v, dout, lse, dvec, dqo, B, S, kvh, g, dh,
                        scale, stream);
  return dq_nc<T, 24>(q, k, v, dout, lse, dvec, dqo, B, S, kvh, g, dh, scale,
                      stream);
}

}  // namespace

// Plain C interface (loaded with ctypes). Each function returns the
// cudaError_t of its launch; 0 means the launch was accepted. lse and
// dvec are float32 [B, S, KvH, G] scratch: written by the stats
// function, read by the other two.
extern "C" {

int flash_attention_causal_bwd_stats_f32(const float* q, const float* k,
                                         const float* out, const float* dout,
                                         float* lse, float* dvec, int B,
                                         int S, int kvh, int g, int dh,
                                         float scale, void* stream) {
  return stats<float>(q, k, out, dout, lse, dvec, B, S, kvh, g, dh, scale,
                      stream);
}

int flash_attention_causal_bwd_stats_bf16(const bf16* q, const bf16* k,
                                          const bf16* out, const bf16* dout,
                                          float* lse, float* dvec, int B,
                                          int S, int kvh, int g, int dh,
                                          float scale, void* stream) {
  return stats<bf16>(q, k, out, dout, lse, dvec, B, S, kvh, g, dh, scale,
                     stream);
}

int flash_attention_causal_bwd_dkdv_f32(const float* q, const float* k,
                                        const float* v, const float* dout,
                                        const float* lse, const float* dvec,
                                        float* dk, float* dv, int B, int S,
                                        int kvh, int g, int dh, float scale,
                                        void* stream) {
  return dkdv<float>(q, k, v, dout, lse, dvec, dk, dv, B, S, kvh, g, dh,
                     scale, stream);
}

int flash_attention_causal_bwd_dkdv_bf16(const bf16* q, const bf16* k,
                                         const bf16* v, const bf16* dout,
                                         const float* lse, const float* dvec,
                                         bf16* dk, bf16* dv, int B, int S,
                                         int kvh, int g, int dh, float scale,
                                         void* stream) {
  return dkdv<bf16>(q, k, v, dout, lse, dvec, dk, dv, B, S, kvh, g, dh,
                    scale, stream);
}

int flash_attention_causal_bwd_dq_f32(const float* q, const float* k,
                                      const float* v, const float* dout,
                                      const float* lse, const float* dvec,
                                      float* dqo, int B, int S, int kvh,
                                      int g, int dh, float scale,
                                      void* stream) {
  return dq<float>(q, k, v, dout, lse, dvec, dqo, B, S, kvh, g, dh, scale,
                   stream);
}

int flash_attention_causal_bwd_dq_bf16(const bf16* q, const bf16* k,
                                       const bf16* v, const bf16* dout,
                                       const float* lse, const float* dvec,
                                       bf16* dqo, int B, int S, int kvh,
                                       int g, int dh, float scale,
                                       void* stream) {
  return dq<bf16>(q, k, v, dout, lse, dvec, dqo, B, S, kvh, g, dh, scale,
                  stream);
}

}  // extern "C"
