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
// What bounds it: bytes. The call must read q, the first kv_len[b] rows of
// K and V of each sequence, and write out; per key it does 4 * G * Dh
// flops against 2 * Dh elements read, G <= 32 flops per byte of bf16, far
// under the H100's ~295 (bf16 tensor cores) or ~20 (float32 CUDA cores)
// flops per byte of HBM bandwidth. So the design is about keeping many
// loads in flight on many SMs, on the CUDA cores in float32:
//
// * Split T over a cluster. Each (b, kv-head) sequence is split over a
//   cluster of kSplit = 8 blocks (B * KvH * 8 blocks: 320 at the serving
//   shape, against 40 for one block a sequence); block j takes keys
//   [j C, (j + 1) C) clamped to kv_len[b], C = roundup(ceil(T / 8), 32),
//   passed in by the launcher. A block whose chunk starts at or past
//   kv_len loads nothing and reports (m = -inf, l = 0).
// * Inside a block, 4 warps take the chunk's keys in key slots: LPK lanes
//   share a key, each holding W consecutive elements of Dh (one 16-byte
//   vector: 8 bf16 or 4 float32 values; W = 1 and NV elements a lane when
//   Dh is not a multiple of the vector or a pointer is not 16-byte
//   aligned), so a warp holds 32 / LPK slots and slot s takes keys s,
//   s + 16, ... (16 slots a block for bf16 at Dh = 64). A lane takes
//   kUnroll = 4 keys a step and loads the next step's keys before it
//   computes on this step's, so up to 16 vector loads a lane are in
//   flight; the first step's loads are issued before q is read. Each K/V
//   vector, once converted to float32, serves all the block's query
//   rows: q (scaled, float32) sits in shared memory, the RT * 4 dot
//   products of a step are independent chains, and their reductions over
//   a key's lanes go level by level. The rows are taken RT at a time
//   (exactly G for G <= 4; RT * W * NV <= 32), so the accumulators fit in
//   registers for every G <= 32 and a block stays under 168 registers a
//   thread: 3 blocks share an SM, and the 320 blocks of the serving shape
//   run in one wave.
// * Scores live in the log2 domain (q scaled by Dh^-0.5 * log2 e, exp2 in
//   place of exp). Each key slot keeps its own (m, l, acc) per row.
//   Partials merge in two passes — the max over the parts first, then
//   each part rescaled to it and summed in a fixed order — over the
//   block's slots (in shared memory) and then the cluster's blocks: after
//   cluster.sync(), block j of the cluster merges output elements
//   j * 128 + tid, ... from all 8 blocks' partials, read through
//   distributed shared memory in rank order, and writes them. No atomics:
//   a call's output is the same bits every time and depends on nothing
//   past kv_len.
#include <cooperative_groups.h>

#include "attention.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 8;    // blocks a cluster; a cluster is one (b, kv-head)
constexpr int kWarps = 4;
constexpr int kUnroll = 4;   // keys a lane loads a step
constexpr float kLog2e = 1.4426950408889634f;

// One load of W elements: a 16-byte vector, or one element when W = 1.
template <typename T, int W> struct Vec { using type = T; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<__nv_bfloat16, 8> { using type = uint4; };

__device__ __forceinline__ void unpack(float x, float* f) { f[0] = x; }
__device__ __forceinline__ void unpack(__nv_bfloat16 x, float* f) {
  f[0] = __bfloat162float(x);
}
__device__ __forceinline__ void unpack(const float4& x, float* f) {
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void unpack(const uint4& x, float* f) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Weight of a partial with running max m against the merged max M:
// exp2(m - M), 0 for an empty partial (m = -inf); M = -inf counts as 0.
__device__ __forceinline__ float weight(float m, float M) {
  return isfinite(m) ? exp2f(m - (isfinite(M) ? M : 0.f)) : 0.f;
}

// W floats of shared memory at p into f (16-byte aligned when W >= 4).
template <int W>
__device__ __forceinline__ void load_smem(const float* p, float* f) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) unpack(*reinterpret_cast<const float4*>(
                                              p + i), f + i);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) f[i] = p[i];
  }
}

// Shared memory of a block with `slots` key slots (kWarps * 32 / LPK):
//   q_s [RT][dh]                      the pass's q rows, scaled, float32
//   sm, sl, sw [slots][RT], sacc [slots][RT][dh]   each key slot's
//                                     partial and merge weight
//   bm, bl [RT], bacc [RT][dh]        the block's partial
inline size_t decode_smem_bytes(int slots, int rt, int dh) {
  return sizeof(float) * static_cast<size_t>(rt) *
         (dh + static_cast<size_t>(slots + 1) * (dh + 2) + slots);
}

template <typename T, int W, int LPK, int NV, int RT>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kWarps * 32, 3)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ out, int T_len, int kvh, int g, int dh,
                    int chunk, float scale_log2) {
  using V = typename Vec<T, W>::type;
  constexpr int KPW = 32 / LPK;        // keys a warp takes a step
  constexpr int SLOTS = kWarps * KPW;  // key slots of the block
  constexpr int E = W * NV;            // elements of Dh a lane holds
  constexpr int BSTEP = kUnroll * SLOTS;
  extern __shared__ float4 smem4[];    // 16-byte aligned
  float* q_s = reinterpret_cast<float*>(smem4);
  float* sm = q_s + RT * dh;
  float* sl = sm + SLOTS * RT;
  float* sw = sl + SLOTS * RT;
  float* sacc = sw + SLOTS * RT;
  float* bm = sacc + SLOTS * RT * dh;
  float* bl = bm + RT;
  float* bacc = bl + RT;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = static_cast<int>(blockIdx.x) / kSplit;
  const int b = bh / kvh;
  const int h = bh - b * kvh;
  const int len = min(max(kv_len[b], 0), T_len);
  const int t_begin = rank * chunk;
  const int t_end = min(t_begin + chunk, len);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int li = lane % LPK;
  const int slot = warp * KPW + lane / LPK;   // keys slot, slot + SLOTS, ..
  const long long kv_stride = static_cast<long long>(kvh) * dh;
  const long long kv_base =
      (static_cast<long long>(b) * T_len * kvh + h) * dh;
  // vector nv of this lane covers columns col[nv] .. col[nv] + W - 1
  int col[NV];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv) col[nv] = (li + LPK * nv) * W;

  // The kUnroll keys of this lane's slot in the step at `base`: loaded
  // when visible, zeros (and no load) otherwise.
  auto load_keys = [&](int base, V (&kr)[kUnroll][NV],
                       V (&vr)[kUnroll][NV]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * SLOTS + slot;
      const long long off = kv_base + t * kv_stride;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        if (t < t_end && col[nv] < dh) {
          kr[u][nv] = *reinterpret_cast<const V*>(k + off + col[nv]);
          vr[u][nv] = *reinterpret_cast<const V*>(v + off + col[nv]);
        } else {
          kr[u][nv] = V{};
          vr[u][nv] = V{};
        }
      }
    }
  };

  for (int r0 = 0; r0 < g; r0 += RT) {
    int base = t_begin;
    V kr[kUnroll][NV], vr[kUnroll][NV];
    load_keys(base, kr, vr);                 // in flight while q arrives
    for (int i = tid; i < RT * dh; i += kWarps * 32) {
      const int r = i / dh;
      q_s[i] = r0 + r < g
                   ? attn::to_f32(q[((static_cast<long long>(b) * kvh + h) *
                                         g + r0) * dh + i]) * scale_log2
                   : 0.f;
    }
    float m[RT], l[RT], acc[RT][E];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
    }
    __syncthreads();   // q_s written

    for (; base < t_end; base += BSTEP) {
      V kn[kUnroll][NV], vn[kUnroll][NV];
      load_keys(base + BSTEP, kn, vn);       // next step's loads in flight
      float kf[kUnroll][E];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) unpack(kr[u][nv], &kf[u][W * nv]);
      // scores: RT * kUnroll independent dot products, then their
      // reductions over the key's LPK lanes, level by level
      float sc[kUnroll][RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) sc[u][r] = 0.f;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) {
          if (col[nv] >= dh) continue;
          float qf[W];
          load_smem<W>(q_s + r * dh + col[nv], qf);
#pragma unroll
          for (int w = 0; w < W; ++w)
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
              sc[u][r] = fmaf(qf[w], kf[u][W * nv + w], sc[u][r]);
        }
      }
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], o);
      // online softmax per row: sc becomes p, exactly 0 where masked
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (base + u * SLOTS + slot >= t_end) sc[u][r] = -INFINITY;
          mx = fmaxf(mx, sc[u][r]);
        }
        const float corr = weight(m[r], mx);
        const float ms = isfinite(mx) ? mx : 0.f;
        m[r] = mx;
        l[r] *= corr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] *= corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          sc[u][r] = exp2f(sc[u][r] - ms);     // exp2(-inf) = 0
          l[r] += sc[u][r];
        }
      }
      // acc += p . v, key by key
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float vf[E];
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) unpack(vr[u][nv], &vf[W * nv]);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[r][e] = fmaf(sc[u][r], vf[e], acc[r][e]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) {
          kr[u][nv] = kn[u][nv];
          vr[u][nv] = vn[u][nv];
        }
    }

    // each key slot's partial to shared memory
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (li == 0) {
        sm[slot * RT + r] = m[r];
        sl[slot * RT + r] = l[r];
      }
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int w = 0; w < W; ++w)
          if (col[nv] + w < dh)
            sacc[(slot * RT + r) * dh + col[nv] + w] = acc[r][W * nv + w];
    }
    __syncthreads();

    // The slots' partials, in slot order, into the block's: the max over
    // the slots first, then each slot's weight exp2(m_s - max), then the
    // weighted sums.
    for (int i = tid; i < SLOTS * RT; i += kWarps * 32) {
      const int r = i % RT;
      float M = sm[r];
#pragma unroll
      for (int s = 1; s < SLOTS; ++s) M = fmaxf(M, sm[s * RT + r]);
      sw[i] = weight(sm[i], M);
      if (i < RT) bm[r] = M;
    }
    __syncthreads();
    for (int i = tid; i < RT * dh; i += kWarps * 32) {
      const int r = i / dh;
      float aa = 0.f;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        aa += sacc[s * RT * dh + i] * sw[s * RT + r];
      bacc[i] = aa;
      if (i - r * dh == 0) {
        float ll = 0.f;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) ll += sl[s * RT + r] * sw[s * RT + r];
        bl[r] = ll;
      }
    }
    cluster.sync();   // every block's partial is written

    // The cluster's blocks, in rank order, into the output: block `rank`
    // takes elements rank * 128 + tid, (rank + kSplit) * 128 + tid, ...,
    // reading all kSplit partials through distributed shared memory.
    const int n_out = min(RT, g - r0) * dh;
    for (int i = rank * kWarps * 32 + tid; i < n_out;
         i += kSplit * kWarps * 32) {
      const int r = i / dh;
      float mj[kSplit], lj[kSplit], aj[kSplit];
#pragma unroll
      for (int j = 0; j < kSplit; ++j) {
        mj[j] = cluster.map_shared_rank(bm, j)[r];
        lj[j] = cluster.map_shared_rank(bl, j)[r];
        aj[j] = cluster.map_shared_rank(bacc, j)[i];
      }
      float M = mj[0];
#pragma unroll
      for (int j = 1; j < kSplit; ++j) M = fmaxf(M, mj[j]);
      float ll = 0.f, aa = 0.f;
#pragma unroll
      for (int j = 0; j < kSplit; ++j) {
        const float c = weight(mj[j], M);
        ll += lj[j] * c;
        aa += aj[j] * c;
      }
      out[((static_cast<long long>(b) * kvh + h) * g + r0) * dh + i] =
          attn::from_f32<T>(aa / fmaxf(ll, 1e-30f));
    }
    cluster.sync();   // every partial has been read: they may be reused
  }
}

template <typename T, int W, int LPK, int NV, int RT>
int launch_cfg(const T* q, const T* k, const T* v, const int* kv_len, T* out,
               int B, int T_len, int kvh, int g, int dh, float scale,
               cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(kWarps * 32 / LPK, RT, dh);
  auto kernel = decode_split_kernel<T, W, LPK, NV, RT>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk = ((T_len + kSplit - 1) / kSplit + 31) / 32 * 32;
  kernel<<<B * kvh * kSplit, kWarps * 32, smem, stream>>>(
      q, k, v, kv_len, out, T_len, kvh, g, dh, chunk, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// RT: the rows a pass holds, RT * W * NV <= 32 accumulators a lane: one
// pass of exactly G rows for G <= 4 (G = 3 at the serving shape), else
// passes of 8 or 16.
template <typename T, int W, int LPK, int NV>
int launch_rt(const T* q, const T* k, const T* v, const int* kv_len, T* out,
              int B, int T_len, int kvh, int g, int dh, float scale,
              cudaStream_t s) {
  constexpr int kMaxRt = 32 / (W * NV) < 16 ? 32 / (W * NV) : 16;
#define DECODE_RT(rt)                                                     \
  return launch_cfg<T, W, LPK, NV, rt>(q, k, v, kv_len, out, B, T_len, kvh, \
                                       g, dh, scale, s)
  if (g == 1) DECODE_RT(1);
  if (g == 2) DECODE_RT(2);
  if (g == 3) DECODE_RT(3);
  if constexpr (kMaxRt >= 8) {
    if (g > 4) {
      if constexpr (kMaxRt >= 16) {
        if (g > 8) DECODE_RT(16);
      }
      DECODE_RT(8);
    }
  }
  DECODE_RT(4);
#undef DECODE_RT
}

// Shapes are checked by the Python wrapper: 1 <= G <= 32, 1 <= Dh <= 128.
template <typename T>
int launch(const T* q, const T* k, const T* v, const int* kv_len, T* out,
           int B, int T_len, int kvh, int g, int dh, float scale,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int W = 16 / sizeof(T);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (dh % W == 0 && aligned) {           // one 16-byte vector a lane
    const int nvec = dh / W;
    if (nvec <= 4)
      return launch_rt<T, W, 4, 1>(q, k, v, kv_len, out, B, T_len, kvh, g,
                                   dh, scale, s);
    if (nvec <= 8)
      return launch_rt<T, W, 8, 1>(q, k, v, kv_len, out, B, T_len, kvh, g,
                                   dh, scale, s);
    if (nvec <= 16)
      return launch_rt<T, W, 16, 1>(q, k, v, kv_len, out, B, T_len, kvh, g,
                                    dh, scale, s);
    return launch_rt<T, W, 32, 1>(q, k, v, kv_len, out, B, T_len, kvh, g, dh,
                                  scale, s);
  }
  if (dh <= 32)                           // scalar: 32 lanes a key
    return launch_rt<T, 1, 32, 1>(q, k, v, kv_len, out, B, T_len, kvh, g, dh,
                                  scale, s);
  if (dh <= 64)
    return launch_rt<T, 1, 32, 2>(q, k, v, kv_len, out, B, T_len, kvh, g, dh,
                                  scale, s);
  return launch_rt<T, 1, 32, 4>(q, k, v, kv_len, out, B, T_len, kvh, g, dh,
                                scale, s);
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
