// MVCC version-visibility resolution + payload select, for sm_90a.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/mvcc_resolve.py:
//   * mvcc_resolve        (_resolve_kernel, pallas_call at :100)
//   * mvcc_resolve_masked (_resolve_masked_kernel, pallas_call at :169)
//   * mvcc_resolve_paged  (_resolve_paged_kernel, pallas_call at :248)
//
// Per read i (paper §4.1.3): slot k of the read's row is visible when
//     begin[row,k] <= ts[i] < end[row,k]   (&& rec[row,k] == want[i], masked)
// best  = max visible begin (INT32_MIN when none),
// vals  = sum of data[row,k,:] over visible slots with begin == best
//         (the Pallas tie rule: every slot tied at best is summed, in
//         ascending k with int32 wrap-around; a consistent store has
//         exactly one),
// found = best > INT32_MIN.
//
// Which row a read resolves is the form of the call:
//   * windows: row = i, over pre-gathered [B, K] windows (the Pallas
//     kernels' interface, kept for the kernel-level parity tests);
//   * rows (mvcc_resolve): row = rows[i] of the ring's [R, K] arrays,
//     read where it lies — no window copy;
//   * buckets (mvcc_resolve_masked): row = max(want[i], 0) % NB, the
//     read's spill bucket of the pool's [NB, S] arrays, computed here
//     (store/spill.py::spill_buckets_for's rule) — no bucket copy;
//   * paged (mvcc_resolve_paged): the row is a page-table row, rows[i]
//     of the slab's own table [R, MaxP] (rows form, no table copy) or
//     row i of pre-gathered page rows [B, MaxP] (windows form). Its K =
//     MaxP * S candidates are k = p * S + s: slot s of page table[row, p]
//     of the slab begin/end [P, S], data [P, S, D]. A page id outside
//     [0, P) (-1 = unmapped) gives no candidate and loads nothing, so a
//     corrupt table can never read outside the slab.
// A row outside [0, rows) gives found = false and zero values and loads
// nothing. With a prior (the primary level's vals/found), a read whose
// prior found its version copies the prior's values, sets found and loads
// nothing of its bucket: the result is where(prior_found, prior_vals, s_vals), prior_found |
// s_found, the two-level combine of store/sharded.py, in the same launch.
//
// What bounds it: memory traffic and, at the engine's sizes, latency.
// Each read needs its row id (or want) and ts, the begin/end (+ rec) of
// its row — a zipfian batch reads hot rows again, and L2 serves the
// repeats — the D payload words of the selected slot only, and writes 4D
// + 1 bytes. That is ~K compares and D adds for well over one byte each,
// so the roofline is HBM bandwidth: at the dense path's read batch
// (B = 10240, K = 4 or S = 8, D = 8) well under a microsecond, so a
// launch costs more than the bytes, and the serial chain of dependent
// loads (row id -> begin/end -> payload) is what a read waits on.
//
// What the design does about it: one group of G lanes per read (G = the
// next power of two >= max(K, D), capped at 32; groups never straddle a
// warp). The read's scalars (ts, row id or want, prior found) are loaded
// first, together. Then lane k loads slot k's begin and end (+ rec) — at
// K = 4 one 16-byte line of begin per row — so the K loads of a row go
// out at once instead of one after another; a strided loop covers K > G.
// The largest visible begin is reduced with __shfl_xor_sync inside the
// group, and the tied slots become one bit mask (__ballot_sync), the
// same on every lane. Lane d then loads payload word d of the selected
// slots only, in ascending k: consecutive lanes read consecutive words,
// so the load is coalesced along D and an unselected slot costs no
// traffic. Offsets are 64-bit (row * K * D exceeds 2^31 past 2^28
// slots). No shared memory, no atomics; `found` is written once per read
// by lane 0, and the ragged edge (B not a multiple of the block) is
// masked by an index test over whole groups.
//
// The paged form is the same kernel with one more dependent load: the
// lanes < MaxP of the group load the row's page ids at once (one 32-byte
// sector at MaxP = 8), __shfl_sync hands candidate lane p * S + s its
// page id, and that lane loads begin/end of slot pid * S + s only where
// the page is mapped; the selected slots' payload offsets come from their
// candidates' lanes by __shfl_sync as well. The Pallas kernel maps the
// whole slab into VMEM as one grid-invariant block and gathers from
// there; at the engine's size the slab is 2M pages x 2 slots x 10 words =
// 160 MB, far beyond shared memory, so here each group reads its pages
// straight from global memory. What bounds it: the row id and ts, the
// MaxP page ids of each distinct row, the begin/end of each distinct
// mapped page (S x 8 bytes; a zipfian batch reads hot rows and pages
// again, and L2 serves the repeats), the selected slot's payload and the
// outputs — again HBM bytes, well under a microsecond at the engine's
// shape (B = 10240, MaxP = 8, S = 2, D = 8, most records mapping one
// page), so the chain row id -> page id -> begin/end -> payload is what a
// read waits on. Slab offsets are 64-bit ((pid * S + s) * D + d exceeds
// 2^31 at 2^28 slots).
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int add_wrap(int a, int b) {
  // int32 sum with two's-complement wrap-around, as jnp/torch int32 sums
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ float add_wrap(float a, float b) { return a + b; }

// Slot s of a [rows, K] version array: sets its begin and returns whether
// it is visible at t (masked: and owned by w). The loads go out before
// any compare.
template <bool MASKED>
__device__ __forceinline__ bool visible(const int* __restrict__ begin,
                                        const int* __restrict__ end,
                                        const int* __restrict__ rec,
                                        long long s, int t, int w, int& b) {
  b = begin[s];
  const int e = end[s];
  const int r = MASKED ? rec[s] : w;
  return (b <= t) & (t < e) & (r == w);
}

// The paged candidates of one round of a read's table row trow (k0, a
// multiple of G): lane j's candidate is k = k0 + j (K = MaxP * S), slot
// k % S of page table[trow, k / S]; the call returns that slot of the
// slab, or -1 when there is none (k >= K, or an unmapped page). The
// round's candidates span at most G pages from p_lo = k0 / S on (S = 1:
// exactly G); lane j loads page id p_lo + j of the row — at MaxP = 8 one
// 32-byte sector, all ids at once — and __shfl_sync hands each lane its
// candidate's id. A page id outside [0, n_pages) (-1 among them) is
// unmapped. Every lane of the group must call it (it shuffles).
__device__ __forceinline__ long long paged_slot(
    const int* __restrict__ table, long long trow, int k0, int lane, int G,
    unsigned gmask, int K, int max_pages, int S, long long n_pages) {
  const int k = k0 + lane;
  const int p_lo = k0 / S;
  const int p_n = min((k0 + G - 1) / S, max_pages - 1) - p_lo + 1;
  const int own = lane < p_n ? table[trow * max_pages + p_lo + lane] : -1;
  const int pid = __shfl_sync(gmask, own, (min(k, K - 1) / S) - p_lo, G);
  if (k >= K || pid < 0 || pid >= n_pages) return -1;
  return static_cast<long long>(pid) * S + k % S;
}

// One lane group of 2^lanes_log2 lanes per read (see the header). `rows`
// is null except in the rows form; `by_bucket` selects the buckets form
// of the masked kernel; `prior_vals` / `prior_found` are null without a
// prior. PAGED: `table` is the page table ([n_rows, max_pages]; with
// `rows` null, one row per read), K = max_pages * S, and the version
// arrays are the slab's [n_pages, S].
template <typename T, bool MASKED, bool PAGED>
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ rows, const int* __restrict__ table,
               const int* __restrict__ begin, const int* __restrict__ end,
               const int* __restrict__ rec, const int* __restrict__ want,
               const T* __restrict__ data, const int* __restrict__ ts,
               const T* __restrict__ prior_vals,
               const bool* __restrict__ prior_found, T* __restrict__ vals,
               bool* __restrict__ found, long long n_reads,
               long long n_rows, int K, int D, int lanes_log2,
               bool by_bucket, int max_pages, int S, long long n_pages) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = tid >> lanes_log2;
  if (i >= n_reads) return;  // ragged edge of the last block: whole groups
  const int G = 1 << lanes_log2;
  const int lane = static_cast<int>(tid & (G - 1));
  const int base = static_cast<int>(threadIdx.x & 31) & ~(G - 1);
  const unsigned gmask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << base;
  T* v_row = vals + i * static_cast<long long>(D);

  // the read's scalars: independent loads, issued together
  const int t = ts[i];
  const int w = MASKED ? want[i] : 0;
  const long long r_in = rows != nullptr ? rows[i] : i;
  const bool hit = prior_found != nullptr && prior_found[i];
  if (hit) {  // the primary level holds the version: nothing of the bucket
    const T* p_row = prior_vals + i * static_cast<long long>(D);
    for (int d = lane; d < D; d += G) v_row[d] = p_row[d];
    if (lane == 0) found[i] = true;
    return;
  }
  const long long row =
      by_bucket ? static_cast<long long>(max(w, 0)) % n_rows : r_in;
  if (row < 0 || row >= n_rows) {  // outside the array: nothing loaded
    for (int d = lane; d < D; d += G) v_row[d] = T(0);
    if (lane == 0) found[i] = false;
    return;
  }
  // candidate k's slot: dense slot0 + k; paged through the table row
  const long long slot0 = PAGED ? 0 : row * K;
  auto slot_of = [&](int k0) -> long long {
    if (PAGED)
      return paged_slot(table, row, k0, lane, G, gmask, K, max_pages, S,
                        n_pages);
    return k0 + lane < K ? slot0 + k0 + lane : -1;
  };

  // pass 1: lane j tests candidate k0 + j of each round; the group's max.
  // Paged rounds run on every lane (they shuffle page ids); the dense
  // loop lets lanes past K stop early, which whole rounds would cost the
  // dense forms 0.1-0.2 us on an H100 (benchmarks_torch/resolve_kernels.py)
  int best = INT_MIN, b_own = INT_MIN;
  bool vis_own = false;       // the lane's candidate of the first round
  long long slot_own = -1;
  if constexpr (PAGED) {
    for (int k0 = 0; k0 < K; k0 += G) {
      const long long slot = slot_of(k0);
      int b = INT_MIN;
      bool v = false;
      if (slot >= 0) v = visible<MASKED>(begin, end, rec, slot, t, w, b);
      if (k0 == 0) {
        slot_own = slot;
        b_own = b;
        vis_own = v;
      }
      if (v && b > best) best = b;
    }
  } else {
    for (int k = lane; k < K; k += G) {
      int b;
      const bool v = visible<MASKED>(begin, end, rec, slot0 + k, t, w, b);
      if (k == lane) {
        b_own = b;
        vis_own = v;
      }
      if (v && b > best) best = b;
    }
  }
  for (int off = G >> 1; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(gmask, best, off, G));
  if (lane == 0) found[i] = best > INT_MIN;

  // pass 2: the candidates tied at best as a bit mask per round (the same
  // on every lane), then lane d sums word d of their slots in ascending
  // candidate order; a paged slot comes from its candidate's lane
  const unsigned first =
      (__ballot_sync(gmask, vis_own && b_own == best) & gmask) >> base;
  const T* d_row = data + slot0 * D;
  for (int d0 = 0; d0 < D; d0 += G) {
    const int d = d0 + lane;
    T acc = T(0);
    for (int k0 = 0; k0 < K; k0 += G) {
      unsigned sel = first;
      long long slot = slot_own;
      if (k0 > 0) {  // K > G: this round's candidates again (from L1)
        slot = slot_of(k0);
        int b = INT_MIN;
        bool v = false;
        if (slot >= 0) v = visible<MASKED>(begin, end, rec, slot, t, w, b);
        sel = (__ballot_sync(gmask, v && b == best) & gmask) >> base;
      }
      for (; sel != 0; sel &= sel - 1) {
        const int j = __ffs(sel) - 1;
        const T* src = PAGED ? data + __shfl_sync(gmask, slot, j, G) * D
                             : d_row + static_cast<long long>(k0 + j) * D;
        if (d < D) acc = add_wrap(acc, src[d]);
      }
    }
    if (d < D) v_row[d] = acc;
  }
}

int lanes_log2_for(int n) {
  int l = 0;
  while ((1 << l) < n && l < 5) ++l;
  return l;
}

// K: candidates a read (dense: slots a row; paged: max_pages * S).
template <typename T, bool MASKED, bool PAGED>
int launch(const int* rows, const int* table, const int* begin,
           const int* end, const int* rec, const int* want, const T* data,
           const int* ts, const T* prior_vals, const bool* prior_found,
           T* vals, bool* found, long long n_reads, int n_rows,
           bool by_bucket, int K, int D, int max_pages, int S, int n_pages,
           cudaStream_t stream) {
  const int ll = lanes_log2_for(K > D ? K : D);
  const long long threads = n_reads << ll;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  resolve_kernel<T, MASKED, PAGED>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          rows, table, begin, end, rec, want, data, ts, prior_vals,
          prior_found, vals, found, n_reads, n_rows, K, D, ll, by_bucket,
          max_pages, S, n_pages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Every function returns the
// cudaGetLastError() code of its launch; 0 means the launch was accepted.
extern "C" {

// rows == null: the windows form (R = n_reads, read i resolves row i).
int mvcc_resolve_i32(const int* rows, const int* begin, const int* end,
                     const int* data, const int* ts, int* vals, bool* found,
                     long long n_reads, int n_rows, int K, int D,
                     void* stream) {
  return launch<int, false, false>(
      rows, nullptr, begin, end, nullptr, nullptr, data, ts, nullptr,
      nullptr, vals, found, n_reads, n_rows, false, K, D, 0, 0, 0,
      static_cast<cudaStream_t>(stream));
}

int mvcc_resolve_f32(const int* rows, const int* begin, const int* end,
                     const float* data, const int* ts, float* vals,
                     bool* found, long long n_reads, int n_rows, int K, int D,
                     void* stream) {
  return launch<float, false, false>(
      rows, nullptr, begin, end, nullptr, nullptr, data, ts, nullptr,
      nullptr, vals, found, n_reads, n_rows, false, K, D, 0, 0, 0,
      static_cast<cudaStream_t>(stream));
}

// by_bucket == 0: the windows form (n_rows = n_reads); 1: the buckets
// form over the pool. prior_vals / prior_found null: no prior.
int mvcc_resolve_masked_i32(const int* begin, const int* end, const int* rec,
                            const int* want, const int* data, const int* ts,
                            const int* prior_vals, const bool* prior_found,
                            int* vals, bool* found, long long n_reads,
                            int n_rows, int by_bucket, int K, int D,
                            void* stream) {
  return launch<int, true, false>(
      nullptr, nullptr, begin, end, rec, want, data, ts, prior_vals,
      prior_found, vals, found, n_reads, n_rows, by_bucket != 0, K, D, 0, 0,
      0, static_cast<cudaStream_t>(stream));
}

int mvcc_resolve_masked_f32(const int* begin, const int* end, const int* rec,
                            const int* want, const float* data, const int* ts,
                            const float* prior_vals, const bool* prior_found,
                            float* vals, bool* found, long long n_reads,
                            int n_rows, int by_bucket, int K, int D,
                            void* stream) {
  return launch<float, true, false>(
      nullptr, nullptr, begin, end, rec, want, data, ts, prior_vals,
      prior_found, vals, found, n_reads, n_rows, by_bucket != 0, K, D, 0, 0,
      0, static_cast<cudaStream_t>(stream));
}

// rows == null: the windows form (table = page_rows [n_reads, max_pages],
// n_rows = n_reads); else the rows form over the page table
// [n_rows, max_pages].
int mvcc_resolve_paged_i32(const int* rows, const int* table,
                           const int* begin, const int* end, const int* data,
                           const int* ts, int* vals, bool* found,
                           long long n_reads, int n_rows, int max_pages,
                           int n_pages, int S, int D, void* stream) {
  return launch<int, false, true>(
      rows, table, begin, end, nullptr, nullptr, data, ts, nullptr, nullptr,
      vals, found, n_reads, n_rows, false, max_pages * S, D, max_pages, S,
      n_pages, static_cast<cudaStream_t>(stream));
}

int mvcc_resolve_paged_f32(const int* rows, const int* table,
                           const int* begin, const int* end,
                           const float* data, const int* ts, float* vals,
                           bool* found, long long n_reads, int n_rows,
                           int max_pages, int n_pages, int S, int D,
                           void* stream) {
  return launch<float, false, true>(
      rows, table, begin, end, nullptr, nullptr, data, ts, nullptr, nullptr,
      vals, found, n_reads, n_rows, false, max_pages * S, D, max_pages, S,
      n_pages, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
