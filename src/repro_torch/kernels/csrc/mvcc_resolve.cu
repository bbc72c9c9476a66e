// MVCC version-visibility resolution + payload select, for sm_90a.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/mvcc_resolve.py:
//   * mvcc_resolve        (_resolve_kernel, pallas_call at :100)
//   * mvcc_resolve_masked (_resolve_masked_kernel, pallas_call at :169)
//   * mvcc_resolve_paged  (_resolve_paged_kernel, pallas_call at :248)
//
// Per read i (paper §4.1.3): slot k is visible when
//     begin[i,k] <= ts[i] < end[i,k]   (&& rec[i,k] == want[i], masked)
// best  = max visible begin (INT32_MIN when none),
// vals  = sum of data[i,k,:] over visible slots with begin == best
//         (the Pallas tie rule: every slot tied at best is summed; a
//         consistent store has exactly one),
// found = best > INT32_MIN.
//
// What bounds it: memory traffic. Each read needs all K slots' begin and
// end (+ rec, and want, when masked), its ts, and the D payload words of
// the selected slot only (a consistent store has at most one), and writes
// 4D + 1 bytes of vals/found. That is ~K compares and D adds for well
// over one byte each, so the roofline is HBM bandwidth. At the engine's
// snapshot-read shapes (B = 10240 reads, K = 4 or 8, D = 8) a call needs
// about 1-1.5 MB, which the H100 streams in well under a microsecond, so
// in practice a launch costs more than the bytes.
//
// What the design does about it: one small group of `lanes` threads per
// read (lanes = next power of two >= D, capped at 32). The group keeps the
// K-wide interval test and max in registers (begin/end loads are the same
// address across the group, so a warp broadcasts them), then each lane
// owns a strided subset of the D payload words: consecutive lanes load
// consecutive words, so payload loads are coalesced along D, and a payload
// word is loaded only where its slot is selected (at D = 8 a slot's payload
// is one 32-byte sector, so unselected slots cost no traffic). Every
// window byte loaded is read from HBM once. `found` is written once per
// read, by lane 0. The ragged edge (B not a multiple of the block) is masked by an
// index test; nothing is padded or copied. Fusing the window gather
// (ring/spill rows indexed by record) into the kernel is later work: the
// interface keeps the Pallas kernels' pre-gathered windows.
//
// The paged kernel reads its windows in place. Read i's candidates are
// the S slots of every mapped page in its page-table row page_rows[i, :]
// (-1 = unmapped) of the slab begin/end [P, S], data [P, S, D]. The
// Pallas kernel maps the whole slab into VMEM as one grid-invariant block
// and gathers from there; at the engine's size the slab is 2M pages x 2
// slots x 10 words = 160 MB, far beyond shared memory, so here the lane
// group loads its MaxP page ids and reads those pages' begin/end straight
// from global memory, skipping unmapped entries (Pallas reads page 0 for
// them and masks afterwards; this kernel loads nothing). What bounds it:
// the page ids, the begin/end of each distinct mapped page (S x 8 bytes;
// a zipfian batch reads hot pages again, and L2 serves the repeats), ts,
// the selected slot's payload and the outputs — again HBM bytes, about
// 0.5 MB at the engine's shape (B = 10240, MaxP = 8, S = 2, D = 8, most
// records mapping one page), so a launch costs more than the bytes. Slab
// offsets are 64-bit ((pid * S + s) * D + d exceeds 2^31 at 2^28 slots);
// a page id outside [0, P) is treated as unmapped, so a corrupt table can
// never read outside the slab.
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

template <typename T, bool MASKED>
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ begin, const int* __restrict__ end,
               const int* __restrict__ rec, const int* __restrict__ want,
               const T* __restrict__ data, const int* __restrict__ ts,
               T* __restrict__ vals, bool* __restrict__ found,
               long long n_reads, int K, int D, int lanes_log2) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = tid >> lanes_log2;
  const int lane = static_cast<int>(tid & ((1 << lanes_log2) - 1));
  if (i >= n_reads) return;  // ragged edge of the last block

  const int t = ts[i];
  const int w = MASKED ? want[i] : 0;
  const int* b_row = begin + i * K;
  const int* e_row = end + i * K;
  const int* r_row = MASKED ? rec + i * K : nullptr;

  int best = INT_MIN;
  for (int k = 0; k < K; ++k) {
    const int bk = b_row[k];
    bool vis = bk <= t && t < e_row[k];
    if (MASKED) vis = vis && r_row[k] == w;
    if (vis && bk > best) best = bk;
  }
  if (lane == 0) found[i] = best > INT_MIN;

  const T* d_row = data + i * K * static_cast<long long>(D);
  T* v_row = vals + i * static_cast<long long>(D);
  for (int d = lane; d < D; d += (1 << lanes_log2)) {
    T acc = T(0);
    for (int k = 0; k < K; ++k) {
      const int bk = b_row[k];
      bool sel = bk == best && bk <= t && t < e_row[k];
      if (MASKED) sel = sel && r_row[k] == w;
      if (sel) acc = add_wrap(acc, d_row[static_cast<long long>(k) * D + d]);
    }
    v_row[d] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
resolve_paged_kernel(const int* __restrict__ page_rows,
                     const int* __restrict__ begin,
                     const int* __restrict__ end, const T* __restrict__ data,
                     const int* __restrict__ ts, T* __restrict__ vals,
                     bool* __restrict__ found, long long n_reads,
                     int max_pages, int n_pages, int S, int D,
                     int lanes_log2) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = tid >> lanes_log2;
  const int lane = static_cast<int>(tid & ((1 << lanes_log2) - 1));
  if (i >= n_reads) return;  // ragged edge of the last block

  const int t = ts[i];
  const int* row = page_rows + i * max_pages;

  int best = INT_MIN;
  for (int p = 0; p < max_pages; ++p) {
    const int pid = row[p];
    if (pid < 0 || pid >= n_pages) continue;  // unmapped: nothing loaded
    const long long slot0 = static_cast<long long>(pid) * S;
    for (int s = 0; s < S; ++s) {
      const int b = begin[slot0 + s];
      if (b <= t && t < end[slot0 + s] && b > best) best = b;
    }
  }
  if (lane == 0) found[i] = best > INT_MIN;

  T* v_row = vals + i * static_cast<long long>(D);
  for (int d = lane; d < D; d += (1 << lanes_log2)) {
    T acc = T(0);
    for (int p = 0; p < max_pages; ++p) {
      const int pid = row[p];
      if (pid < 0 || pid >= n_pages) continue;
      const long long slot0 = static_cast<long long>(pid) * S;
      for (int s = 0; s < S; ++s) {
        const int b = begin[slot0 + s];
        if (b == best && b <= t && t < end[slot0 + s])
          acc = add_wrap(acc, data[(slot0 + s) * D + d]);
      }
    }
    v_row[d] = acc;
  }
}

int lanes_log2_for(int D) {
  int l = 0;
  while ((1 << l) < D && l < 5) ++l;
  return l;
}

template <typename T, bool MASKED>
int launch(const int* begin, const int* end, const int* rec, const int* want,
           const T* data, const int* ts, T* vals, bool* found,
           long long n_reads, int K, int D, cudaStream_t stream) {
  const int ll = lanes_log2_for(D);
  const long long threads = n_reads << ll;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  resolve_kernel<T, MASKED><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(begin, end, rec, want, data, ts, vals,
                                        found, n_reads, K, D, ll);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_paged(const int* page_rows, const int* begin, const int* end,
                 const T* data, const int* ts, T* vals, bool* found,
                 long long n_reads, int max_pages, int n_pages, int S, int D,
                 cudaStream_t stream) {
  const int ll = lanes_log2_for(D);
  const long long threads = n_reads << ll;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  resolve_paged_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(page_rows, begin, end, data, ts, vals,
                                      found, n_reads, max_pages, n_pages, S,
                                      D, ll);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Every function returns the
// cudaGetLastError() code of its launch; 0 means the launch was accepted.
extern "C" {

int mvcc_resolve_i32(const int* begin, const int* end, const int* data,
                     const int* ts, int* vals, bool* found, long long n_reads,
                     int K, int D, void* stream) {
  return launch<int, false>(begin, end, nullptr, nullptr, data, ts, vals,
                            found, n_reads, K, D,
                            static_cast<cudaStream_t>(stream));
}

int mvcc_resolve_f32(const int* begin, const int* end, const float* data,
                     const int* ts, float* vals, bool* found,
                     long long n_reads, int K, int D, void* stream) {
  return launch<float, false>(begin, end, nullptr, nullptr, data, ts, vals,
                              found, n_reads, K, D,
                              static_cast<cudaStream_t>(stream));
}

int mvcc_resolve_masked_i32(const int* begin, const int* end, const int* rec,
                            const int* want, const int* data, const int* ts,
                            int* vals, bool* found, long long n_reads, int K,
                            int D, void* stream) {
  return launch<int, true>(begin, end, rec, want, data, ts, vals, found,
                           n_reads, K, D, static_cast<cudaStream_t>(stream));
}

int mvcc_resolve_masked_f32(const int* begin, const int* end, const int* rec,
                            const int* want, const float* data, const int* ts,
                            float* vals, bool* found, long long n_reads, int K,
                            int D, void* stream) {
  return launch<float, true>(begin, end, rec, want, data, ts, vals, found,
                             n_reads, K, D, static_cast<cudaStream_t>(stream));
}

int mvcc_resolve_paged_i32(const int* page_rows, const int* begin,
                           const int* end, const int* data, const int* ts,
                           int* vals, bool* found, long long n_reads,
                           int max_pages, int n_pages, int S, int D,
                           void* stream) {
  return launch_paged<int>(page_rows, begin, end, data, ts, vals, found,
                           n_reads, max_pages, n_pages, S, D,
                           static_cast<cudaStream_t>(stream));
}

int mvcc_resolve_paged_f32(const int* page_rows, const int* begin,
                           const int* end, const float* data, const int* ts,
                           float* vals, bool* found, long long n_reads,
                           int max_pages, int n_pages, int S, int D,
                           void* stream) {
  return launch_paged<float>(page_rows, begin, end, data, ts, vals, found,
                             n_reads, max_pages, n_pages, S, D,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
