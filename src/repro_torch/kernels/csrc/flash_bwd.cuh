// Block geometry shared by the tensor-core backward kernels of
// flash_attention_causal (flash_attention_bwd_wgmma.cu in bf16,
// flash_attention_bwd_tf32x3.cu in float32): which rows or keys a block
// owns, in the layout q, out, dout [B, S, KvH, G, Dh], k, v
// [B, S, KvH, Dh]. `id` is the block's index without its cluster rank
// (blockIdx.x where a block is its own cluster).
#pragma once

#include <cuda_runtime.h>

namespace flash_bwd {

constexpr int kKeyBlock = 64;   // keys a dk/dv block owns

// Global row index of row r = (position p0 + r / g, head r % g).
__device__ __forceinline__ long long row_of(int b, int S, int kvh, int h,
                                            int g, int p0, int r) {
  return ((static_cast<long long>(b) * S + p0 + r / g) * kvh + h) * g + r % g;
}

// Blocks of 64 rows (positions s0 .. s0 + bq - 1, their G heads each)
// of every (b, kvh) pair, heaviest (the last positions) first.
struct RowBlock {
  int b, h, s0, n_rows;
  __device__ RowBlock(int id, int B, int S, int kvh, int g, int bq) {
    const int n_qb = (S + bq - 1) / bq;
    const int bhs = B * kvh;
    const int qb = n_qb - 1 - id / bhs;
    const int bh = id % bhs;
    b = bh / kvh;
    h = bh - b * kvh;
    s0 = qb * bq;
    n_rows = min(bq, S - s0) * g;
  }
};

// The kKeyBlock keys a dk/dv block owns: blocks heaviest (the first
// keys) first over every (b, kvh) pair; n_qt tiles of bq positions >= j0.
struct KeyBlock {
  int b, h, j0, n_qt;
  __device__ KeyBlock(int id, int B, int S, int kvh, int bq) {
    const int bhs = B * kvh;
    const int kt = id / bhs;
    const int bh = id % bhs;
    b = bh / kvh;
    h = bh - b * kvh;
    j0 = kt * kKeyBlock;
    n_qt = (S - j0 + bq - 1) / bq;
  }
};

}  // namespace flash_bwd
