// Fused multi-column SELL SpMM over a coalesced plan, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/sell_spmm.py:sell_spmm_pallas
// (bodies _kernel and _kernel_buffered): Y[s*H + h, j] = sum over the
// slice's elements of value * X[tag * block_rows + offset, j].
//
// Bound: device-memory bytes. Values and metadata stream once per k-tile
// and X through the wide fetches, against two operations per element and
// column. The TPU kernel extracts with a one-hot (window x block_rows) @
// (block_rows x k_tile) MXU matmul; here the body in sell_common.cuh runs
// one block per k-tile of `slices_per_block` slices, thread (j, h) computing
// row h, column j, with each unique tag's (block_rows, k_tile) tile of X
// copied into shared memory once per window. Columns past k in the last
// tile are masked.
#include "sell_common.cuh"

extern "C" int sell_spmm_launch(const void* values, const void* X,
                                const void* tags, const void* meta, void* Y,
                                int values_bf16, int packed, int n_slices,
                                int n_chunks, int cols_per_chunk,
                                int slice_height, int max_warps,
                                int block_rows, int n_cols, int k, int k_tile,
                                int slices_per_block, int group,
                                int smem_bytes, void* stream) {
  const sell::Geometry g{n_slices,  n_chunks,   cols_per_chunk, slice_height,
                         max_warps, block_rows, n_cols,         k,
                         k_tile,    group};
  return sell::launch(values, X, tags, meta, Y, values_bf16, packed, g,
                      slices_per_block, smem_bytes, stream);
}
