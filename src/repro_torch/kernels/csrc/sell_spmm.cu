// Fused multi-column SELL SpMM over a coalesced plan, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/sell_spmm.py:sell_spmm_pallas
// (bodies _kernel and _kernel_buffered): Y[s*H + h, j] = sum over the
// slice's elements of value * X[tag * block_rows + offset, j].
//
// Bound: device-memory bytes. Values and metadata stream once per column
// tile of up to 128 columns (once per launch at the main path's k = 64), X
// once from HBM through the wide fetches, Y written once, against two
// operations per element and column. The TPU kernel extracts with a one-hot
// (window x block_rows) @ (block_rows x k_tile) MXU matmul; here the body in
// sell_common.cuh is the NC = 8 instance: thread (h, q) of a slot keeps
// row h's sums of the item it walks for 8 columns in registers, reading
// each element's value and metadata word once from a shared stage and the
// X tile as two float4. A buffer_depth-stage cp.async ring keeps the next
// steps' tags' tiles, values and metadata in flight while one computes; a
// slice cut into several items is added up from its partial rows by
// sell_combine after the kernel. X tiles move in
// 16-byte pieces when k % 4 == 0 and X is 16-byte aligned, else 4-byte.
// `k_tile` (the TPU's RHS tile) does not shape this grid.
#include "sell_common.cuh"

extern "C" int sell_spmm_launch(const void* values, const void* X,
                                const void* tags, const void* meta,
                                const void* items, const void* combine,
                                void* Y, void* partials, int values_bf16,
                                int packed, int n_slices, int n_items,
                                int n_windows, int n_split, int n_partials,
                                int cols_per_chunk, int slice_height,
                                int max_warps, int block_rows, int n_cols,
                                int k, int quads, int slices_per_block,
                                int group, int depth, int val_unit,
                                int meta_unit, int x_unit, int smem_bytes,
                                void* stream) {
  const sell::Geometry g{n_slices,       n_items,      n_windows,  n_split,
                         n_partials,     cols_per_chunk, slice_height,
                         max_warps,      block_rows,   n_cols,     k,
                         quads,          8 * quads,    slices_per_block,
                         group,          depth,        val_unit,   meta_unit};
  return sell::launch<8>(values, X, tags, meta, items, combine, Y, partials,
                         values_bf16, packed, x_unit, g, smem_bytes, stream);
}
