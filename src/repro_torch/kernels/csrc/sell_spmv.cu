// SELL SpMV over a coalesced plan, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/sell_spmv.py:sell_spmv_pallas
// (bodies _kernel and _kernel_buffered): y[s*H + h] = sum over the slice's
// elements of value * x[tag * block_rows + offset].
//
// Bound: device-memory bytes. Each element costs one value and one metadata
// word read (8 bytes packed, f32 values) against one multiply-add, far below
// the card's operations-per-byte balance. The TPU kernel extracts elements
// with a one-hot (window x block_rows) matmul on the MXU; on Hopper that is
// wasted work. This is the NC = 1, k = 1 instance of the body in
// sell_common.cuh: a block holds `slices_per_block` slots (H threads each),
// each walking the plan's work items; a buffer_depth-stage cp.async ring
// stages each window's unique wide blocks of x, its values and its metadata
// words in shared memory, the next windows' copies in flight while thread h
// walks the current chunk's C columns and accumulates in a float register.
// A slice cut into several items is added up from its partial rows by
// sell_combine after the kernel.
#include "sell_common.cuh"

extern "C" int sell_spmv_launch(const void* values, const void* x,
                                const void* tags, const void* meta,
                                const void* items, const void* combine,
                                void* y, void* partials, int values_bf16,
                                int packed, int n_slices, int n_items,
                                int n_windows, int n_split, int n_partials,
                                int cols_per_chunk, int slice_height,
                                int max_warps, int block_rows, int n_cols,
                                int slices_per_block, int group, int depth,
                                int val_unit, int meta_unit, int x_unit,
                                int smem_bytes, void* stream) {
  const sell::Geometry g{n_slices,       n_items,      n_windows,  n_split,
                         n_partials,     cols_per_chunk, slice_height,
                         max_warps,      block_rows,   n_cols,     1,
                         1,              1,            slices_per_block,
                         group,          depth,        val_unit,   meta_unit};
  return sell::launch<1>(values, x, tags, meta, items, combine, y, partials,
                         values_bf16, packed, x_unit, g, smem_bytes, stream);
}

extern "C" int sell_max_dynamic_smem(int device, int* out) {
  return static_cast<int>(cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

extern "C" const char* sell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
