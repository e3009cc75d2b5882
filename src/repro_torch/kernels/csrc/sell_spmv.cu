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
// wasted work. This is the k = k_tile = 1 instance of the body in
// sell_common.cuh: a block owns `slices_per_block` slices (H threads each);
// per chunk each slice's threads copy its window's unique wide blocks of x
// into shared memory once, then thread h walks the chunk's C columns and
// accumulates in a float register.
#include "sell_common.cuh"

extern "C" int sell_spmv_launch(const void* values, const void* x,
                                const void* tags, const void* meta, void* y,
                                int values_bf16, int packed, int n_slices,
                                int n_chunks, int cols_per_chunk,
                                int slice_height, int max_warps,
                                int block_rows, int n_cols,
                                int slices_per_block, int group,
                                int smem_bytes, void* stream) {
  const sell::Geometry g{n_slices,   n_chunks, cols_per_chunk, slice_height,
                         max_warps,  block_rows, n_cols,       1,
                         1,          group};
  return sell::launch(values, x, tags, meta, y, values_bf16, packed, g,
                      slices_per_block, smem_bytes, stream);
}

extern "C" int sell_max_dynamic_smem(int device, int* out) {
  return static_cast<int>(cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

extern "C" const char* sell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
