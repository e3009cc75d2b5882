// Row gather over a coalesced plan, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/coalesced_gather.py:
// coalesced_gather_pallas (body _kernel): out[i] = table[indices[i]] for a
// (R, D) table, through the gather-geometry DevicePlan (one window of
// `window` elements per plan slice): element e of window w reads row
// tags[w, warp] * block_rows + offset, and rows at or past R read as zeros.
//
// Bound: device-memory bytes. It moves each output row once and reads the
// rows it names, with no arithmetic on the data. The TPU kernel fetches each
// unique (block_rows, D) block of a window into VMEM once and extracts rows
// with a one-hot matmul on the MXU; that costs operations Hopper does not
// need, and it is not exact: 0 * inf is nan and -0.0 + 0.0 is +0.0. Here
// the kernel copies bytes, so out equals table[indices] bitwise for every
// dtype. Rows repeated within a window (shared-prefix KV pages, repeated
// token ids) are read again and served by the 50 MB L2 instead of a
// per-window fetch.
//
// Design (simple first): one block per (window, column tile of the row). It
// stages the window's tags and the decoded source row of each element in
// shared memory once (the packed word decoded through uint32_t, as the SELL
// kernels do), then copies the elements' row tiles with vector units of
// 16 bytes when the row's bytes and both base pointers allow it, else 8, 4,
// 2 or 1 (the wrapper picks the unit: bf16 rows of odd width, D = 3).
// Consecutive threads take consecutive units of a row. Later work:
// cp.async.bulk/TMA for wide rows (64 KB KV pages) and staging of the
// window's unique blocks in shared memory for narrow rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "plan_meta.cuh"

namespace {

struct GatherGeometry {
  int window, max_warps, block_rows, n_rows, n_out, units_per_row,
      tile_units, elem_chunk;
};

template <typename U, bool PACKED>
__global__ void gather_kernel(const U* __restrict__ table,
                              const int32_t* __restrict__ tags,
                              const int32_t* __restrict__ meta,
                              U* __restrict__ out, const GatherGeometry g) {
  extern __shared__ long long smem[];
  long long* src = smem;  // source row of each staged element, -1 = zeros
  int32_t* tag_s = reinterpret_cast<int32_t*>(smem + g.elem_chunk);
  const int w = blockIdx.x;
  const int u0 = blockIdx.y * g.tile_units;
  const int nu = min(g.tile_units, g.units_per_row - u0);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const long long first = static_cast<long long>(w) * g.window;
  const int n_elems = static_cast<int>(
      min(static_cast<long long>(g.window), g.n_out - first));
  if (n_elems <= 0 || nu <= 0) return;
  const int32_t* tag_row = tags + static_cast<long long>(w) * g.max_warps;
  for (int t = tid; t < g.max_warps; t += nthreads) tag_s[t] = tag_row[t];
  __syncthreads();
  for (int e0 = 0; e0 < n_elems; e0 += g.elem_chunk) {
    const int ne = min(g.elem_chunk, n_elems - e0);
    for (int i = tid; i < ne; i += nthreads) {
      int warp, offset;
      plan::decode<PACKED>(meta, w, g.window, e0 + i, warp, offset);
      long long row = -1;
      if (warp >= 0 && warp < g.max_warps && offset >= 0 &&
          offset < g.block_rows) {
        row = static_cast<long long>(tag_s[warp]) * g.block_rows + offset;
        if (row < 0 || row >= g.n_rows) row = -1;
      }
      src[i] = row;
    }
    __syncthreads();
    const int total = ne * nu;
    for (int i = tid; i < total; i += nthreads) {
      const int e = i / nu;
      const long long u = u0 + (i - e * nu);
      const long long row = src[e];
      U v{};
      if (row >= 0) v = table[row * g.units_per_row + u];
      out[(first + e0 + e) * g.units_per_row + u] = v;
    }
    __syncthreads();
  }
}

template <typename U, bool PACKED>
cudaError_t launch_as(const void* table, const void* tags, const void* meta,
                      void* out, const GatherGeometry& g, int n_windows,
                      int threads, int smem_bytes, cudaStream_t stream) {
  auto kernel = gather_kernel<U, PACKED>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_windows,
                  (g.units_per_row + g.tile_units - 1) / g.tile_units);
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const U*>(table), static_cast<const int32_t*>(tags),
      static_cast<const int32_t*>(meta), static_cast<U*>(out), g);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_unit(int unit, const void* table, const void* tags,
                        const void* meta, void* out, const GatherGeometry& g,
                        int n_windows, int threads, int smem_bytes,
                        cudaStream_t stream) {
  switch (unit) {
    case 16:
      return launch_as<uint4, PACKED>(table, tags, meta, out, g, n_windows,
                                      threads, smem_bytes, stream);
    case 8:
      return launch_as<uint2, PACKED>(table, tags, meta, out, g, n_windows,
                                      threads, smem_bytes, stream);
    case 4:
      return launch_as<uint32_t, PACKED>(table, tags, meta, out, g,
                                         n_windows, threads, smem_bytes,
                                         stream);
    case 2:
      return launch_as<uint16_t, PACKED>(table, tags, meta, out, g,
                                         n_windows, threads, smem_bytes,
                                         stream);
    case 1:
      return launch_as<uint8_t, PACKED>(table, tags, meta, out, g, n_windows,
                                        threads, smem_bytes, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Copy out[i] = table[row of plan element i] for i < n_out on `stream`.
// `unit` is the vector width in bytes (the row's bytes and both pointers are
// multiples of it); units_per_row = row bytes / unit; a block copies
// `tile_units` units of each of its window's rows. Returns the launch's CUDA
// error code.
extern "C" int coalesced_gather_launch(
    const void* table, const void* tags, const void* meta, void* out,
    int packed, int unit, int n_windows, int window, int max_warps,
    int block_rows, int n_rows, int n_out, int units_per_row, int tile_units,
    int elem_chunk, int threads, int smem_bytes, void* stream) {
  if (n_windows < 1 || window < 1 || max_warps < 1 || block_rows < 1 ||
      n_out < 0 || units_per_row < 1 || tile_units < 1 || elem_chunk < 1 ||
      threads < 1 || threads > 1024 ||
      (units_per_row + tile_units - 1) / tile_units > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GatherGeometry g{window,        max_warps,  block_rows, n_rows,
                         n_out,         units_per_row, tile_units,
                         elem_chunk};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      packed ? launch_unit<true>(unit, table, tags, meta, out, g, n_windows,
                                 threads, smem_bytes, st)
             : launch_unit<false>(unit, table, tags, meta, out, g, n_windows,
                                  threads, smem_bytes, st);
  return static_cast<int>(err);
}
