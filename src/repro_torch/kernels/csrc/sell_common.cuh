// The one device body of the SELL SpMV and SpMM kernels, and its launcher.
//
// Plan layout (kernels/sell_spmv.py: DevicePlan), window w = s * n_chunks + c
// of slice s, chunk c; element e = cc * H + h of a window is SELL column
// c * C + cc, row h of the slice:
//   tags   (n_windows, max_warps) int32   wide-block id of each warp
//   meta   packed   (n_windows, window) int32      (warp << 16) | offset
//          unpacked (n_windows, 2, window) int32   lane 0 warp, lane 1 offset
//   values (n_windows, window) float | bf16        (n_slices, W, H) in memory
//
// Y[s*H + h, j] = sum over the slice's elements of
// value * X[tag * block_rows + offset, j], X row-major (n_cols, k). SpMV is
// the instance k = kt = 1 (x a column, y a vector). A block owns one k-tile
// of `slices_per_block` slices, blockDim = (kt, H, slices_per_block): thread
// (j, h, z) computes row h of its slice, column j of the tile. Per chunk the
// slice's threads copy each unique tag's (block_rows, kt) tile of X into
// shared memory once (the coalesced wide fetch); then each thread walks the
// chunk's C columns, decodes the metadata and accumulates
// value * tile[warp][offset][j] in a float register. Values and metadata are
// read at neighbouring addresses by neighbouring rows h. Columns past k in
// the last tile are masked. A window whose tiles exceed the shared-memory
// budget is staged in groups of `group` warps, one pass per group.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sell {
namespace {

struct Geometry {
  int n_slices, n_chunks, C, H, max_warps, block_rows, n_cols, k, kt, group;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (warp, offset) of element e of window w. The packed word is decoded as an
// unsigned value: warp ids >= 2^15 set the int32 sign bit, and the shift
// must be logical.
template <bool PACKED>
__device__ __forceinline__ void decode(const int32_t* __restrict__ meta,
                                       long long w, int window, int e,
                                       int& warp, int& offset) {
  if (PACKED) {
    const uint32_t m = static_cast<uint32_t>(meta[w * window + e]);
    warp = static_cast<int>(m >> 16);
    offset = static_cast<int>(m & 0xFFFFu);
  } else {
    const int32_t* base = meta + w * 2 * window;
    warp = base[e];
    offset = base[window + e];
  }
}

// The coalesced wide fetch: copy warps [g0, g1) of one window into shared
// memory, tile[(t - g0) * block_rows + r][j] = X[tag[t] * block_rows + r,
// col0 + j], for j < kt. Rows outside [0, n_cols) and columns past k read
// as 0, so a malformed tag cannot read outside X. Consecutive threads take
// consecutive j.
__device__ __forceinline__ void stage_wide_blocks(
    float* __restrict__ tile, const float* __restrict__ X,
    const int32_t* __restrict__ tag_row, int g0, int g1, int block_rows,
    int kt, int n_cols, int k, int col0, int tid, int nthreads) {
  const int total = (g1 - g0) * block_rows * kt;
  for (int i = tid; i < total; i += nthreads) {
    const int j = i % kt;
    const int r = (i / kt) % block_rows;
    const int t = g0 + i / (kt * block_rows);
    const long long row =
        static_cast<long long>(tag_row[t]) * block_rows + r;
    const int col = col0 + j;
    tile[i] = (row >= 0 && row < n_cols && col < k)
                  ? X[row * static_cast<long long>(k) + col]
                  : 0.0f;
  }
}

template <typename VT, bool PACKED>
__global__ void sell_kernel(const VT* __restrict__ values,
                            const float* __restrict__ X,
                            const int32_t* __restrict__ tags,
                            const int32_t* __restrict__ meta,
                            float* __restrict__ Y, const Geometry g) {
  extern __shared__ float smem[];
  const int j = threadIdx.x;
  const int h = threadIdx.y;
  const int s = blockIdx.x * blockDim.z + threadIdx.z;
  const int col0 = blockIdx.y * g.kt;
  const int col = col0 + j;
  const bool live = s < g.n_slices;
  const int window = g.C * g.H;
  const int tid = h * g.kt + j;
  float* tile = smem + static_cast<size_t>(threadIdx.z) * g.group *
                           g.block_rows * g.kt;
  float acc = 0.0f;
  for (int c = 0; c < g.n_chunks; ++c) {
    const long long w = static_cast<long long>(s) * g.n_chunks + c;
    for (int g0 = 0; g0 < g.max_warps; g0 += g.group) {
      const int g1 = min(g0 + g.group, g.max_warps);
      if (live) {
        stage_wide_blocks(tile, X, tags + w * g.max_warps, g0, g1,
                          g.block_rows, g.kt, g.n_cols, g.k, col0, tid,
                          g.kt * g.H);
      }
      __syncthreads();
      if (live && col < g.k) {
        const VT* vals = values + w * window;
        for (int cc = 0; cc < g.C; ++cc) {
          const int e = cc * g.H + h;
          int warp, offset;
          decode<PACKED>(meta, w, window, e, warp, offset);
          if (warp >= g0 && warp < g1 &&
              static_cast<unsigned>(offset) <
                  static_cast<unsigned>(g.block_rows)) {
            acc += to_f32(vals[e]) *
                   tile[((warp - g0) * g.block_rows + offset) * g.kt + j];
          }
        }
      }
      __syncthreads();
    }
  }
  if (live && col < g.k) {
    Y[(static_cast<long long>(s) * g.H + h) * g.k + col] = acc;
  }
}

template <typename VT, bool PACKED>
cudaError_t launch_as(const void* values, const void* X, const void* tags,
                      const void* meta, void* Y, const Geometry& g,
                      int slices_per_block, int smem_bytes,
                      cudaStream_t stream) {
  auto kernel = sell_kernel<VT, PACKED>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 block(g.kt, g.H, slices_per_block);
  const dim3 grid((g.n_slices + slices_per_block - 1) / slices_per_block,
                  (g.k + g.kt - 1) / g.kt);
  kernel<<<grid, block, smem_bytes, stream>>>(
      static_cast<const VT*>(values), static_cast<const float*>(X),
      static_cast<const int32_t*>(tags), static_cast<const int32_t*>(meta),
      static_cast<float*>(Y), g);
  return cudaGetLastError();
}

// Launch the instance for the value dtype and metadata encoding on `stream`;
// returns the launch's CUDA error code.
int launch(const void* values, const void* X, const void* tags,
           const void* meta, void* Y, int values_bf16, int packed,
           const Geometry& g, int slices_per_block, int smem_bytes,
           void* stream) {
  if (g.n_slices < 1 || g.k < 1 || g.kt < 1 || slices_per_block < 1 ||
      g.group < 1 || g.max_warps < 1 || g.H < 1 ||
      g.kt * g.H * slices_per_block > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto run =
      values_bf16
          ? (packed ? launch_as<__nv_bfloat16, true>
                    : launch_as<__nv_bfloat16, false>)
          : (packed ? launch_as<float, true> : launch_as<float, false>);
  return static_cast<int>(
      run(values, X, tags, meta, Y, g, slices_per_block, smem_bytes, st));
}

}  // namespace
}  // namespace sell
