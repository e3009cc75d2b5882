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
// the instance NC = 1, k = 1 (x a column, y a vector).
//
// Geometry (kernels/sell_spmv.py: launch_config). A block takes
// `slices_per_block` slices at a time and one column tile of `col_tile` =
// NC * quads columns of X; a grid column exists only where k > col_tile, so
// at k <= col_tile (128 for SpMM) values and metadata are read once per
// launch. Blocks are persistent: as many as fit on the card, block b taking
// slice groups b, b + gridDim.x, ... Thread (h, q) of a slice owns row h and
// NC columns: float4 groups q, q + quads, ... of the tile, so the 8 threads
// of a quarter-warp that share a row read 128 contiguous bytes of shared
// memory.
//
// Pipeline. A block's work is a sequence of steps, one per (slice group,
// chunk, group of `group` warps); group = max_warps unless a window's wide
// blocks exceed the shared-memory budget, and then each chunk takes several
// steps. Each step has a stage in a ring of `depth` (= buffer_depth) stages
// in shared memory, which runs on from one slice group to the next: the
// step's wide blocks of X (each unique tag's (block_rows, col_tile) tile,
// copied once: the coalesced wide fetch), its values and its metadata words,
// all copied with cp.async. While step i computes, the copies of steps
// i+1 .. i+depth-1 are in flight; one barrier a step (two at depth 1, which
// does not overlap). Values and metadata words are read from the stage once
// per row: the NC threads of a row read the same shared word (a broadcast).
// An element outside the step's group of warps reads a zero row with a
// zero value, without a branch. Rows of X outside [0, n_cols) are
// zero-filled, columns past k are never copied and their sums never stored,
// so a malformed tag cannot read outside X; X is reached only through tags
// and metadata.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "plan_meta.cuh"

namespace sell {
namespace {

constexpr int kMaxDepth = 8;
// Devices a process may launch on (the attribute cache of `launch_as`).
constexpr int kMaxDevices = 64;

struct Geometry {
  int n_slices, n_chunks, C, H, max_warps, block_rows, n_cols, k;
  int quads, col_tile, slices_per_block, group, depth;
  int val_unit, meta_unit;  // bytes a copy moves: 16, 4 (cp.async) or 2
};

// Sections of shared memory start on 128-byte lines: a warp's 16-byte
// cp.async pieces then fill whole lines (on an H100, stage sections 16
// bytes off a line made SpMV markedly slower).
__host__ __device__ __forceinline__ int align128(int bytes) {
  return (bytes + 127) & ~127;
}

// Bytes of the block's zero row (col_tile floats, read in place of a tile
// row by elements outside the step's group of warps), which precedes the
// slices' rings in shared memory.
__host__ __device__ __forceinline__ int zero_row_bytes(const Geometry& g) {
  return align128(g.col_tile * 4);
}

// Bytes of one slice's stage: X tiles, then values, then metadata, each
// section 128-byte aligned.
template <typename VT, bool PACKED>
__host__ __device__ __forceinline__ void stage_layout(const Geometry& g,
                                                      int& tile_bytes,
                                                      int& vals_bytes,
                                                      int& stage_bytes) {
  const int window = g.C * g.H;
  tile_bytes = align128(g.group * g.block_rows * g.col_tile * 4);
  vals_bytes = align128(window * static_cast<int>(sizeof(VT)));
  const int meta_bytes = align128(window * (PACKED ? 1 : 2) * 4);
  stage_bytes = tile_bytes + vals_bytes + meta_bytes;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// cp.async of UNIT bytes; src_bytes < UNIT zero-fills the rest (0 reads
// nothing from `src`, which must still be a valid address).
template <int UNIT>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (UNIT == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(UNIT), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

// Copy `nbytes` contiguous bytes into shared memory in `unit`-byte pieces
// (the wrapper picks the widest unit dividing the size and the address of
// every window). 2-byte pieces (bf16 values of an odd-sized window) have
// no cp.async and are copied synchronously; the step's barrier covers them.
__device__ __forceinline__ void copy_bytes(unsigned char* dst,
                                           const unsigned char* src,
                                           int nbytes, int unit, int tid,
                                           int nthreads) {
  switch (unit) {
    case 16:
#pragma unroll 1
      for (int i = tid * 16; i < nbytes; i += nthreads * 16)
        cp_async<16>(dst + i, src + i, 16);
      break;
    case 4:
#pragma unroll 1
      for (int i = tid * 4; i < nbytes; i += nthreads * 4)
        cp_async<4>(dst + i, src + i, 4);
      break;
    default:
#pragma unroll 1
      for (int i = tid * 2; i < nbytes; i += nthreads * 2)
        *reinterpret_cast<uint16_t*>(dst + i) =
            *reinterpret_cast<const uint16_t*>(src + i);
  }
}

// How a slice's threads split the wide fetch, fixed for a block. A copy
// row is one tag's whole (block_rows, k) block when the tile's rows are X's
// rows end to end (`flat`: one column tile, col_tile == k; SpMV always),
// else one row of X's column tile. Threads form an RT x UT grid over copy
// rows and their XUNIT-byte pieces, so the loop divides nothing.
struct CopyGrid {
  bool flat;
  int row_units, row_stride, ry, ux, RT, UT;
  unsigned whole;  // blocks of X with all block_rows rows
};

template <int XUNIT>
__device__ __forceinline__ CopyGrid copy_grid(const Geometry& g, int kc,
                                              int tid, int nthreads) {
  CopyGrid c;
  c.flat = g.col_tile == g.k;
  c.row_units = (c.flat ? g.block_rows * g.k : kc) / (XUNIT / 4);
  c.row_stride = c.flat ? g.block_rows * g.k : g.col_tile;
  c.UT = min(c.row_units, nthreads);
  c.RT = nthreads / c.UT;
  c.ry = tid / c.UT;
  c.ux = tid - c.ry * c.UT;
  if (c.ry >= c.RT) c.ry = 1 << 30;  // idle: more threads than the grid
  c.whole = static_cast<unsigned>(g.n_cols / g.block_rows);
  return c;
}

// Copy `rows_all` X rows from `row0` (one tag's block, or one row) to
// `dst`, in XUNIT-byte pieces u = ux, ux + UT, ...; rows past n_cols (the
// last, partial block of X, or a tag outside X) are zero-filled.
template <int XUNIT>
__device__ __forceinline__ void copy_x_row(float* dst, const float* X,
                                           long long row0, int rows_all,
                                           bool whole, const Geometry& g,
                                           const CopyGrid& c, int col0) {
  constexpr int F = XUNIT / 4;
  const float* src = X + row0 * g.k + col0;
  if (whole) {
#pragma unroll 1
    for (int u = c.ux; u < c.row_units; u += c.UT)
      cp_async<XUNIT>(dst + u * F, src + u * F, XUNIT);
    return;
  }
  const long long left = g.n_cols - row0;
  const int rows_ok = row0 < 0 ? 0 : static_cast<int>(
      max(0LL, min(left, static_cast<long long>(rows_all))));
#pragma unroll 1
  for (int u = c.ux; u < c.row_units; u += c.UT) {
    const bool ok = rows_ok > 0 && (u * F) / g.k < rows_ok;
    cp_async<XUNIT>(dst + u * F, ok ? src + u * F : X, ok ? XUNIT : 0);
  }
}

// The coalesced wide fetch of one step: warps [g0, g1) of window `tag_row`,
// tile[(t - g0) * block_rows + r][j] = X[tag[t] * block_rows + r, col0 + j]
// for j < kc, in XUNIT-byte pieces (16 needs the row's floats and X's base
// 16-byte aligned). A window's tags are sorted and unique, and its SENTINEL
// slots were lowered to tag 0 (kernels/sell_spmv.py: build_device_plan), so
// a slot whose tag is not above the one before it is padding that no
// element reads: it is not copied.
template <int XUNIT>
__device__ __forceinline__ void stage_wide_blocks(
    float* __restrict__ tile, const float* __restrict__ X,
    const int32_t* __restrict__ tag_row, int g0, int g1, const Geometry& g,
    const CopyGrid& c, int col0) {
  const int br = g.block_rows;
  if (c.flat) {
#pragma unroll 1
    for (int t = c.ry; t < g1 - g0; t += c.RT) {
      const int tag = tag_row[g0 + t];
      if (g0 + t > 0 && tag <= tag_row[g0 + t - 1]) continue;
      copy_x_row<XUNIT>(tile + t * c.row_stride, X,
                        static_cast<long long>(tag) * br, br,
                        static_cast<unsigned>(tag) < c.whole, g, c, col0);
    }
    return;
  }
#pragma unroll 1
  for (int rr = c.ry; rr < (g1 - g0) * br; rr += c.RT) {
    const int t = rr / br;
    const int tag = tag_row[g0 + t];
    if (g0 + t > 0 && tag <= tag_row[g0 + t - 1]) continue;
    copy_x_row<XUNIT>(tile + rr * c.row_stride, X,
                      static_cast<long long>(tag) * br + (rr - t * br), 1,
                      static_cast<unsigned>(tag) < c.whole, g, c, col0);
  }
}

// Where a step of a block's walk is: slice, chunk, group of warps.
struct Cursor {
  int s, c, gi;
  __device__ __forceinline__ void advance(int n_groups, int n_chunks,
                                          int slice_stride) {
    if (++gi < n_groups) return;
    gi = 0;
    if (++c < n_chunks) return;
    c = 0;
    s += slice_stride;
  }
};

template <typename VT, bool PACKED, int NC, int XUNIT>
__global__ void __launch_bounds__(1024)
    sell_kernel(const VT* __restrict__ values, const float* __restrict__ X,
                const int32_t* __restrict__ tags,
                const int32_t* __restrict__ meta, float* __restrict__ Y,
                const Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  static_assert(NC == 1 || NC % 4 == 0, "NC is 1 or a multiple of 4");
  const int tps = g.H * g.quads;  // threads a slice
  const int z = threadIdx.x / tps;
  const int lt = threadIdx.x - z * tps;
  const int h = lt / g.quads;
  const int q = lt - h * g.quads;
  const int col0 = blockIdx.y * g.col_tile;
  const int kc = min(g.col_tile, g.k - col0);
  const int window = g.C * g.H;
  const int lanes = PACKED ? 1 : 2;
  int tile_bytes, vals_bytes, stage_bytes;
  stage_layout<VT, PACKED>(g, tile_bytes, vals_bytes, stage_bytes);
  const int n_groups = (g.max_warps + g.group - 1) / g.group;
  // The block walks slice groups blockIdx.x, + gridDim.x, ...; each takes
  // `sps` steps, and the ring runs on across them.
  const int sps = g.n_chunks * n_groups;
  const int n_sg = (g.n_slices + g.slices_per_block - 1) / g.slices_per_block;
  const int my_sg = static_cast<int>(blockIdx.x) < n_sg
                        ? (n_sg - 1 - blockIdx.x) / gridDim.x + 1
                        : 0;
  const int n_steps = my_sg * sps;
  float* zero_row = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < g.col_tile; i += blockDim.x) zero_row[i] = 0.f;
  unsigned char* ring = smem + zero_row_bytes(g) +
                        static_cast<size_t>(z) * g.depth * stage_bytes;
  const CopyGrid grid = copy_grid<XUNIT>(g, kc, lt, tps);

  // Step cursors (slice, chunk, group of warps), one for the copies and
  // one for the compute, each advanced a step at a time.
  const int slice_stride = gridDim.x * g.slices_per_block;
  Cursor fetch{static_cast<int>(blockIdx.x) * g.slices_per_block + z, 0, 0};
  Cursor work = fetch;
  int issued = 0, fetch_slot = 0, work_slot = 0;
  auto issue = [&]() {
    const Cursor at = fetch;
    unsigned char* slot = ring + fetch_slot * stage_bytes;
    fetch.advance(n_groups, g.n_chunks, slice_stride);
    if (++fetch_slot == g.depth) fetch_slot = 0;
    if (issued++ >= n_steps || at.s >= g.n_slices) return;
    const int s = at.s, c = at.c, g0 = at.gi * g.group;
    const int g1 = min(g0 + g.group, g.max_warps);
    const long long w = static_cast<long long>(s) * g.n_chunks + c;
    copy_bytes(slot + tile_bytes,
               reinterpret_cast<const unsigned char*>(values + w * window),
               window * static_cast<int>(sizeof(VT)), g.val_unit, lt, tps);
    copy_bytes(slot + tile_bytes + vals_bytes,
               reinterpret_cast<const unsigned char*>(meta +
                                                      w * window * lanes),
               window * lanes * 4, g.meta_unit, lt, tps);
    stage_wide_blocks<XUNIT>(reinterpret_cast<float*>(slot), X,
                             tags + w * g.max_warps, g0, g1, g, grid, col0);
  };
  auto store = [&](int s, const float* acc) {
    if (s >= g.n_slices) return;
    float* yrow = Y + (static_cast<long long>(s) * g.H + h) * g.k;
    if constexpr (NC == 1) {
      yrow[col0] = acc[0];
    } else {
#pragma unroll
      for (int i = 0; i < NC / 4; ++i) {
        const int col = col0 + 4 * (q + i * g.quads);
        if (XUNIT == 16 && col < g.k) {  // k % 4 == 0: the float4 is live
          *reinterpret_cast<float4*>(yrow + col) =
              make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                          acc[4 * i + 3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (col + u < g.k) yrow[col + u] = acc[4 * i + u];
        }
      }
    }
  };

  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.0f;
  if (sps == 0) {  // no columns at all: every row is 0
    for (int i = 0; i < my_sg; ++i)
      store((blockIdx.x + i * gridDim.x) * g.slices_per_block + z, acc);
    return;
  }

  for (int i = 0; i + 1 < g.depth; ++i) {
    issue();
    cp_async_commit();
  }
  for (int j = 0; j < n_steps; ++j) {
    if (g.depth == 1) {  // no overlap: the one slot is free after a barrier
      __syncthreads();
      issue();
      cp_async_commit();
    }
    cp_async_wait(g.depth == 1 ? 0 : g.depth - 2);
    __syncthreads();  // step j's stage landed; step j - 1's slot is free
    if (g.depth > 1) {
      issue();  // step j + depth - 1
      cp_async_commit();
    }
    const int s = work.s, c = work.c, g0 = work.gi * g.group;
    const unsigned char* slot = ring + work_slot * stage_bytes;
    work.advance(n_groups, g.n_chunks, slice_stride);
    if (++work_slot == g.depth) work_slot = 0;
    if (s >= g.n_slices) continue;
    // Element e = cc * H + h of the stage; one outside the step's group of
    // warps (or, in a malformed plan, outside its block) reads the zero
    // row with a zero value instead.
    const int H = g.H, br = g.block_rows, ct = g.col_tile;
    const float* tile =
        reinterpret_cast<const float*>(slot) + (NC == 1 ? 0 : 4 * q);
    const float* zero = zero_row + (NC == 1 ? 0 : 4 * q);
    const VT* sv = reinterpret_cast<const VT*>(slot + tile_bytes) + h;
    const int32_t* sm =
        reinterpret_cast<const int32_t*>(slot + tile_bytes + vals_bytes) + h;
    const unsigned n_live =
        static_cast<unsigned>(min(g.group, g.max_warps - g0));
#pragma unroll 8
    for (int cc = 0; cc < g.C; ++cc) {
      int warp, offset;
      ::plan::decode<PACKED>(sm, 0, window, cc * H, warp, offset);
      const int t = warp - g0;
      const bool ok = static_cast<unsigned>(t) < n_live &&
                      static_cast<unsigned>(offset) < static_cast<unsigned>(br);
      const float v = ok ? to_f32(sv[cc * H]) : 0.0f;
      const float* row = ok ? tile + (t * br + offset) * ct : zero;
      if constexpr (NC == 1) {
        acc[0] += v * row[0];
      } else {
#pragma unroll
        for (int i = 0; i < NC / 4; ++i) {
          const float4 x = reinterpret_cast<const float4*>(row)[i * g.quads];
          acc[4 * i] += v * x.x;
          acc[4 * i + 1] += v * x.y;
          acc[4 * i + 2] += v * x.z;
          acc[4 * i + 3] += v * x.w;
        }
      }
    }
    if (c == g.n_chunks - 1 && g0 + g.group >= g.max_warps) {
      store(s, acc);  // the slice's last step
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] = 0.0f;
    }
  }
  cp_async_wait(0);
}

template <typename VT, bool PACKED, int NC, int XUNIT>
cudaError_t launch_as(const void* values, const void* X, const void* tags,
                      const void* meta, void* Y, const Geometry& g,
                      int smem_bytes, cudaStream_t stream) {
  int tile_bytes, vals_bytes, stage_bytes;
  stage_layout<VT, PACKED>(g, tile_bytes, vals_bytes, stage_bytes);
  if (smem_bytes <
      zero_row_bytes(g) + g.slices_per_block * g.depth * stage_bytes) {
    return cudaErrorInvalidValue;
  }
  auto kernel = sell_kernel<VT, PACKED, NC, XUNIT>;
  int device, sms, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (smem_bytes > 48 * 1024) {
    // Raised once per instance, device and size rather than at every
    // launch, so that a launch captured into a CUDA graph (the solvers')
    // makes no attribute call.
    static int attribute_bytes[kMaxDevices] = {};
    if (device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (smem_bytes > attribute_bytes[device]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return err;
      attribute_bytes[device] = smem_bytes;
    }
  }
  // Persistent blocks: as many as fit on the card at once, each walking
  // slice groups (a smaller grid where there are fewer).
  const int threads = g.slices_per_block * g.H * g.quads;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem_bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_sg = (g.n_slices + g.slices_per_block - 1) / g.slices_per_block;
  const dim3 block(threads);
  const dim3 grid(min(n_sg, per_sm * sms),
                  (g.k + g.col_tile - 1) / g.col_tile);
  kernel<<<grid, block, smem_bytes, stream>>>(
      static_cast<const VT*>(values), static_cast<const float*>(X),
      static_cast<const int32_t*>(tags), static_cast<const int32_t*>(meta),
      static_cast<float*>(Y), g);
  return cudaGetLastError();
}

__host__ __forceinline__ bool unit_ok(int unit) {
  return unit == 16 || unit == 4 || unit == 2;
}

// Launch the instance for the value dtype, metadata encoding and X copy
// unit on `stream`; returns the launch's CUDA error code.
template <int NC>
int launch(const void* values, const void* X, const void* tags,
           const void* meta, void* Y, int values_bf16, int packed,
           int x_unit, const Geometry& g, int smem_bytes, void* stream) {
  const long long threads =
      static_cast<long long>(g.slices_per_block) * g.H * g.quads;
  if (g.n_slices < 1 || g.k < 1 || g.H < 1 || g.quads < 1 ||
      g.col_tile != NC * g.quads || g.slices_per_block < 1 || g.group < 1 ||
      g.max_warps < 1 || g.depth < 1 || g.depth > kMaxDepth ||
      threads > 1024 || (x_unit != 4 && x_unit != 16) ||
      (x_unit == 16 && (NC == 1 ? g.block_rows : g.k) % 4 != 0) ||
      !unit_ok(g.val_unit) || !unit_ok(g.meta_unit) || g.meta_unit < 4 ||
      (!values_bf16 && g.val_unit < 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  using Fn = cudaError_t (*)(const void*, const void*, const void*,
                             const void*, void*, const Geometry&, int,
                             cudaStream_t);
  Fn run;
  if (x_unit == 16) {
    run = values_bf16 ? (packed ? launch_as<__nv_bfloat16, true, NC, 16>
                                : launch_as<__nv_bfloat16, false, NC, 16>)
                      : (packed ? launch_as<float, true, NC, 16>
                                : launch_as<float, false, NC, 16>);
  } else {
    run = values_bf16 ? (packed ? launch_as<__nv_bfloat16, true, NC, 4>
                                : launch_as<__nv_bfloat16, false, NC, 4>)
                      : (packed ? launch_as<float, true, NC, 4>
                                : launch_as<float, false, NC, 4>);
  }
  return static_cast<int>(
      run(values, X, tags, meta, Y, g, smem_bytes, st));
}

}  // namespace
}  // namespace sell
