// Row gather over a coalesced plan, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/coalesced_gather.py:
// coalesced_gather_pallas (body _kernel): out[i] = table[indices[i]] for a
// (R, D) table, through the gather-geometry DevicePlan (one window of
// `window` elements per plan slice): element e of window w reads row
// tags[w, warp] * block_rows + offset, and rows at or past R, or elements
// whose warp or offset is out of range, read as zeros.
//
// Bound: device-memory bytes. The least the card can do is read each
// distinct row once and write each output row once; there is no arithmetic
// on the data. The TPU kernel fetches each unique (block_rows, D) block of a
// window into VMEM once and extracts rows with a one-hot matmul on the MXU;
// that costs operations Hopper does not need, and it is not exact (0 * inf
// is nan, -0.0 + 0.0 is +0.0). Here the kernel copies bytes, so out equals
// table[indices] bitwise for every dtype.
//
// Design:
// 1. Read once per window, write to many. The distinct source rows of a
//    window are its distinct keys warp * block_rows + offset. For each work
//    item the block builds, in shared memory, the list of output positions
//    each distinct key feeds: the window's tags staged, the first
//    occurrence of each key (shared-memory atomicMin over the key range), a
//    count per key, one block-wide scan in element order, and the lists
//    filled by atomic cursors. A row is then fetched once and stored to
//    every output that names it. No plan array is added: the tables come
//    from the plan's tags and metadata words. A window longer than the
//    per-element tables hold is taken in element chunks of `chunk`
//    elements, each read once per chunk; only the key-indexed first-
//    occurrence table and the tags span the whole window.
// 2. TMA bulk copies through a ring (the bulk path). Warp 0 drives a
//    `depth`-stage ring of row tiles: lane 0 issues one 1-D cp.async.bulk
//    of a row tile into a stage, completing on the stage's mbarrier; once
//    the barrier's phase completes, the warp's lanes issue one bulk store
//    (cp.async.bulk.global.shared::cta.bulk_group) per output naming the
//    row, then commit. depth - 1 loads are in flight while one stage is
//    stored, and a stage is loaded again only after its stores have read it
//    (cp.async.bulk.wait_group.read). No register or instruction is spent
//    per byte. While the tables are built, the rows the ring will likely
//    load first are prefetched into L2; the other warps write the zero rows
//    with plain 16-byte stores while warp 0 copies.
// 3. Persistent blocks, work split by bytes. The grid is a small multiple
//    of the SM count. A block takes its first work item (window, group,
//    column tile) by its index and the next ones from a counter the grid
//    shares, so that blocks the memory system serves faster take more. A
//    group is a run of a window's distinct keys, in first-occurrence order,
//    whose bytes (one read per real row plus one write per output) are a
//    1/G share of the window's; a partial window gets groups in proportion
//    to its elements. Building an item's tables scans the window's
//    metadata words once; no window is sorted.
// 4. The unit path. Rows whose bytes or base addresses are not multiples of
//    16 (D = 3 bf16, D = 33 f32, offset views), or rows too narrow for bulk
//    copies to pay, keep a vector-unit copy: each thread loads one 16/8/4/2/
//    1-byte unit of a distinct row and stores it to every output naming the
//    row, with the same fan-out tables. Threads walk (row, unit) pairs with
//    cursors, not a division per unit. The wrapper chooses the path from
//    the geometry before the launch.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "plan_meta.cuh"

namespace {

struct GatherGeometry {
  int window, max_warps, block_rows, n_rows, n_out, n_keys;
  int chunk;        // elements of a window one fan-out covers
  int chunks_full;  // chunks of a full window
  int chunks_last;  // chunks of the last window
  int n_windows;    // windows that hold outputs
  int row_units;    // units of a row (bytes on the bulk path)
  int tile;         // units of a row one item covers
  int n_tiles;      // column tiles of a row
  int groups_full;  // groups of a chunk
  int groups_last;  // groups of the last chunk of the last window
  int items;        // (window, chunk, group, tile) work items
  int depth;        // ring stages (bulk path), else 0
  int stage_bytes;  // bytes of a ring stage (multiple of 128), else 0
};

constexpr int kScanWords = 34;  // per-warp partial sums of the block scan

__host__ __device__ inline long long align16(long long n) {
  return (n + 15) / 16 * 16;
}

// Byte offsets of the shared-memory sections (the wrapper's
// kernels/coalesced_gather.py:fanout_smem_bytes computes the same total).
struct Layout {
  long long bars, scan, wsum, first, tag, ekey, erow, efirst, cnt, fill, list,
      slot_row, real_slot, slot_start, scal, total;
};

__host__ __device__ inline Layout layout(const GatherGeometry& g) {
  Layout l;
  const long long win = align16(4LL * g.chunk);
  long long off = static_cast<long long>(g.depth) * g.stage_bytes;
  l.bars = off;       off += align16(8LL * g.depth);
  l.scan = off;       off += align16(8LL * g.chunk);
  l.wsum = off;       off += 8LL * kScanWords;
  l.first = off;      off += align16(4LL * g.n_keys);
  l.tag = off;        off += align16(4LL * g.max_warps);
  l.ekey = off;       off += win;
  l.erow = off;       off += win;
  l.efirst = off;     off += win;
  l.cnt = off;        off += win;
  l.fill = off;       off += win;
  l.list = off;       off += win;
  l.slot_row = off;   off += win;
  l.real_slot = off;  off += win;
  l.slot_start = off; off += align16(4LL * (g.chunk + 1));
  l.scal = off;       off += 16;
  l.total = off;
  return l;
}

// The block scan packs three counters of one element into 64 bits, 21 bits
// each (the wrapper keeps chunk < 2^20): its key's output count, whether
// it is the first occurrence of a real (in-range) row, and whether it is a
// first occurrence at all.
constexpr int kField = 21;
constexpr unsigned long long kMask = (1ULL << kField) - 1;
__device__ __forceinline__ int f_cnt(unsigned long long v) {
  return static_cast<int>(v & kMask);
}
__device__ __forceinline__ int f_real(unsigned long long v) {
  return static_cast<int>((v >> kField) & kMask);
}
__device__ __forceinline__ int f_first(unsigned long long v) {
  return static_cast<int>((v >> (2 * kField)) & kMask);
}

struct Tables {
  unsigned long long* scan;  // exclusive scan of the packed counters
  unsigned long long* wsum;
  int32_t* first;      // [n_keys] first element naming a key, INT_MAX = none
  int32_t* tag;        // [max_warps] the window's tags
  // per element of the chunk:
  int32_t* ekey;       // key of each element, -1 = out of range
  int32_t* erow;       // source row of each element, -1 = zeros
  int32_t* efirst;     // first element naming the element's key
  int32_t* cnt;        // outputs of the key first named at this element
  int32_t* fill;       // list cursor of the key first named at this element
  int32_t* list;       // outputs of the group's keys, slot after slot
  int32_t* slot_row;   // source row of each slot, -1 = zeros
  int32_t* real_slot;  // slots with a source row, in order
  int32_t* slot_start; // [n_slots + 1] list offsets
  int32_t* scal;       // [0] lowest member element, [1] highest, [2] item
};

__device__ inline Tables tables(unsigned char* smem, const GatherGeometry& g) {
  const Layout l = layout(g);
  auto i32 = [&](long long off) {
    return reinterpret_cast<int32_t*>(smem + off);
  };
  return Tables{reinterpret_cast<unsigned long long*>(smem + l.scan),
                reinterpret_cast<unsigned long long*>(smem + l.wsum),
                i32(l.first),     i32(l.tag),      i32(l.ekey),
                i32(l.erow),      i32(l.efirst),   i32(l.cnt),
                i32(l.fill),      i32(l.list),     i32(l.slot_row),
                i32(l.real_slot), i32(l.slot_start), i32(l.scal)};
}

// Exclusive scan of value(e) over e < n into out[e]; returns the total.
// blockDim.x is a multiple of 32; every thread calls it.
template <typename F>
__device__ unsigned long long block_scan(int n, F value,
                                         unsigned long long* out,
                                         unsigned long long* wsum) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned long long carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int e = base + threadIdx.x;
    const unsigned long long v = e < n ? value(e) : 0ULL;
    unsigned long long x = v;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) wsum[wid] = x;
    __syncthreads();
    if (wid == 0) {
      unsigned long long s = lane < nw ? wsum[lane] : 0ULL;
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long y = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += y;
      }
      if (lane < nw) wsum[lane] = s;
    }
    __syncthreads();
    if (e < n) out[e] = carry + (wid > 0 ? wsum[wid - 1] : 0ULL) + x - v;
    carry += wsum[nw - 1];
    // wsum is written again by the next chunk, or by the next item's scan
    // after the fan-out's later barriers
    if (base + static_cast<int>(blockDim.x) < n) __syncthreads();
  }
  return carry;
}

// One work item's place: window w, its elements [e0, e0 + n) (one chunk),
// group grp of G, column tile t.
struct Item {
  int w, e0, n, grp, G, t;
};

__device__ inline Item item_of(int item, const GatherGeometry& g) {
  Item it;
  const int j = item / g.n_tiles;
  it.t = item - j * g.n_tiles;
  const int c = j / g.groups_full;  // chunk, counted over all windows
  it.grp = j - c * g.groups_full;
  it.w = c / g.chunks_full;
  it.e0 = (c - it.w * g.chunks_full) * g.chunk;
  it.n = min(g.chunk, min(g.window, g.n_out - it.w * g.window) - it.e0);
  const bool last = it.w == g.n_windows - 1 &&
                    c - it.w * g.chunks_full == g.chunks_last - 1;
  it.G = last ? g.groups_last : g.groups_full;
  return it;
}

// A group's slots: n_slots keys (n_real with a source row) whose outputs
// are list[slot_start[s] .. slot_start[s + 1]).
struct Group {
  int n_slots, n_real;
};

// Build the fan-out tables of item `it`. Every thread calls it; it ends
// with the tables complete and visible. `on_row(e, row)` sees each
// element's source row (-1 for zeros) as soon as it is known.
template <bool PACKED, typename F>
__device__ Group build_fanout(const Tables& tb,
                              const int32_t* __restrict__ tags,
                              const int32_t* __restrict__ meta,
                              const GatherGeometry& g, const Item& it,
                              F on_row) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n = it.n;
  const int32_t* tag_row = tags + static_cast<long long>(it.w) * g.max_warps;
  if (tid == 0) {
    tb.scal[0] = INT_MAX;
    tb.scal[1] = -1;
  }
  // P0: the window's tags into shared memory and each element's (warp,
  // offset) decoded, the two global loads in flight together.
  for (int i = tid; i < max(n, g.max_warps); i += nthreads) {
    int32_t tag = 0;
    int warp = -1, offset = -1;
    if (i < g.max_warps) tag = tag_row[i];
    if (i < n)
      plan::decode<PACKED>(meta, it.w, g.window, it.e0 + i, warp, offset);
    if (i < g.max_warps) tb.tag[i] = tag;
    if (i < n) {
      tb.ekey[i] = warp;
      tb.erow[i] = offset;
      tb.cnt[i] = 0;
      tb.fill[i] = 0;
    }
  }
  __syncthreads();
  // P1: each element's key and row; first occurrence per key.
  for (int e = tid; e < n; e += nthreads) {
    const int warp = tb.ekey[e];
    const int offset = tb.erow[e];
    int key = -1, row = -1;
    if (warp >= 0 && warp < g.max_warps && offset >= 0 &&
        offset < g.block_rows) {
      key = warp * g.block_rows + offset;
      const long long r =
          static_cast<long long>(tb.tag[warp]) * g.block_rows + offset;
      if (r >= 0 && r < g.n_rows) row = static_cast<int>(r);
      atomicMin(&tb.first[key], e);
    }
    tb.ekey[e] = key;
    tb.erow[e] = row;
    on_row(e, row);
  }
  __syncthreads();
  // P2: each element counts towards its key's first occurrence. An element
  // out of range is a key of its own (a zero row).
  for (int e = tid; e < n; e += nthreads) {
    const int key = tb.ekey[e];
    const int f = key >= 0 ? tb.first[key] : e;
    tb.efirst[e] = f;
    atomicAdd(&tb.cnt[f], 1);
  }
  __syncthreads();
  // P3: reset first[] for the next item; scan the packed counters.
  const unsigned long long total = block_scan(
      n,
      [&](int e) -> unsigned long long {
        if (tb.efirst[e] != e) return 0ULL;
        const int key = tb.ekey[e];
        if (key >= 0) tb.first[key] = INT_MAX;
        const unsigned long long real = tb.erow[e] >= 0 ? 1ULL : 0ULL;
        return static_cast<unsigned long long>(tb.cnt[e]) |
               (real << kField) | (1ULL << (2 * kField));
      },
      tb.scan, tb.wsum);
  // The window's bytes in units of a row tile: one write per element, one
  // read per real row. A key belongs to the group in which its share starts.
  const long long W = static_cast<long long>(f_cnt(total)) + f_real(total);
  for (int e = tid; e < n; e += nthreads) {
    if (tb.efirst[e] != e) continue;
    const unsigned long long s = tb.scan[e];
    const long long pos = static_cast<long long>(f_cnt(s)) + f_real(s);
    if (pos * it.G / W == it.grp) {
      atomicMin(&tb.scal[0], e);
      atomicMax(&tb.scal[1], e);
    }
  }
  __syncthreads();
  const int lo = tb.scal[0];
  const int hi = tb.scal[1];
  if (hi < 0) return Group{0, 0};
  // P4: the group's keys are the first occurrences in [lo, hi] (a run in
  // element order); fill their output lists.
  const unsigned long long base = tb.scan[lo];
  for (int e = tid; e < n; e += nthreads) {
    const int f = tb.efirst[e];
    if (f < lo || f > hi) continue;
    const unsigned long long s = tb.scan[f];
    const int start = f_cnt(s) - f_cnt(base);
    tb.list[start + atomicAdd(&tb.fill[f], 1)] = e;
    if (e == f) {
      const int slot = f_first(s) - f_first(base);
      tb.slot_row[slot] = tb.erow[f];
      tb.slot_start[slot] = start;
      if (tb.erow[f] >= 0) tb.real_slot[f_real(s) - f_real(base)] = slot;
      if (f == hi) tb.slot_start[slot + 1] = start + tb.cnt[f];
    }
  }
  __syncthreads();
  const unsigned long long last = tb.scan[hi];
  return Group{f_first(last) - f_first(base) + 1,
               f_real(last) + (tb.erow[hi] >= 0 ? 1 : 0) - f_real(base)};
}

// The block's next work item: blockIdx.x first, then items taken from a
// counter the grid shares, so that blocks that finish early take more.
// Every thread calls it; it ends with a barrier, after which the last
// item's tables are no longer read.
__device__ int next_item(int* queue, int32_t* slot, bool first) {
  if (threadIdx.x == 0)
    *slot = first ? blockIdx.x : gridDim.x + atomicAdd(queue, 1);
  __syncthreads();
  return *slot;
}

// The last block out resets the counter (queue[0]) and the count of blocks
// out (queue[1]) for the next launch on the stream.
__device__ void retire(int* queue) {
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(queue + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      queue[0] = 0;
      queue[1] = 0;
    }
  }
}

// (slot, unit) cursor over a group's n_slots x tu pairs, stepping by the
// block's threads without a division per step.
struct Cursor {
  int s, u, ds, du, tu;
  __device__ Cursor(int first, int step, int units)
      : s(first / units), u(first % units), ds(step / units),
        du(step % units), tu(units) {}
  __device__ void next() {
    s += ds;
    u += du;
    if (u >= tu) {
      u -= tu;
      ++s;
    }
  }
};

// ---------------------------------------------------------------- unit path

template <typename U, bool PACKED>
__global__ void gather_unit_kernel(const U* __restrict__ table,
                                   const int32_t* __restrict__ tags,
                                   const int32_t* __restrict__ meta,
                                   U* __restrict__ out, int* queue,
                                   const GatherGeometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tables tb = tables(smem, g);
  for (int k = threadIdx.x; k < g.n_keys; k += blockDim.x)
    tb.first[k] = INT_MAX;
  for (int item = next_item(queue, tb.scal + 2, true); item < g.items;
       item = next_item(queue, tb.scal + 2, false)) {
    const Item it = item_of(item, g);
    const Group grp =
        build_fanout<PACKED>(tb, tags, meta, g, it, [](int, int) {});
    const int u0 = it.t * g.tile;
    const int tu = min(g.tile, g.row_units - u0);
    const long long out0 = static_cast<long long>(it.w) * g.window + it.e0;
    for (Cursor c(threadIdx.x, blockDim.x, tu); c.s < grp.n_slots;
         c.next()) {
      const int row = tb.slot_row[c.s];
      const long long col = u0 + c.u;
      U v{};
      if (row >= 0) v = table[static_cast<long long>(row) * g.row_units + col];
      const int end = tb.slot_start[c.s + 1];
      for (int j = tb.slot_start[c.s]; j < end; ++j)
        out[(out0 + tb.list[j]) * g.row_units + col] = v;
    }
  }
  retire(queue);
}

// ---------------------------------------------------------------- bulk path

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity. The
// loop is bounded: a wrong parity traps (a launch error) instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spin = 0; spin < (1LL << 26); ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_prefetch_l2(const void* src,
                                                 int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <bool PACKED>
__global__ void gather_bulk_kernel(const unsigned char* __restrict__ table,
                                   const int32_t* __restrict__ tags,
                                   const int32_t* __restrict__ meta,
                                   unsigned char* __restrict__ out,
                                   int* queue, const GatherGeometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tables tb = tables(smem, g);
  const Layout l = layout(g);
  const uint32_t ring = smem_addr(smem);
  const uint32_t bars = smem_addr(smem + l.bars);
  const int lane = threadIdx.x & 31;
  const bool copier = threadIdx.x < 32;
  for (int k = threadIdx.x; k < g.n_keys; k += blockDim.x)
    tb.first[k] = INT_MAX;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.depth; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  unsigned uses = 0;  // ring stages used so far (warp 0's state)
  // next_item's barrier also publishes the barriers' initialisation
  for (int item = next_item(queue, tb.scal + 2, true); item < g.items;
       item = next_item(queue, tb.scal + 2, false)) {
    const Item it = item_of(item, g);
    const int off = it.t * g.tile;
    const int bytes = min(g.tile, g.row_units - off);
    // While the tables are built, start reading into L2 the rows the ring
    // will likely load first: exact where a window's rows are distinct,
    // elsewhere rows that some item reads soon.
    const int guess = it.grp * it.n / it.G;
    const Group grp = build_fanout<PACKED>(
        tb, tags, meta, g, it, [&](int e, int row) {
          if (row >= 0 && e >= guess && e - guess < g.depth - 1)
            bulk_prefetch_l2(table + static_cast<long long>(row) *
                                         g.row_units + off,
                             bytes);
        });
    unsigned char* out0 =
        out + (static_cast<long long>(it.w) * g.window + it.e0) * g.row_units +
        off;
    if (copier) {
      const int D = g.depth;
      // The last item's stores have read their stages before any load.
      bulk_wait_read<0>();
      __syncwarp();
      auto load = [&](int r) {
        const unsigned u = uses + r;
        const uint32_t bar = bars + 8 * (u % D);
        const int row = tb.slot_row[tb.real_slot[r]];
        mbar_expect_tx(bar, bytes);
        bulk_load(ring + (u % D) * g.stage_bytes,
                  table + static_cast<long long>(row) * g.row_units + off,
                  bytes, bar);
      };
      // D - 1 loads are in flight while one stage is being stored.
      if (lane == 0)
        for (int r = 0; r < min(grp.n_real, D - 1); ++r) load(r);
      for (int r = 0; r < grp.n_real; ++r) {
        const unsigned u = uses + r;
        mbar_wait(bars + 8 * (u % D), (u / D) & 1);
        const int slot = tb.real_slot[r];
        const uint32_t src = ring + (u % D) * g.stage_bytes;
        const int end = tb.slot_start[slot + 1];
        for (int j = tb.slot_start[slot] + lane; j < end; j += 32)
          bulk_store(out0 + static_cast<long long>(tb.list[j]) * g.row_units,
                     src, bytes);
        bulk_commit();
        if (r + D - 1 < grp.n_real) {
          // Slot r + D - 1 goes to the stage of slot r - 1: its stores, the
          // group committed before the one just committed, must have read
          // it.
          bulk_wait_read<1>();
          __syncwarp();
          if (lane == 0) load(r + D - 1);
        }
      }
      uses += grp.n_real;
    } else if (grp.n_real < grp.n_slots) {
      // Zero rows: plain 16-byte stores by the other warps.
      const int tu = bytes / 16;
      for (int s = 0; s < grp.n_slots; ++s) {
        if (tb.slot_row[s] >= 0) continue;
        const int beg = tb.slot_start[s];
        const int n_dest = tb.slot_start[s + 1] - beg;
        for (Cursor c(threadIdx.x - 32, blockDim.x - 32, tu); c.s < n_dest;
             c.next()) {
          uint4* dst = reinterpret_cast<uint4*>(
              out0 + static_cast<long long>(tb.list[beg + c.s]) * g.row_units);
          dst[c.u] = make_uint4(0, 0, 0, 0);
        }
      }
    }
  }
  if (copier) bulk_wait_all();
  retire(queue);
}

template <typename U, bool PACKED>
cudaError_t launch_unit(const void* table, const void* tags, const void* meta,
                        void* out, int* queue, const GatherGeometry& g,
                        int grid, int threads, int smem_bytes,
                        cudaStream_t stream) {
  auto kernel = gather_unit_kernel<U, PACKED>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const U*>(table), static_cast<const int32_t*>(tags),
      static_cast<const int32_t*>(meta), static_cast<U*>(out), queue, g);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_bulk(const void* table, const void* tags, const void* meta,
                        void* out, int* queue, const GatherGeometry& g,
                        int grid, int threads, int smem_bytes,
                        cudaStream_t stream) {
  auto kernel = gather_bulk_kernel<PACKED>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const unsigned char*>(table),
      static_cast<const int32_t*>(tags), static_cast<const int32_t*>(meta),
      static_cast<unsigned char*>(out), queue, g);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_path(int unit, const void* table, const void* tags,
                        const void* meta, void* out, int* queue,
                        const GatherGeometry& g, int grid, int threads,
                        int smem_bytes, cudaStream_t st) {
  switch (unit) {
    case 0:
      return launch_bulk<PACKED>(table, tags, meta, out, queue, g, grid,
                                 threads, smem_bytes, st);
    case 16:
      return launch_unit<uint4, PACKED>(table, tags, meta, out, queue, g,
                                        grid, threads, smem_bytes, st);
    case 8:
      return launch_unit<uint2, PACKED>(table, tags, meta, out, queue, g,
                                        grid, threads, smem_bytes, st);
    case 4:
      return launch_unit<uint32_t, PACKED>(table, tags, meta, out, queue, g,
                                           grid, threads, smem_bytes, st);
    case 2:
      return launch_unit<uint16_t, PACKED>(table, tags, meta, out, queue, g,
                                           grid, threads, smem_bytes, st);
    case 1:
      return launch_unit<uint8_t, PACKED>(table, tags, meta, out, queue, g,
                                          grid, threads, smem_bytes, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Copy out[i] = table[row of plan element i] for i < n_out on `stream`.
// `unit` 0 takes the bulk path (row_units, tile in bytes, multiples of 16;
// both base addresses 16-byte aligned), else the unit path with units of
// `unit` bytes (row_units = row bytes / unit, tile in units). `n_windows`
// are the windows holding outputs, each taken in chunks of `chunk` elements
// (`groups_full` groups a chunk, `groups_last` for the last chunk of the
// last window). `queue` is two int32 words, zero before
// the launch and zero again after it: the grid's work counter. Returns the
// launch's CUDA error code; shared memory smaller than the layout needs is
// refused.
extern "C" int coalesced_gather_launch(
    const void* table, const void* tags, const void* meta, void* out,
    void* queue, int packed, int unit, int window, int max_warps,
    int block_rows, int n_rows, int n_out, int chunk, int n_windows,
    int row_units,
    int tile, int n_tiles, int groups_full, int groups_last, int items,
    int depth, int stage_bytes, int grid, int threads, int smem_bytes,
    void* stream) {
  const bool bulk = unit == 0;
  if (window < 1 || chunk < 1 || chunk > window || chunk >= (1 << 20) ||
      max_warps < 1 || block_rows < 1 || n_out < 1 ||
      n_windows != (n_out - 1) / window + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks_full = (window - 1) / chunk + 1;
  const int chunks_last = (n_out - (n_windows - 1) * window - 1) / chunk + 1;
  const long long n_chunks =
      static_cast<long long>(n_windows - 1) * chunks_full + chunks_last;
  const GatherGeometry g{window,      max_warps,   block_rows,  n_rows,
                         n_out,       max_warps * block_rows,   chunk,
                         chunks_full, chunks_last, n_windows,   row_units,
                         tile,        n_tiles,     groups_full, groups_last,
                         items,       depth,       stage_bytes};
  if (row_units < 1 || tile < 1 || n_tiles != (row_units + tile - 1) / tile ||
      groups_full < 1 || groups_last < 1 || groups_last > groups_full ||
      items != ((n_chunks - 1) * groups_full + groups_last) * n_tiles ||
      grid < 1 || grid > items || threads < 64 || threads > 1024 ||
      threads % 32 != 0 ||
      (bulk && (depth < 2 || depth > 8 || tile % 16 != 0 ||
                row_units % 16 != 0 ||
                stage_bytes < tile || stage_bytes % 128 != 0)) ||
      (!bulk && (depth != 0 || stage_bytes != 0)) ||
      queue == nullptr || layout(g).total > smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  int* q = static_cast<int*>(queue);
  const cudaError_t err =
      packed ? launch_path<true>(unit, table, tags, meta, out, q, g, grid,
                                 threads, smem_bytes, st)
             : launch_path<false>(unit, table, tags, meta, out, q, g, grid,
                                  threads, smem_bytes, st);
  return static_cast<int>(err);
}
