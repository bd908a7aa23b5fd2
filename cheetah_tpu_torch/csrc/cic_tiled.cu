// x-tiled multi-order cloud-in-cell (CIC) deposit and gather for Hopper, for
// grids past the untiled bound (128^3 and up).
//
// Built by cheetah_tpu_torch/ops/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes; the
// wrappers are in cheetah_tpu_torch/ops/cic_tiled.py.
//
// The kernels keep the contract of the untiled kernels (cic.cu) and of the
// TPU kernels they replace:
//
//   deposit: cheetah_tpu/ops/pallas_cic_tiled.py  _deposit_tiled_x32 (:248,
//            kernel body _deposit_tiled_kernel :209, halo fold :315-346).
//            normalized (B, N, 3), rows (B, O, C, N) -> out (B, C, nx, ny, nt)
//   gather:  cheetah_tpu/ops/pallas_cic_tiled.py  _gather_tiled_x32 (:393,
//            kernel body _gather_tiled_kernel :354, unsort :483-494).
//            grids (B, C, nx, ny, nt), normalized (B, N, 3) -> out (O, B, C, N)
//   plan:    the payload-along sort of the JAX package, _sort_by_tile
//            (pallas_cic_tiled.py:108), which XLA runs outside the pallas_call.
//
// The plan: each particle's x-tile, the tile of R grid rows its lower
// corner floor(x) falls in (clipped to [0, T - 1], NaN to tile 0); a stable
// sort of the particles by tile (`perm`, the sorted order's original
// indices, with the tiles and the positions in sorted order as payload, and
// `rank`, each particle's place, the inverse of `perm`); and the per-tile
// offsets into the sorted order (`offsets`, (B, T + 1)). A particle of tile
// t touches grid rows t*R .. t*R + R only, an (R + 1)-row window whose last
// row is the first row of tile t + 1 (the halo).
//
// Design. The TPU kernels walk (chunk, tile) visits in order and accumulate
// each tile's window in a revisited VMEM output block, folding the halos
// afterwards; XLA sorts for them. Hopper blocks run in parallel and in no
// order, and the sort is ours:
//
// - plan: a stable counting sort, since the key has only T values (128 at
//   128^3), with no sort of torch's. (1) Each block counts the tiles of its
//   chunk (4096 particles at most, 128 a warp), one counter row per warp in
//   shared memory. (2) Only for a large count matrix (over
//   kPlanCountsInBlock counts), one block per instance scans the counts in
//   (tile, chunk) order. (3) Each block counts its chunk again, finds each
//   tile's start in the sorted order (from the scan, or by reading the
//   count matrix itself), sorts the chunk stably in shared memory (within a
//   warp's step of 32 particles, the lanes that share a tile, found with one
//   ballot per key bit, take consecutive places in original order) and
//   writes it out, so that a tile's run of the chunk lands in contiguous
//   places. Being stable, it gives `perm` exactly as a stable sort does.
//   The key is computed in floating point exactly as tile_plan computes it
//   (ops/cic_tiled.py). Past 3040 tiles the counters do not fit 48 KB of
//   shared memory: each block is then one warp that counts and places
//   straight in its column of the global counts.
// - deposit: each block takes a chunk of the sorted order, the chunks'
//   bounds weighted so that each holds about the same work (one wave of
//   blocks, one a SM; warp 0 finds the block's chunk from the offsets). It
//   reads positions from the plan's sorted payload, contiguously, and rows
//   through `perm`. It walks its chunk tile by tile: a tile's segment of
//   at least min_window_run particles goes into the tile's window, (R + 1)
//   rows privatised in shared memory (128 KB in float32 at 128^3: R = 1,
//   two rows), as int32 fixed point for the value order set in float32
//   (Hopper has no shared-memory float add) and int64 otherwise
//   (cic_common.cuh FixedWindow), and the window is added to int64 grids in
//   global memory by bulk reductions of the copy engine
//   (cp.reduce.async.bulk .add.u64; an int32 window widened through a
//   two-buffer stage), where the halo row lands in the next tile's first
//   row, which folds it; a shorter segment (a sparse edge tile, whose
//   window would cost more to zero and flush than its atomics) adds its
//   corners to the int64 grids directly, as does every segment where a
//   window does not fit (float64 at 128^3 is 256 KB). The int64 grids hold
//   one power-of-two scale per (instance, component), from the largest
//   |row| (row_max_kernel) before the deposit; fixed_to_output_kernel
//   writes the output from them after it. Every add is an integer add, so
//   the deposit gives the same bits on every run, as the TPU's does. Each
//   component of the backward deposit (C = 3) is a block of its own.
// - gather: runs of one tile too, whose positions it reads from the plan's
//   sorted payload, contiguously. Where a tile's window fits shared memory
//   (gather_tiled_staged_kernel: the value and raised order sets), each
//   component's window is staged there with one bulk copy and the corners
//   are read from it; elsewhere (gather_tiled_kernel) they are read through
//   L1 and L2, with the untiled gather's specialised body (cic_common.cuh).
//   Both write the outputs in sorted order, coalesced; unsort_kernel then
//   moves them to the original indices through `rank`, with random reads
//   and coalesced writes. Writing each output straight to its original
//   index cost more than the gather (a partial 32-byte sector per value).
//
// No tensor cores, on purpose: 8 * O * C multiply-adds per particle, where
// a two-hot product like the TPU's would multiply thousands of zeros for
// every 8 non-zeros.
//
// Bound on the card: bytes. The deposit must read positions and rows and
// write the grid once; the gather must read the grids and positions and
// write the outputs once; the plan must read positions and write the
// permutation, the tiles, the sorted positions and the ranks once. None
// is near that bound. The plan's two passes over each chunk and the
// latency of its per-block steps bound the plan; the scattered reads of
// the unsort and the windows' copies bound the gather. Shared-memory
// atomics (about 8M a deposit at C = 1, a lane or two a clock per SM), the
// scattered reads of rows through `perm`, each window's zeroing and flush,
// and the int64 grids' zeroing, row sums and conversion limit the deposit.
// The fixed point that makes it repeat costs: given its plan, at the 128^3
// path shape on an H100 80GB HBM3 at 700 W, 0.0749 ms at C = 1 (the
// float-atomic version before it 0.0429 in the same call) and 0.1897 ms at
// C = 3 (0.1158), with the plan 0.1276 and 0.2451 ms (0.1042 and 0.1735);
// of some 0.074 ms, the kernel took 0.052, the zeroing of the 16.5 MB
// scratch 0.005, the row maxima 0.004 and the conversion 0.011
// (compare_deposits.py, torch.profiler; PERF.md section 6). The plan and
// the gather are exact and deterministic.

#include "cic_common.cuh"

namespace {

using cic::allow_staging;
using cic::Axis;
using cic::BulkStage;
using cic::device_limits;
using cic::DeviceLimits;
using cic::fixed_add;
using cic::fixed_point_deposit;
using cic::FixedScratch;
using cic::FixedWindow;
using cic::dispatch_gather;
using cic::fits_int32;
using cic::gather_particle;
using cic::gather_staged_particle;
using cic::kCachedDevices;
using cic::make_axis;
using cic::make_orders;
using cic::order_kind;
using cic::OrderKind;
using cic::OrderSet;
using cic::stageable;
using cic::valid_orders;

constexpr int kGatherThreads = 256;

struct Run {
  int tile;       // -1: this block has no run
  int64_t start;  // first and one-past-last index into the sorted order
  int64_t end;
};

// Warp 0 of the block: run number `run` among the runs of all tiles, tile by
// tile, where tile t has ceil(count_t / per_run) runs. `offsets` holds the
// T + 1 tile offsets of the block's instance.
__device__ void find_run(const int64_t* __restrict__ offsets, int num_tiles, int64_t run,
                         int64_t per_run, Run* out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int64_t before = 0;
  for (int t0 = 0; t0 < num_tiles; t0 += 32) {
    const int t = t0 + lane;
    const int64_t count = t < num_tiles ? offsets[t + 1] - offsets[t] : 0;
    const int64_t runs = (count + per_run - 1) / per_run;
    int64_t inclusive = runs;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t v = __shfl_up_sync(full, inclusive, d);
      if (lane >= d) inclusive += v;
    }
    const int64_t total = __shfl_sync(full, inclusive, 31);
    if (run < before + total) {  // the same on every lane
      const unsigned holds = __ballot_sync(full, run < before + inclusive);
      if (lane == __ffs(holds) - 1) {
        const int64_t start = offsets[t] + (run - (before + inclusive - runs)) * per_run;
        const int64_t end = start + per_run;
        out->tile = t;
        out->start = start;
        out->end = end < offsets[t + 1] ? end : offsets[t + 1];
      }
      return;
    }
    before += total;
  }
}

// Every thread: the block's run, or tile -1.
__device__ __forceinline__ void block_run(const int64_t* __restrict__ offsets, int num_tiles,
                                          int64_t per_run, Run* run) {
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) run->tile = -1;
    __syncwarp();
    find_run(offsets + blockIdx.y * static_cast<int64_t>(num_tiles + 1), num_tiles,
             blockIdx.x, per_run, run);
  }
  __syncthreads();
}

// The int64 cells of an int32 window's stage, two buffers of kStageCells
// (32 KB each) after the window (flush_window).
constexpr int kStageCells = 4096;
constexpr int64_t kStageBytes = 2 * kStageCells * 8;

template <typename Acc>
constexpr int64_t stage_bytes() {
  return sizeof(Acc) == 4 ? kStageBytes : 0;
}

// Thread 0: adds `bytes` of int64 cells at `from` (shared memory) to `to`
// (global memory) by Hopper's bulk reduction, in a bulk group of its own.
__device__ __forceinline__ void bulk_add_u64(long long* to, const long long* from,
                                             uint32_t bytes) {
  const uint32_t source = static_cast<uint32_t>(__cvta_generic_to_shared(from));
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u64 [%0], [%1], %2;\n" ::"l"(to),
      "r"(source), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The first `n` of a not-exact window's T values `values`, each nonzero one
// added to int64 cell `to` + v of a grid at `scale` by fixed_add. Rare (a
// window with non-finite rows), so kept out of line, its arguments by
// value: the address of a kernel's local taken for a call would move it to
// local memory for the whole kernel.
template <typename T>
__device__ __noinline__ void flush_in_order(const T* values, long long* acc, uint32_t* poison,
                                            int64_t to, int n, double scale) {
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    if (values[v] != T(0)) fixed_add(acc, poison, to + v, static_cast<double>(values[v]), scale);
  }
}

// Adds the window, `pass` components of `window_cells` cells ((lx, y, t),
// t fastest) for tile rows x0 .., to the int64 grids of `fixed`, the
// first component's being grid `grid0` (b * C + c0), the rows past the
// grid (the last tile's halo) left out. An exact window's cells are
// converted from its scale to their grid's, rn(v * unscale_w * scale_g),
// and where a plane holds an even number of cells (so that every int64 row
// is 16-byte aligned) added by Hopper's bulk reduction
// (cp.reduce.async.bulk .add.u64: the copy engine adds a run of cells in
// L2, with no atomic instruction issued per cell), from an int64 window
// converted in place, or from `stage` (two buffers of kStageCells) into
// which an int32 window is converted piece by piece while the engine reads
// the previous piece; else one atomic add per nonzero cell. A window that
// is not exact adds each nonzero cell of its T values by fixed_add (a
// non-finite one as its grid's poison bits; flush_in_order). Every thread
// of the block calls it; it returns with the engine done reading shared
// memory and the block synchronised.
template <typename T, typename Acc>
__device__ __forceinline__ void flush_window(const FixedWindow<T, Acc>& window, long long* stage,
                                             const FixedScratch& fixed, int64_t grid0, int pass,
                                             int window_cells, int plane, int64_t cells, int x0,
                                             int nx) {
  const int rows = min(window_cells / plane, nx - x0);
  const int n = rows * plane;
  const bool bulk = window.exact && plane % 2 == 0;
  int piece = 0;  // int32 windows: pieces staged so far
  for (int g = 0; g < pass; ++g) {
    const double scale = fixed.scale(grid0 + g);
    const double ratio = static_cast<double>(window.unscale) * scale;
    Acc* local = window.local + static_cast<int64_t>(g) * window_cells;
    long long* to = fixed.acc + (grid0 + g) * cells + static_cast<int64_t>(x0) * plane;
    if (!window.exact) {
      flush_in_order(reinterpret_cast<const T*>(window.local) + g * window_cells, fixed.acc,
                     fixed.poison, to - fixed.acc, n, scale);
    } else if (!bulk) {
      for (int v = threadIdx.x; v < n; v += blockDim.x) {
        if (local[v] == 0) continue;
        atomicAdd(reinterpret_cast<unsigned long long*>(to) + v,
                  static_cast<unsigned long long>(
                      __double2ll_rn(static_cast<double>(local[v]) * ratio)));
      }
    } else if constexpr (sizeof(Acc) == 8) {
      for (int v = threadIdx.x; v < n; v += blockDim.x)
        local[v] = __double2ll_rn(static_cast<double>(local[v]) * ratio);
      // The block's writes (generic proxy) before the copy engine's reads.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (threadIdx.x == 0) bulk_add_u64(to, local, static_cast<uint32_t>(n) * 8u);
    } else {
      for (int start = 0; start < n; start += kStageCells, ++piece) {
        long long* buffer = stage + (piece & 1) * kStageCells;
        if (piece >= 2) {  // the engine has read this buffer's last piece
          if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          __syncthreads();
        }
        const int count = min(kStageCells, n - start);
        for (int v = threadIdx.x; v < count; v += blockDim.x)
          buffer[v] = __double2ll_rn(static_cast<double>(local[start + v]) * ratio);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (threadIdx.x == 0) bulk_add_u64(to + start, buffer, static_cast<uint32_t>(count) * 8u);
      }
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  __syncthreads();
}

// A particle of a tile whose segment is deposited straight to the global
// grid weighs 3 windowed ones in the chunks' split: its 8 corners are
// scattered global atomics, a windowed particle's 8 are shared-memory ones.
constexpr int64_t kDirectWeight = 3;

// Warp 0 of the block: chunk k of `chunks` of the instance whose tile
// offsets are `offsets` (T + 1 of them), as sorted indices out[0] ..
// out[1], and the tile of its first particle, out[2]. The chunks split the
// particles' total weight evenly: a particle weighs kDirectWeight in a tile
// of fewer than `min_window_run` (or every tile when not `windowed`), else
// 1, and a windowed tile weighs `min_window_run` more for its window's
// zeroing and flush, charged to the chunk that holds the tile's first
// particle. So a chunk of direct adds, or one that starts two windows,
// holds fewer particles.
__device__ void weighted_chunk(const int64_t* __restrict__ offsets, int num_tiles,
                               int64_t min_window_run, bool windowed, int64_t chunks, int64_t k,
                               int64_t* out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  // A tile's weight: its window's (at its first particle), then each
  // particle's.
  auto window_weight = [&](int64_t count) {
    return windowed && count >= min_window_run ? min_window_run : int64_t{0};
  };
  auto unit = [&](int64_t count) {
    return windowed && count >= min_window_run ? int64_t{1} : kDirectWeight;
  };
  int64_t total = 0;
  for (int t0 = 0; t0 < num_tiles; t0 += 32) {
    const int t = t0 + lane;
    const int64_t count = t < num_tiles ? offsets[t + 1] - offsets[t] : 0;
    int64_t weight = count * unit(count) + window_weight(count);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) weight += __shfl_xor_sync(full, weight, d);
    total += weight;
  }
  // floor(total * j / chunks) without overflow.
  auto split = [&](int64_t j) {
    return (total / chunks) * j + (total % chunks) * j / chunks;
  };
  const int64_t target[2] = {split(k), split(k + 1)};
  if (lane == 0) {
    out[0] = out[1] = offsets[num_tiles];
    out[2] = num_tiles;
  }
  __syncwarp();
  int64_t before = 0;
  for (int t0 = 0; t0 < num_tiles; t0 += 32) {
    const int t = t0 + lane;
    const int64_t count = t < num_tiles ? offsets[t + 1] - offsets[t] : 0;
    const int64_t each = unit(count);
    const int64_t head = window_weight(count);
    const int64_t weight = count * each + head;
    int64_t inclusive = weight;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t v = __shfl_up_sync(full, inclusive, d);
      if (lane >= d) inclusive += v;
    }
    const int64_t from = before + inclusive - weight;  // this tile's first weight
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // The first particle whose weight position reaches the target.
      if (count > 0 && from <= target[e] && target[e] < from + weight) {
        const int64_t past = target[e] - from - head;
        out[e] = offsets[t] + (past > 0 ? (past + each - 1) / each : 0);
        if (e == 0) out[2] = t;
      }
    }
    before += __shfl_sync(full, inclusive, 31);
  }
}

// Rows a thread keeps in registers for deposit_cached_rows.
constexpr int kCachedRows = 16;

// One component of the value order set, float, for a segment [first, last)
// of at most kCachedRows particles a thread: each thread reads its
// particles' rows through `order` once, all kCachedRows loads in flight,
// keeps them in registers for the window's fixed point (prepare_window's
// S, here a block sum of the cached rows) and for the adds, so that the
// scattered read is paid once. Returns whether the window is exact: if it
// is, with the adds done (not synchronised); if not, with the window zeroed
// and no add done.
template <typename Add>
__device__ __forceinline__ bool deposit_cached_rows(FixedWindow<float, int>& window,
                                                    const float* __restrict__ pos,
                                                    const float* __restrict__ rows,
                                                    const int64_t* __restrict__ order,
                                                    int64_t first, int64_t last, int nx, int ny,
                                                    int nt, int values, double* partial,
                                                    Add add) {
  float r[kCachedRows];
  double sum = 0.0;
  bool finite = true;
#pragma unroll
  for (int k = 0; k < kCachedRows; ++k) {
    const int64_t i = first + threadIdx.x + static_cast<int64_t>(k) * blockDim.x;
    r[k] = i < last ? rows[order[i]] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kCachedRows; ++k) {
    finite = finite && isfinite(r[k]);
    sum += fabs(static_cast<double>(r[k]));
  }
  // The block's sum, as prepare_window takes it, with the window zeroed.
  cic::zero_shared(window.local, static_cast<int64_t>(values) * 4);
  finite = cic::block_sum(sum, finite, partial);
  cic::set_window_scale(window, partial[32], finite);
  if (!window.exact) return false;
  // Positions four particles at a time, their loads in flight together.
#pragma unroll
  for (int k0 = 0; k0 < kCachedRows; k0 += 4) {
    float px[4], py[4], pt[4];
    bool live[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t i = first + threadIdx.x + static_cast<int64_t>(k0 + u) * blockDim.x;
      live[u] = i < last;
      const float* p = pos + (live[u] ? i : first) * 3;
      px[u] = p[0];
      py[u] = p[1];
      pt[u] = p[2];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const Axis<float> ax = make_axis(px[u], nx);
      const Axis<float> ay = make_axis(py[u], ny);
      const Axis<float> at = make_axis(pt[u], nt);
      if (!(live[u] && ax.any() && ay.any() && at.any())) continue;
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        const int cx = corner >> 2, cy = (corner >> 1) & 1, ct = corner & 1;
        if (!(ax.valid(cx) && ay.valid(cy) && at.valid(ct))) continue;
        add(0, ax.i0 + cx, ay.i0 + cy, at.i0 + ct,
            r[k0 + u] * (ax.weight(0, cx) * ay.weight(0, cy) * at.weight(0, ct)));
      }
    }
  }
  return true;
}

// The x-tiled deposit. Grid (chunks, groups * batch): blockIdx.y picks the
// instance and the group of `group` components, blockIdx.x the chunk of the
// instance's sorted particles (weighted_chunk), so that one wave of blocks
// of equal work fills the card. The particles' positions come from the
// plan's sorted payload, contiguously; their rows through `perm`.
//
// A block walks its chunk tile by tile. A segment of one tile of at least
// `min_window_run` particles is deposited into the tile's window (R + 1
// rows of ny * nt cells per component), privatised in shared memory (fixed
// point, cic_common.cuh FixedWindow: int32 for the value order set in
// float32, else int64), and the window's cells are added to the int64
// grids of `fixed` (flush_window): the halo row lands in the next tile's
// first row there, which folds it. A shorter segment, or every segment
// where a window does not fit (`windowed` 0), adds its corners to the int64
// grids directly (fixed_add): its window would cost more to zero and flush
// than its particles' atomics.
template <typename T, int Kind>
__global__ void __launch_bounds__(cic::kDepositThreads, 1)
deposit_tiled_kernel(const T* __restrict__ sorted_pos, const T* __restrict__ rows,
                     const int64_t* __restrict__ perm, const int64_t* __restrict__ offsets,
                     FixedScratch fixed, int64_t num_particles, int num_components, int nx,
                     int ny, int nt, int rows_per_tile, int num_tiles, int group, int windowed,
                     int64_t min_window_run, OrderSet orders) {
  using Acc = cic::Accumulator<T, Kind>;
  extern __shared__ __align__(16) unsigned char window_storage[];
  __shared__ double partial[33];
  __shared__ int64_t chunk[3];
  const int groups = (num_components + group - 1) / group;
  const int64_t b = blockIdx.y / groups;
  const int c0 = static_cast<int>(blockIdx.y - b * groups) * group;
  const int pass = min(group, num_components - c0);
  const int64_t* tile_start = offsets + b * (num_tiles + 1);
  if (threadIdx.x < 32)
    weighted_chunk(tile_start, num_tiles, min_window_run, windowed, gridDim.x, blockIdx.x, chunk);
  __syncthreads();
  const int64_t start = chunk[0];
  const int64_t end = chunk[1];

  const int plane = ny * nt;
  const int window_cells = (rows_per_tile + 1) * plane;
  const int64_t cells = static_cast<int64_t>(nx) * plane;
  const int64_t* order = perm + b * num_particles;
  const T* pos = sorted_pos + b * num_particles * 3;
  // The rows of component c0, order 0, of the instance.
  const T* component_rows = rows + (b * orders.count * num_components + c0) * num_particles;
  const int64_t order_stride = static_cast<int64_t>(num_components) * num_particles;
  const int64_t grid0 = b * num_components + c0;
  FixedWindow<T, Acc> window{reinterpret_cast<Acc*>(window_storage)};
  long long* stage = reinterpret_cast<long long*>(
      window_storage + cic::window_bytes<Acc>(static_cast<int64_t>(group) * window_cells));
  auto through_perm = [order](int64_t i) { return order[i]; };

  for (int t = static_cast<int>(chunk[2]); t < num_tiles && tile_start[t] < end; ++t) {
    const int64_t first = max(start, tile_start[t]);
    const int64_t last = min(end, tile_start[t + 1]);
    if (last <= first) continue;
    const int x0 = t * rows_per_tile;  // global row of window row 0
    if (!windowed || last - first < min_window_run) {
      cic::deposit_particles<T, Kind>(
          pos, component_rows, first + threadIdx.x, last, blockDim.x, through_perm,
          num_particles, order_stride, pass, nx, ny, nt, orders,
          [&](int g, int ix, int iy, int it, T value) {
            fixed_add(fixed.acc, fixed.poison,
                      (grid0 + g) * cells + (static_cast<int64_t>(ix) * ny + iy) * nt + it,
                      static_cast<double>(value), fixed.scale(grid0 + g));
          });
      continue;
    }
    // Window row lx = ix - x0 is in [0, R] for a particle of this tile.
    auto window_add = [&](int g, int ix, int iy, int it, T value) {
      const int lx = ix - x0;
      if (lx >= 0 && lx <= rows_per_tile)
        window.add(g * window_cells + (lx * ny + iy) * nt + it, value);
    };
    auto window_add_in_order = [&](int g, int ix, int iy, int it, T value) {
      const int lx = ix - x0;
      if (lx >= 0 && lx <= rows_per_tile)
        window.add_in_order(g * window_cells + (lx * ny + iy) * nt + it, value);
    };
    bool done = false;
    if constexpr (Kind == cic::kValueOrders && std::is_same<T, float>::value) {
      if (pass == 1 && last - first <= kCachedRows * static_cast<int64_t>(blockDim.x)) {
        done = deposit_cached_rows(window, pos, component_rows, order, first, last, nx, ny, nt,
                                   pass * window_cells, partial, window_add);
        if (!done && threadIdx.x == 0)
          cic::deposit_particles<T, Kind>(pos, component_rows, first, last, 1, through_perm,
                                          num_particles, order_stride, pass, nx, ny, nt, orders,
                                          window_add_in_order);
        done = true;
      }
    }
    if (!done) {
      cic::prepare_window(window, pass * window_cells, component_rows, first + threadIdx.x,
                          last, blockDim.x, through_perm, num_particles, order_stride,
                          orders.count, pass, partial);
      if (window.exact)
        cic::deposit_particles<T, Kind>(pos, component_rows, first + threadIdx.x, last,
                                        blockDim.x, through_perm, num_particles, order_stride,
                                        pass, nx, ny, nt, orders, window_add);
      else if (threadIdx.x == 0)
        cic::deposit_particles<T, Kind>(pos, component_rows, first, last, 1, through_perm,
                                        num_particles, order_stride, pass, nx, ny, nt, orders,
                                        window_add_in_order);
    }
    __syncthreads();
    flush_window(window, stage, fixed, grid0, pass, window_cells, plane, cells, x0, nx);
  }
}

template <typename T, typename I, int Kind, int O, int C>
__global__ void __launch_bounds__(kGatherThreads)
gather_tiled_kernel(const T* __restrict__ grids, const T* __restrict__ sorted_pos,
                    const int64_t* __restrict__ offsets, T* __restrict__ sorted_out, I batch,
                    I num_particles, int num_components, int nx, int ny, int nt, int num_tiles,
                    int64_t per_run, OrderSet orders) {
  __shared__ Run run;
  block_run(offsets, num_tiles, per_run, &run);
  if (run.tile < 0) return;

  const I b = blockIdx.y;
  const int comps = C > 0 ? C : num_components;
  const I cells = static_cast<I>(nx) * ny * nt;
  const I plane = batch * comps * num_particles;
  const T* grid = grids + b * comps * cells;
  const T* pos = sorted_pos + b * num_particles * 3;
  for (I i = static_cast<I>(run.start) + threadIdx.x; i < static_cast<I>(run.end);
       i += blockDim.x) {
    const T* p = pos + i * 3;
    gather_particle<T, I, Kind, O, C>(grid, p[0], p[1], p[2], sorted_out, plane,
                                      b * comps * num_particles + i, num_particles, comps, nx,
                                      ny, nt, orders);
  }
}

// The Hopper variant of the gather, for windows that fit shared memory
// (one component's two rows at 128^3 is 128 KB in f32): per component,
// thread 0 stages the run's window, grid rows t*R .. t*R + R (contiguous in
// memory), with one bulk copy (cp.async.bulk, completion on an mbarrier),
// and the block gathers that component of its run from shared memory. A run
// takes up to kStagedPerRun particles, so that a crowded tile's window is
// copied a few times only.
constexpr int kStagedThreads = 1024;
constexpr int64_t kStagedPerRun = 8192;

template <typename T, int Kind, int O>
__global__ void __launch_bounds__(kStagedThreads, 1)
gather_tiled_staged_kernel(const T* __restrict__ grids, const T* __restrict__ sorted_pos,
                           const int64_t* __restrict__ offsets, T* __restrict__ sorted_out,
                           int64_t batch, int64_t num_particles, int num_components, int nx,
                           int ny, int nt, int rows_per_tile, int num_tiles, OrderSet orders) {
  extern __shared__ __align__(128) unsigned char staged_bytes[];
  __shared__ uint64_t barrier;
  __shared__ Run run;
  T* window = reinterpret_cast<T*>(staged_bytes);
  block_run(offsets, num_tiles, kStagedPerRun, &run);
  if (run.tile < 0) return;
  BulkStage stage{&barrier, 0};
  stage.init();
  const int64_t b = blockIdx.y;
  const int x0 = run.tile * rows_per_tile;
  const int rows = min(rows_per_tile + 1, nx - x0);  // the last tile's halo lies past the grid
  const int64_t plane = static_cast<int64_t>(ny) * nt;
  const int64_t cells = nx * plane;
  const int64_t order_stride = batch * num_components * num_particles;
  const T* p = sorted_pos + b * num_particles * 3;
  for (int c = 0; c < num_components; ++c) {
    __syncthreads();  // the previous component's reads of `window` are done
    stage.copy(window, grids + (b * num_components + c) * cells + x0 * plane,
               static_cast<uint32_t>(rows * plane * sizeof(T)));
    stage.wait();
    const int64_t row = (b * num_components + c) * num_particles;
    for (int64_t i = run.start + threadIdx.x; i < run.end; i += blockDim.x) {
      gather_staged_particle<T, Kind, O>(window, x0, p[i * 3], p[i * 3 + 1], p[i * 3 + 2],
                                         sorted_out, order_stride, row + i, nx, ny, nt, orders);
    }
  }
}

// Un-sorts the gather's outputs: out[o, b, c, n] = sorted_out[o, b, c,
// rank[b, n]], one thread per (instance, particle). The reads are random
// (L2-resident outputs), the writes coalesced: scattered partial writes to
// the original indices cost several times more than scattered reads.
template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
unsort_kernel(const T* __restrict__ sorted_out, const int64_t* __restrict__ rank,
              T* __restrict__ out, int64_t batch, int64_t num_particles, int num_components,
              int num_orders) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= batch * num_particles) return;
  const int64_t b = tid / num_particles;
  const int64_t n = tid - b * num_particles;
  const int64_t from = rank[tid];
  for (int o = 0; o < num_orders; ++o) {
    for (int c = 0; c < num_components; ++c) {
      const int64_t row = ((o * batch + b) * num_components + c) * num_particles;
      out[row + n] = sorted_out[row + from];
    }
  }
}

// ---------------------------------------------------------------------------
// The plan: a stable counting sort by tile.
// ---------------------------------------------------------------------------

constexpr int kPlanSlice = 128;         // particles of one warp's slice
constexpr int kPlanSharedInts = 12288;  // the 48 KB every block has
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 32;          // a round of 32768 counts, 132 KB of shared memory
constexpr int kScanRound = kScanThreads * kScanItems;
constexpr size_t kScanBytes = sizeof(int) * (kScanRound + kScanRound / 32);

// Shared ints the plan's scatter needs with W warps a block: W rows of T
// tile counters, the chunk's local and global start of each tile, each
// tile's start in the sorted order, and the chunk's local order.
__host__ __device__ inline int64_t plan_shared_ints(int warps, int num_tiles) {
  return static_cast<int64_t>(warps) * num_tiles + 3 * static_cast<int64_t>(num_tiles) +
         static_cast<int64_t>(warps) * kPlanSlice;
}

// Up to this many counts (T * K) each scatter block reads the whole count
// matrix of its instance and finds its starts itself, and the scan launch
// is skipped (31360 counts at 128^3 and 1M particles: 125 KB a block,
// read from L2).
constexpr int64_t kPlanCountsInBlock = 65536;

// floor(floor(x) / R) clipped to [0, T - 1], NaN to 0, in floating point as
// tile_plan computes it, so that no non-finite or huge value meets an int
// cast.
template <typename T>
__device__ __forceinline__ int tile_key(T x, int rows_per_tile, int num_tiles) {
  const T q = floor(floor(x) / static_cast<T>(rows_per_tile));
  if (!(q >= T(0))) return 0;
  if (q >= static_cast<T>(num_tiles - 1)) return num_tiles - 1;
  return static_cast<int>(q);
}

constexpr int kPlanSteps = kPlanSlice / 32;

// The tile keys of a warp's slice [start, end), lane l holding those of
// particles start + 32 s + l; -1 past the end. Loaded all at once, so that
// the warp's steps below do not wait on one load each.
template <typename T>
__device__ __forceinline__ void plan_keys(const T* __restrict__ pos, int64_t start, int64_t end,
                                          int rows_per_tile, int num_tiles,
                                          int (&keys)[kPlanSteps]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < kPlanSteps; ++s) {
    const int64_t i = start + 32 * s + lane;
    keys[s] = i < end ? tile_key(pos[i * 3], rows_per_tile, num_tiles) : -1;
  }
}

// One warp over its slice, 32 particles a step. The lanes of a step that
// share a tile find each other (same_key_lanes); the lowest of them
// reads the warp's counter of that tile (`counter[tile * stride]`) and adds
// the group's size, and each lane ranks itself by the group's lanes below
// it. `place(i, tile, slot)` gets each particle with its counter's value
// plus its rank: from zeroed counters that only counts; from counters set
// to the slice's first slot of each tile it places the particles in stable
// order.
//
// The lanes with the same key come from one ballot per bit of the key
// (`key_bits` of them, enough for the key T that marks lanes past the
// end): __match_any_sync takes time in the number of distinct keys among
// the lanes (some 20 for a Gaussian beam), 8 ballots do not.
__device__ __forceinline__ unsigned same_key_lanes(int key, int key_bits) {
  unsigned peers = 0xffffffffu;
  for (int b = 0; b < key_bits; ++b) {
    const bool bit = (key >> b) & 1;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

template <typename Place>
__device__ __forceinline__ void plan_warp_pass(const int (&keys)[kPlanSteps], int64_t start,
                                               int num_tiles, int key_bits, int* counter,
                                               int64_t stride, Place place) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kPlanSteps; ++s) {
    const bool active = keys[s] >= 0;
    if (!__any_sync(full, active)) break;  // past the slice's end
    const int key = active ? keys[s] : num_tiles;
    const unsigned peers = same_key_lanes(key, key_bits);
    const int leader = __ffs(peers) - 1;
    int first = 0;
    if (active && lane == leader) {
      first = counter[key * stride];
      counter[key * stride] = first + __popc(peers);
    }
    first = __shfl_sync(full, first, leader);
    if (active) place(start + 32 * s + lane, key, first + __popc(peers & below));
    __syncwarp();
  }
}

// The block's chunk of particles, W * kPlanSlice of them from chunk k, and
// its warp's slice.
struct PlanChunk {
  int64_t start, end;            // the chunk
  int64_t slice_start, slice_end;
};

__device__ __forceinline__ PlanChunk plan_chunk(int64_t num_particles) {
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  PlanChunk chunk;
  chunk.start = static_cast<int64_t>(blockIdx.x) * warps * kPlanSlice;
  chunk.end = min(chunk.start + static_cast<int64_t>(warps) * kPlanSlice, num_particles);
  chunk.slice_start = chunk.start + static_cast<int64_t>(warp) * kPlanSlice;
  chunk.slice_end = min(chunk.slice_start + kPlanSlice, num_particles);
  return chunk;
}

// Launch 1: counts[b, t, k], the particles of tile t in chunk k of instance
// b (grid (K, B), W warps a block).
template <typename T>
__global__ void __launch_bounds__(1024)
plan_count_kernel(const T* __restrict__ pos, int* __restrict__ counts, int64_t num_particles,
                  int rows_per_tile, int num_tiles, int key_bits, int64_t num_chunks,
                  bool shared) {
  extern __shared__ int plan_shared[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const T* p = pos + blockIdx.y * num_particles * 3;
  int* column = counts + blockIdx.y * num_tiles * num_chunks + blockIdx.x;  // column[t * K]
  const PlanChunk chunk = plan_chunk(num_particles);
  int keys[kPlanSteps];
  plan_keys(p, chunk.slice_start, chunk.slice_end, rows_per_tile, num_tiles, keys);
  auto count_only = [](int64_t, int, int) {};
  if (shared) {
    for (int i = threadIdx.x; i < warps * num_tiles; i += blockDim.x) plan_shared[i] = 0;
    __syncthreads();
    plan_warp_pass(keys, chunk.slice_start, num_tiles, key_bits, plan_shared + warp * num_tiles,
                   1, count_only);
    __syncthreads();
    for (int t = threadIdx.x; t < num_tiles; t += blockDim.x) {
      int total = 0;
      for (int w = 0; w < warps; ++w) total += plan_shared[w * num_tiles + t];
      column[t * num_chunks] = total;
    }
  } else {  // one warp a block, counting straight in its column
    for (int t = threadIdx.x; t < num_tiles; t += 32) column[t * num_chunks] = 0;
    __syncwarp();
    plan_warp_pass(keys, chunk.slice_start, num_tiles, key_bits, column, num_chunks, count_only);
  }
}

// Launch 2, for a count matrix past kPlanCountsInBlock only, one block per
// instance: the exclusive scan of counts[b] in (tile, chunk) order, in
// place, and offsets[b, t], the start of tile t. Rounds of kScanRound
// counts go through shared memory, loaded and stored coalesced; each thread scans
// kScanItems neighbours there (padded by one int in 32 against bank
// conflicts), then the block scans the threads' sums.
__global__ void __launch_bounds__(kScanThreads)
plan_scan_kernel(int* __restrict__ counts, int64_t* __restrict__ offsets,
                 int64_t num_particles, int num_tiles, int64_t num_chunks) {
  extern __shared__ int buffer[];  // kScanRound + kScanRound / 32
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int64_t total = num_tiles * num_chunks;
  int* c = counts + blockIdx.x * total;
  int64_t* off = offsets + blockIdx.x * static_cast<int64_t>(num_tiles + 1);
  auto padded = [](int j) { return j + j / 32; };
  if (threadIdx.x == 0) carry = 0;
  for (int64_t base = 0; base < total; base += kScanRound) {
    __syncthreads();  // the previous round's reads of buffer, warp_sums and carry are done
    // Eight of a thread's loads in flight at a time.
    for (int q0 = 0; q0 < kScanItems; q0 += 8) {
      int loaded[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = (q0 + q) * kScanThreads + threadIdx.x;
        loaded[q] = base + j < total ? c[base + j] : 0;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) buffer[padded((q0 + q) * kScanThreads + threadIdx.x)] = loaded[q];
    }
    __syncthreads();
    const int first = threadIdx.x * kScanItems;
    int sum = 0;
    for (int q = 0; q < kScanItems; ++q) sum += buffer[padded(first + q)];
    int inclusive = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inclusive, d);
      if (lane >= d) inclusive += v;
    }
    if (lane == 31) warp_sums[warp] = inclusive;
    __syncthreads();
    if (warp == 0) {
      int v = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
      }
      warp_sums[lane] = v;
    }
    __syncthreads();
    int running = carry + (warp ? warp_sums[warp - 1] : 0) + inclusive - sum;
    for (int q = 0; q < kScanItems; ++q) {
      const int count = buffer[padded(first + q)];
      buffer[padded(first + q)] = running;
      running += count;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < kScanRound && base + j < total; j += kScanThreads)
      c[base + j] = buffer[padded(j)];
    if (threadIdx.x == kScanThreads - 1) carry = running;
  }
  __syncthreads();  // the scanned counts of every thread are written
  for (int t = threadIdx.x; t < num_tiles; t += kScanThreads) off[t] = c[t * num_chunks];
  if (threadIdx.x == 0) off[num_tiles] = num_particles;
}

// The last launch (grid as launch 1): the chunk written to the sorted
// order, and each particle's place in it (`rank`, the inverse of `perm`,
// written in original order). Each tile's start comes from the scanned
// counts or, when `scanned` is false, from the block's own pass over the
// count matrix (block 0 then writes `offsets`). With shared counters the
// block first sorts its chunk in shared memory, so that the writes of a
// tile's run are contiguous; past them, each particle is written where it
// goes.
template <typename T>
__global__ void __launch_bounds__(1024)
plan_scatter_kernel(const T* __restrict__ pos, int* __restrict__ counts, int64_t* __restrict__ perm,
                    int64_t* __restrict__ rank, int* __restrict__ sorted_tile,
                    T* __restrict__ sorted_pos, int64_t* __restrict__ offsets,
                    int64_t num_particles, int rows_per_tile, int num_tiles, int key_bits,
                    int64_t num_chunks, bool shared, bool scanned) {
  extern __shared__ int plan_shared[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int64_t b = blockIdx.y;
  const T* p = pos + b * num_particles * 3;
  int* column = counts + b * num_tiles * num_chunks + blockIdx.x;
  int64_t* out_perm = perm + b * num_particles;
  int64_t* out_rank = rank + b * num_particles;
  int* out_tile = sorted_tile + b * num_particles;
  T* out_pos = sorted_pos + b * num_particles * 3;
  const PlanChunk chunk = plan_chunk(num_particles);
  int keys[kPlanSteps];
  plan_keys(p, chunk.slice_start, chunk.slice_end, rows_per_tile, num_tiles, keys);
  auto write = [&](int64_t at, int64_t i, int key) {
    out_perm[at] = i;
    out_tile[at] = key;
    out_pos[at * 3] = p[i * 3];
    out_pos[at * 3 + 1] = p[i * 3 + 1];
    out_pos[at * 3 + 2] = p[i * 3 + 2];
  };
  if (!shared) {  // one warp a block: its column holds its starts
    plan_warp_pass(keys, chunk.slice_start, num_tiles, key_bits, column, num_chunks,
                   [&](int64_t i, int key, int at) {
                     out_rank[i] = at;
                     write(at, i, key);
                   });
    return;
  }
  int* counters = plan_shared;                      // [W][T]
  int* local_start = counters + warps * num_tiles;  // [T]
  int* global_start = local_start + num_tiles;      // [T]
  int* tile_start = global_start + num_tiles;       // [T]
  int* local_order = tile_start + num_tiles;        // [W * kPlanSlice]
  if (!scanned) {
    // The chunk's start of each tile from the unscanned counts: per tile
    // (a warp a row, coalesced) the counts of the chunks before this one
    // and the tile's total; then the tiles' starts, scanned by warp 0.
    const int* row0 = counts + b * num_tiles * num_chunks;
    for (int t = warp; t < num_tiles; t += warps) {
      const int* row = row0 + t * num_chunks;
      int before = 0, total = 0;
#pragma unroll 4
      for (int64_t k = lane; k < num_chunks; k += 32) {
        const int count = row[k];
        total += count;
        before += k < blockIdx.x ? count : 0;
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        total += __shfl_xor_sync(0xffffffffu, total, d);
        before += __shfl_xor_sync(0xffffffffu, before, d);
      }
      if (lane == 0) {
        tile_start[t] = total;
        global_start[t] = before;
      }
    }
    __syncthreads();
    if (warp == 0) {
      int carry = 0;
      for (int t0 = 0; t0 < num_tiles; t0 += 32) {
        const int t = t0 + lane;
        const int total = t < num_tiles ? tile_start[t] : 0;
        int inclusive = total;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, inclusive, d);
          if (lane >= d) inclusive += v;
        }
        if (t < num_tiles) tile_start[t] = carry + inclusive - total;
        carry += __shfl_sync(0xffffffffu, inclusive, 31);
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < num_tiles; t += blockDim.x) {
      global_start[t] += tile_start[t];
      if (blockIdx.x == 0) offsets[b * (num_tiles + 1) + t] = tile_start[t];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0)
      offsets[b * (num_tiles + 1) + num_tiles] = num_particles;
  }
  for (int i = threadIdx.x; i < warps * num_tiles; i += blockDim.x) counters[i] = 0;
  __syncthreads();
  plan_warp_pass(keys, chunk.slice_start, num_tiles, key_bits, counters + warp * num_tiles, 1,
                 [](int64_t, int, int) {});
  __syncthreads();
  // Per tile, each warp's first slot relative to the tile's run in the
  // chunk (warps in order) and the run's length; then each run's start in
  // the chunk (warp 0 scans the lengths over the tiles) and in the sorted
  // order (from the scanned counts).
  for (int t = threadIdx.x; t < num_tiles; t += blockDim.x) {
    int running = 0;
    for (int w = 0; w < warps; ++w) {
      const int count = counters[w * num_tiles + t];
      counters[w * num_tiles + t] = running;
      running += count;
    }
    local_start[t] = running;
    if (scanned) global_start[t] = column[t * num_chunks];
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int t0 = 0; t0 < num_tiles; t0 += 32) {
      const int t = t0 + lane;
      const int length = t < num_tiles ? local_start[t] : 0;
      int inclusive = length;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inclusive, d);
        if (lane >= d) inclusive += v;
      }
      if (t < num_tiles) local_start[t] = carry + inclusive - length;
      carry += __shfl_sync(0xffffffffu, inclusive, 31);
    }
  }
  __syncthreads();
  plan_warp_pass(keys, chunk.slice_start, num_tiles, key_bits, counters + warp * num_tiles, 1,
                 [&](int64_t i, int key, int within) {
                   local_order[local_start[key] + within] = static_cast<int>(i - chunk.start);
                   out_rank[i] = global_start[key] + within;
                 });
  __syncthreads();
  // In local sorted order: neighbouring threads mostly write neighbouring
  // places of one tile's run. Each thread takes kPlanSteps places, with
  // their loads in flight together.
  const int length = static_cast<int>(chunk.end - chunk.start);
#pragma unroll
  for (int s = 0; s < kPlanSteps; ++s) {
    const int j = s * blockDim.x + threadIdx.x;
    if (j < length) {
      const int64_t i = chunk.start + local_order[j];
      const int key = tile_key(p[i * 3], rows_per_tile, num_tiles);
      write(global_start[key] + (j - local_start[key]), i, key);
    }
  }
}

// Blocks in x: an upper bound on the runs of one instance, since
// sum_t ceil(count_t / P) <= N / P + T.
unsigned int max_runs(int64_t num_particles, int num_tiles, int64_t per_run) {
  return static_cast<unsigned int>((num_particles + per_run - 1) / per_run + num_tiles);
}

template <typename T, int Kind>
cudaError_t deposit_tiled_launch(const T* sorted_pos, const T* rows, const int64_t* perm,
                                 const int64_t* offsets, const FixedScratch& fixed,
                                 int64_t batch, int64_t num_particles, int num_components, int nx,
                                 int ny, int nt, int rows_per_tile, int num_tiles,
                                 int64_t per_run, int group, int64_t min_window_run,
                                 const OrderSet& set, cudaStream_t stream) {
  using Acc = cic::Accumulator<T, Kind>;
  DeviceLimits limits;
  cudaError_t status = device_limits(&limits);
  if (status != cudaSuccess) return status;
  const int64_t shared = cic::window_bytes<Acc>(
      static_cast<int64_t>(group) * (rows_per_tile + 1) * ny * nt, stage_bytes<Acc>());
  const bool windowed = shared <= limits.staging;
  const int groups = (num_components + group - 1) / group;
  const int64_t chunks = (num_particles + per_run - 1) / per_run;
  if (groups * batch > 65535 || chunks > INT32_MAX) return cudaErrorInvalidValue;
  static bool configured[kCachedDevices] = {};
  auto kernel = deposit_tiled_kernel<T, Kind>;
  status = allow_staging(kernel, limits, configured);
  if (status != cudaSuccess) return status;
  const dim3 grid(static_cast<unsigned int>(chunks), static_cast<unsigned int>(groups * batch));
  kernel<<<grid, cic::kDepositThreads, windowed ? shared : 0, stream>>>(
      sorted_pos, rows, perm, offsets, fixed, num_particles, num_components, nx, ny, nt,
      rows_per_tile, num_tiles, group, windowed ? 1 : 0, min_window_run, set);
  return cudaGetLastError();
}

// The deposit's launches, sized by ops/cic_tiled.py tiled_deposit_geometry:
// `group` components a block, N / per_run chunks of the sorted particles,
// windows for tile segments of `min_window_run` particles or more where the
// window (and, for an int32 window, its stage) fits shared memory; else
// every corner is added to the int64 grids directly. The int64 grids are
// carved from `scratch` (`scratch_bytes` of it; cic_common.cuh
// FixedScratch), which this zeroes; `out` is written from them.
template <typename T>
int deposit_tiled(const void* sorted_pos, const void* rows, const void* perm,
                  const void* offsets, void* out, void* scratch, int64_t scratch_bytes,
                  int64_t batch, int64_t num_particles, int num_components, int nx, int ny,
                  int nt, int rows_per_tile, int num_tiles, int64_t per_run, int group,
                  int64_t min_window_run, const int* orders, int num_orders, void* stream) {
  if (!valid_orders(orders, num_orders) || rows_per_tile < 1 || num_tiles < 1 ||
      per_run < 1 || group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const OrderSet set = make_orders(orders, num_orders);
  const T* p = static_cast<const T*>(sorted_pos);
  const T* r = static_cast<const T*>(rows);
  const int64_t* pe = static_cast<const int64_t*>(perm);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool value = order_kind(orders, num_orders) == cic::kValueOrders;
  return static_cast<int>(fixed_point_deposit(
      r, scratch, scratch_bytes, static_cast<T*>(out), batch, num_particles, num_components,
      num_orders, static_cast<int64_t>(nx) * ny * nt, s, [&](const FixedScratch& fixed) {
        return value ? deposit_tiled_launch<T, cic::kValueOrders>(
                           p, r, pe, off, fixed, batch, num_particles, num_components, nx, ny,
                           nt, rows_per_tile, num_tiles, per_run, group, min_window_run, set, s)
                     : deposit_tiled_launch<T, cic::kGenericOrders>(
                           p, r, pe, off, fixed, batch, num_particles, num_components, nx, ny,
                           nt, rows_per_tile, num_tiles, per_run, group, min_window_run, set, s);
      }));
}

template <typename T>
int unsort(const T* sorted_out, const void* rank, void* out, int64_t batch,
           int64_t num_particles, int num_components, int num_orders, cudaStream_t stream) {
  const int64_t work = batch * num_particles;
  unsort_kernel<T><<<static_cast<unsigned int>((work + kGatherThreads - 1) / kGatherThreads),
                     kGatherThreads, 0, stream>>>(
      sorted_out, static_cast<const int64_t*>(rank), static_cast<T*>(out), batch, num_particles,
      num_components, num_orders);
  return static_cast<int>(cudaGetLastError());
}

// The gather in two launches: the kernel writes the outputs in sorted
// order into `sorted_out` (scratch shaped like `out`), then unsort_kernel
// moves them to the original indices through `rank`.
template <typename T, int Kind, int O>
cudaError_t gather_tiled_staged(const T* grids, const T* sorted_pos, const int64_t* offsets,
                                T* sorted_out, int64_t batch, int64_t num_particles,
                                int num_components, int nx, int ny, int nt, int rows_per_tile,
                                int num_tiles, const OrderSet& set, const DeviceLimits& limits,
                                int64_t bytes, cudaStream_t stream) {
  static bool configured[kCachedDevices] = {};
  auto kernel = gather_tiled_staged_kernel<T, Kind, O>;
  const cudaError_t status = allow_staging(kernel, limits, configured);
  if (status != cudaSuccess) return status;
  const dim3 grid(max_runs(num_particles, num_tiles, kStagedPerRun),
                  static_cast<unsigned int>(batch));
  kernel<<<grid, kStagedThreads, bytes, stream>>>(grids, sorted_pos, offsets, sorted_out, batch,
                                                  num_particles, num_components, nx, ny, nt,
                                                  rows_per_tile, num_tiles, set);
  return cudaGetLastError();
}

// The value and raised order sets run on gather_tiled_staged_kernel where
// a tile's window fits shared memory, every other call on
// gather_tiled_kernel. Both take the instances on the grid's y dimension.
template <typename T>
int gather_tiled(const void* grids, const void* sorted_pos, const void* rank,
                 const void* offsets, void* sorted_out, void* out, int64_t batch,
                 int64_t num_particles, int num_components, int nx, int ny, int nt,
                 int rows_per_tile, int num_tiles, int64_t per_run, const int* orders,
                 int num_orders, void* stream) {
  if (!valid_orders(orders, num_orders) || rows_per_tile < 1 || num_tiles < 1 || per_run < 1 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const OrderSet set = make_orders(orders, num_orders);
  const int64_t cells = static_cast<int64_t>(nx) * ny * nt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const OrderKind kind = order_kind(orders, num_orders);
  const int64_t row_bytes = static_cast<int64_t>(ny) * nt * sizeof(T);
  const int64_t window_bytes = (rows_per_tile + 1) * row_bytes;
  DeviceLimits limits{0, 0, 0};
  cudaError_t status = kind != cic::kGenericOrders ? device_limits(&limits) : cudaSuccess;
  if (status != cudaSuccess) return static_cast<int>(status);
  // Every window starts a whole number of rows into a 16-byte-aligned grid.
  if (limits.staging > 0 && row_bytes % 16 == 0 &&
      stageable(reinterpret_cast<uintptr_t>(grids), window_bytes, limits.staging)) {
    const T* g = static_cast<const T*>(grids);
    const T* p = static_cast<const T*>(sorted_pos);
    const int64_t* off = static_cast<const int64_t*>(offsets);
    T* o = static_cast<T*>(sorted_out);
    status = kind == cic::kValueOrders
                 ? gather_tiled_staged<T, cic::kValueOrders, 1>(
                       g, p, off, o, batch, num_particles, num_components, nx, ny, nt,
                       rows_per_tile, num_tiles, set, limits, window_bytes, s)
                 : gather_tiled_staged<T, cic::kRaisedOrders, 3>(
                       g, p, off, o, batch, num_particles, num_components, nx, ny, nt,
                       rows_per_tile, num_tiles, set, limits, window_bytes, s);
    if (status != cudaSuccess) return static_cast<int>(status);
    return unsort(static_cast<const T*>(sorted_out), rank, out, batch, num_particles,
                  num_components, num_orders, s);
  }
  const bool small = fits_int32(batch, num_particles, num_components, cells, num_orders);
  const dim3 grid(max_runs(num_particles, num_tiles, per_run), static_cast<unsigned int>(batch));
  status = dispatch_gather(
      orders, num_orders, num_components, small,
      [&](auto kind, auto count, auto components, auto index) {
        using I = decltype(index);
        gather_tiled_kernel<T, I, decltype(kind)::value, decltype(count)::value,
                            decltype(components)::value><<<grid, kGatherThreads, 0, s>>>(
            static_cast<const T*>(grids), static_cast<const T*>(sorted_pos),
            static_cast<const int64_t*>(offsets), static_cast<T*>(sorted_out),
            static_cast<I>(batch), static_cast<I>(num_particles), num_components, nx, ny, nt,
            num_tiles, per_run, set);
        return cudaGetLastError();
      });
  if (status != cudaSuccess) return static_cast<int>(status);
  return unsort(static_cast<const T*>(sorted_out), rank, out, batch, num_particles,
                num_components, num_orders, s);
}

// The plan in two launches, three past kPlanCountsInBlock counts (the
// scan). Blocks of W warps (up to 32, a chunk of 4096 particles) take as
// many warps as leave their counters, the tiles' starts and the chunk's
// local order in shared memory (plan_shared_ints); when not even one warp's
// fit (past 3040 tiles), blocks are one warp counting and placing in its
// column of `counts`. `counts` is scratch of `counts_size` ints, at least
// B * T * ceil(N / kPlanSlice) (enough for any W).
template <typename T>
int tile_plan(const void* pos, void* counts, int64_t counts_size, void* perm, void* rank,
              void* sorted_tile, void* sorted_pos, void* offsets, int64_t batch,
              int64_t num_particles, int rows_per_tile, int num_tiles, void* stream) {
  int warps = 32;
  while (warps > 1 && plan_shared_ints(warps, num_tiles) > kPlanSharedInts) --warps;
  const bool shared = plan_shared_ints(warps, num_tiles) <= kPlanSharedInts;
  const int64_t num_chunks = (num_particles + warps * kPlanSlice - 1) / (warps * kPlanSlice);
  if (batch < 1 || batch > 65535 || num_particles < 1 || num_particles > INT32_MAX ||
      rows_per_tile < 1 || num_tiles < 1 || num_chunks > INT32_MAX ||
      counts_size < batch * num_tiles * num_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(num_chunks), static_cast<unsigned int>(batch));
  const size_t count_bytes = shared ? sizeof(int) * warps * num_tiles : 0;
  const size_t scatter_bytes = shared ? sizeof(int) * plan_shared_ints(warps, num_tiles) : 0;
  int key_bits = 1;  // enough bits for the keys 0 .. T, T marking lanes past the end
  while ((num_tiles >> key_bits) != 0) ++key_bits;
  plan_count_kernel<T><<<grid, 32 * warps, count_bytes, s>>>(
      static_cast<const T*>(pos), static_cast<int*>(counts), num_particles, rows_per_tile,
      num_tiles, key_bits, num_chunks, shared);
  cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  const bool scanned = !shared || num_tiles * num_chunks > kPlanCountsInBlock;
  if (scanned) {
    status = cudaFuncSetAttribute(plan_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kScanBytes));
    if (status != cudaSuccess) return static_cast<int>(status);
    plan_scan_kernel<<<static_cast<unsigned int>(batch), kScanThreads, kScanBytes, s>>>(
        static_cast<int*>(counts), static_cast<int64_t*>(offsets), num_particles, num_tiles,
        num_chunks);
    status = cudaGetLastError();
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  plan_scatter_kernel<T><<<grid, 32 * warps, scatter_bytes, s>>>(
      static_cast<const T*>(pos), static_cast<int*>(counts), static_cast<int64_t*>(perm),
      static_cast<int64_t*>(rank), static_cast<int*>(sorted_tile), static_cast<T*>(sorted_pos),
      static_cast<int64_t*>(offsets), num_particles, rows_per_tile, num_tiles, key_bits,
      num_chunks, shared, scanned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface. Every function launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" {

int cic_device_limits(int device, int* out) { return cic::limits_of_device(device, out); }

int cic_deposit_tiled_f32(const void* sorted_pos, const void* rows, const void* perm,
                          const void* offsets, void* out, void* scratch, int64_t scratch_bytes,
                          int64_t batch, int64_t num_particles, int num_components, int nx,
                          int ny, int nt, int rows_per_tile, int num_tiles, int64_t per_run,
                          int group, int64_t min_window_run, const int* orders, int num_orders,
                          void* stream) {
  return deposit_tiled<float>(sorted_pos, rows, perm, offsets, out, scratch, scratch_bytes, batch,
                           num_particles, num_components, nx, ny, nt, rows_per_tile, num_tiles,
                           per_run, group, min_window_run, orders, num_orders, stream);
}

int cic_deposit_tiled_f64(const void* sorted_pos, const void* rows, const void* perm,
                          const void* offsets, void* out, void* scratch, int64_t scratch_bytes,
                          int64_t batch, int64_t num_particles, int num_components, int nx,
                          int ny, int nt, int rows_per_tile, int num_tiles, int64_t per_run,
                          int group, int64_t min_window_run, const int* orders, int num_orders,
                          void* stream) {
  return deposit_tiled<double>(sorted_pos, rows, perm, offsets, out, scratch, scratch_bytes, batch,
                           num_particles, num_components, nx, ny, nt, rows_per_tile, num_tiles,
                           per_run, group, min_window_run, orders, num_orders, stream);
}

int cic_gather_tiled_f32(const void* grids, const void* sorted_pos, const void* rank,
                         const void* offsets, void* sorted_out, void* out, int64_t batch,
                         int64_t num_particles, int num_components, int nx, int ny, int nt,
                         int rows_per_tile, int num_tiles, int64_t per_run, const int* orders,
                         int num_orders, void* stream) {
  return gather_tiled<float>(grids, sorted_pos, rank, offsets, sorted_out, out, batch,
                             num_particles, num_components, nx, ny, nt, rows_per_tile,
                             num_tiles, per_run, orders, num_orders, stream);
}

int cic_gather_tiled_f64(const void* grids, const void* sorted_pos, const void* rank,
                         const void* offsets, void* sorted_out, void* out, int64_t batch,
                         int64_t num_particles, int num_components, int nx, int ny, int nt,
                         int rows_per_tile, int num_tiles, int64_t per_run, const int* orders,
                         int num_orders, void* stream) {
  return gather_tiled<double>(grids, sorted_pos, rank, offsets, sorted_out, out, batch,
                              num_particles, num_components, nx, ny, nt, rows_per_tile,
                              num_tiles, per_run, orders, num_orders, stream);
}

int cic_tile_plan_f32(const void* pos, void* counts, int64_t counts_size, void* perm,
                      void* rank, void* sorted_tile, void* sorted_pos, void* offsets,
                      int64_t batch, int64_t num_particles, int rows_per_tile, int num_tiles,
                      void* stream) {
  return tile_plan<float>(pos, counts, counts_size, perm, rank, sorted_tile, sorted_pos,
                          offsets, batch, num_particles, rows_per_tile, num_tiles, stream);
}

int cic_tile_plan_f64(const void* pos, void* counts, int64_t counts_size, void* perm,
                      void* rank, void* sorted_tile, void* sorted_pos, void* offsets,
                      int64_t batch, int64_t num_particles, int rows_per_tile, int num_tiles,
                      void* stream) {
  return tile_plan<double>(pos, counts, counts_size, perm, rank, sorted_tile, sorted_pos,
                           offsets, batch, num_particles, rows_per_tile, num_tiles, stream);
}

}  // extern "C"
