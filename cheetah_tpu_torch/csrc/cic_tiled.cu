// x-tiled multi-order cloud-in-cell (CIC) deposit and gather for Hopper, for
// grids past the untiled bound (128^3 and up).
//
// Built by cheetah_tpu_torch/ops/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes; the
// wrappers are in cheetah_tpu_torch/ops/cic_tiled.py.
//
// Both kernels keep the contract of the untiled kernels (cic.cu) and of the
// TPU kernels they replace:
//
//   deposit: cheetah_tpu/ops/pallas_cic_tiled.py  _deposit_tiled_x32 (:248,
//            kernel body _deposit_tiled_kernel :209, halo fold :315-346).
//            normalized (B, N, 3), rows (B, O, C, N) -> out (B, C, nx, ny, nt)
//   gather:  cheetah_tpu/ops/pallas_cic_tiled.py  _gather_tiled_x32 (:393,
//            kernel body _gather_tiled_kernel :354, unsort :483-494).
//            grids (B, C, nx, ny, nt), normalized (B, N, 3) -> out (O, B, C, N)
//
// The plan is made by the wrapper in torch, as the JAX package makes it
// outside its pallas_call: each particle's x-tile, the tile of R grid rows
// its lower corner floor(x) falls in (clipped to [0, T - 1]); a sort of the
// particles by tile (`perm`, the sorted order's original indices); and the
// per-tile offsets into the sorted order (`offsets`, (B, T + 1)). A particle
// of tile t touches grid rows t*R .. t*R + R only, an (R + 1)-row window
// whose last row is the first row of tile t + 1 (the halo).
//
// Design. The TPU kernels walk (chunk, tile) visits in order and accumulate
// each tile's window in a revisited VMEM output block, folding the halos
// afterwards. Hopper blocks run in parallel and in no order. Here each block
// takes one run of at most `per_run` sorted particles of one tile (a crowded
// tile of a Gaussian beam is split into several runs; warp 0 finds the
// block's run from the offsets, so the plan needs no run table):
//
// - deposit: the block accumulates its window in shared memory with
//   shared-memory atomics, then adds the window's nonzero cells to the
//   zeroed global grid with atomicAdd. The halo row lands in the next
//   tile's first row there, which folds the halo in the same pass. The
//   window is sized from the shared-memory budget, not from the TPU's R:
//   at 128^3 one component's window (R = 1, two rows) is 128 KB in f32 and
//   fits; three components (the backward deposit of the force gradients)
//   run as three passes over the block's particles, and a window that does
//   not fit even for one component (f64 at 128^3, 256 KB) is cut into
//   y-slabs, one pass each. Corners outside the pass's slab are skipped.
// - gather: it only reads. The block reads the 8 corners of each particle
//   straight from the grid through L2 (three 128^3 f32 force grids are
//   25 MB of the 50 MB L2; a block's particles share one tile's two rows,
//   so the reads hit L1 and L2), and writes each output straight to the
//   particle's original index, which removes the TPU version's second sort.
//
// Bound on the card: bytes. The deposit must read positions and rows and
// write the grid once; the gather must read the grids and positions and
// write the outputs once. Both also read the permutation (8 B a particle),
// and their reads of positions and rows follow the sorted order, so they
// are scattered: one 32-byte sector per 12-byte position. Shared-memory
// atomics on the crowded centre cells and the flush of each block's window
// limit the deposit; the sort in the plan costs more than either kernel.
// Atomics change the order of the sums from run to run.

#include "cic_common.cuh"

namespace {

using cic::Axis;
using cic::corner_sum;
using cic::gather_particle;
using cic::kMaxOrders;
using cic::make_axis;
using cic::make_orders;
using cic::OrderSet;
using cic::valid_orders;

constexpr int kDepositThreads = 512;
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

template <typename T>
__global__ void __launch_bounds__(kDepositThreads)
deposit_tiled_kernel(const T* __restrict__ pos, const T* __restrict__ rows,
                     const int64_t* __restrict__ perm, const int64_t* __restrict__ offsets,
                     T* __restrict__ out, int64_t num_particles, int num_components, int nx,
                     int ny, int nt, int rows_per_tile, int num_tiles, int64_t per_run,
                     int components_per_pass, int ny_per_pass, OrderSet orders) {
  extern __shared__ unsigned char shared_bytes[];
  T* window = reinterpret_cast<T*>(shared_bytes);
  __shared__ Run run;
  block_run(offsets, num_tiles, per_run, &run);
  if (run.tile < 0) return;

  const int64_t b = blockIdx.y;
  const int x0 = run.tile * rows_per_tile;  // global row of window row 0
  const int window_rows = rows_per_tile + 1;
  const int num_orders = orders.count;
  const int64_t cells = static_cast<int64_t>(nx) * ny * nt;
  const int64_t* order = perm + b * num_particles;

  for (int c0 = 0; c0 < num_components; c0 += components_per_pass) {
    const int pass_components = min(components_per_pass, num_components - c0);
    for (int y0 = 0; y0 < ny; y0 += ny_per_pass) {
      const int pass_ny = min(ny_per_pass, ny - y0);
      const int component_cells = window_rows * pass_ny * nt;
      const int pass_cells = pass_components * component_cells;
      for (int i = threadIdx.x; i < pass_cells; i += blockDim.x) window[i] = T(0);
      __syncthreads();

      for (int64_t i = run.start + threadIdx.x; i < run.end; i += blockDim.x) {
        const int64_t n = order[i];
        const T* p = pos + (b * num_particles + n) * 3;
        const Axis<T> ax = make_axis(p[0], nx);
        const Axis<T> ay = make_axis(p[1], ny);
        const Axis<T> at = make_axis(p[2], nt);
        if (!(ax.any() && ay.any() && at.any())) continue;
        for (int cc = 0; cc < pass_components; ++cc) {
          const int c = c0 + cc;
          T r[kMaxOrders];
#pragma unroll
          for (int o = 0; o < kMaxOrders; ++o) {
            r[o] = o < num_orders
                       ? rows[((b * num_orders + o) * num_components + c) * num_particles + n]
                       : T(0);
          }
          T* component = window + cc * component_cells;
#pragma unroll
          for (int corner = 0; corner < 8; ++corner) {
            const int cx = corner >> 2, cy = (corner >> 1) & 1, ct = corner & 1;
            if (!(ax.valid(cx) && ay.valid(cy) && at.valid(ct))) continue;
            const int lx = ax.i0 + cx - x0;
            const int ly = ay.i0 + cy - y0;
            if (lx < 0 || lx >= window_rows || ly < 0 || ly >= pass_ny) continue;
            atomicAdd(component + (lx * pass_ny + ly) * nt + (at.i0 + ct),
                      corner_sum(r, orders, cx, cy, ct, ax, ay, at));
          }
        }
      }
      __syncthreads();

      // Flush: cells are (cc, lx, ly, t), t fastest, so that neighbouring
      // threads add to neighbouring global addresses.
      const int plane = pass_ny * nt;
      for (int i = threadIdx.x; i < pass_cells; i += blockDim.x) {
        const T value = window[i];
        if (value == T(0)) continue;
        const int cc = i / component_cells;
        const int rest = i - cc * component_cells;
        const int lx = rest / plane;
        const int gx = x0 + lx;
        if (gx >= nx) continue;  // the last tile's halo lies past the grid
        const int in_plane = rest - lx * plane;
        atomicAdd(out + (b * num_components + c0 + cc) * cells +
                      static_cast<int64_t>(gx) * ny * nt + static_cast<int64_t>(y0) * nt +
                      in_plane,
                  value);
      }
      __syncthreads();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
gather_tiled_kernel(const T* __restrict__ grids, const T* __restrict__ pos,
                    const int64_t* __restrict__ perm, const int64_t* __restrict__ offsets,
                    T* __restrict__ out, int64_t batch, int64_t num_particles,
                    int num_components, int nx, int ny, int nt, int num_tiles,
                    int64_t per_run, OrderSet orders) {
  __shared__ Run run;
  block_run(offsets, num_tiles, per_run, &run);
  if (run.tile < 0) return;

  const int64_t b = blockIdx.y;
  const int64_t cells = static_cast<int64_t>(nx) * ny * nt;
  const int64_t plane = batch * num_components * num_particles;
  const T* grid = grids + b * num_components * cells;
  const int64_t* order = perm + b * num_particles;
  for (int64_t i = run.start + threadIdx.x; i < run.end; i += blockDim.x) {
    const int64_t n = order[i];
    gather_particle(grid, pos + (b * num_particles + n) * 3, out, plane,
                    b * num_components * num_particles + n, num_particles, num_components,
                    nx, ny, nt, orders);
  }
}

// Blocks in x: an upper bound on the runs of one instance, since
// sum_t ceil(count_t / P) <= N / P + T.
unsigned int max_runs(int64_t num_particles, int num_tiles, int64_t per_run) {
  return static_cast<unsigned int>((num_particles + per_run - 1) / per_run + num_tiles);
}

template <typename T>
int deposit_tiled(const void* pos, const void* rows, const void* perm, const void* offsets,
                  void* out, int64_t batch, int64_t num_particles, int num_components,
                  int nx, int ny, int nt, int rows_per_tile, int num_tiles,
                  int64_t per_run, const int* orders, int num_orders, void* stream) {
  if (!valid_orders(orders, num_orders) || rows_per_tile < 1 || num_tiles < 1 ||
      per_run < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, optin = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (status != cudaSuccess) return static_cast<int>(status);
  // The window's budget: the block's opt-in shared memory, less the static
  // Run and a margin.
  const size_t budget = static_cast<size_t>(optin) - 1024;
  const size_t y_row = static_cast<size_t>(rows_per_tile + 1) * nt * sizeof(T);
  if (y_row > budget) return static_cast<int>(cudaErrorInvalidValue);
  // y-slabs of equal size when one component's window does not fit; else
  // as many components per pass as fit.
  const int fit = static_cast<int>(budget / y_row);
  const int slabs = (ny + fit - 1) / fit;
  const int ny_per_pass = (ny + slabs - 1) / slabs;
  int components_per_pass = 1;
  if (slabs == 1) {
    const int by_budget = static_cast<int>(budget / (y_row * ny));
    components_per_pass = by_budget < num_components ? by_budget : num_components;
  }
  const size_t shared = y_row * ny_per_pass * components_per_pass;
  auto kernel = deposit_tiled_kernel<T>;
  status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(shared));
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(max_runs(num_particles, num_tiles, per_run), static_cast<unsigned int>(batch));
  kernel<<<grid, kDepositThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos), static_cast<const T*>(rows),
      static_cast<const int64_t*>(perm), static_cast<const int64_t*>(offsets),
      static_cast<T*>(out), num_particles, num_components, nx, ny, nt, rows_per_tile,
      num_tiles, per_run, components_per_pass, ny_per_pass, make_orders(orders, num_orders));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gather_tiled(const void* grids, const void* pos, const void* perm, const void* offsets,
                 void* out, int64_t batch, int64_t num_particles, int num_components,
                 int nx, int ny, int nt, int num_tiles, int64_t per_run, const int* orders,
                 int num_orders, void* stream) {
  if (!valid_orders(orders, num_orders) || num_tiles < 1 || per_run < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(max_runs(num_particles, num_tiles, per_run), static_cast<unsigned int>(batch));
  gather_tiled_kernel<T><<<grid, kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(grids), static_cast<const T*>(pos),
      static_cast<const int64_t*>(perm), static_cast<const int64_t*>(offsets),
      static_cast<T*>(out), batch, num_particles, num_components, nx, ny, nt, num_tiles,
      per_run, make_orders(orders, num_orders));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface. Every function launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" {

int cic_deposit_tiled_f32(const void* pos, const void* rows, const void* perm,
                          const void* offsets, void* out, int64_t batch,
                          int64_t num_particles, int num_components, int nx, int ny, int nt,
                          int rows_per_tile, int num_tiles, int64_t per_run,
                          const int* orders, int num_orders, void* stream) {
  return deposit_tiled<float>(pos, rows, perm, offsets, out, batch, num_particles,
                              num_components, nx, ny, nt, rows_per_tile, num_tiles, per_run,
                              orders, num_orders, stream);
}

int cic_deposit_tiled_f64(const void* pos, const void* rows, const void* perm,
                          const void* offsets, void* out, int64_t batch,
                          int64_t num_particles, int num_components, int nx, int ny, int nt,
                          int rows_per_tile, int num_tiles, int64_t per_run,
                          const int* orders, int num_orders, void* stream) {
  return deposit_tiled<double>(pos, rows, perm, offsets, out, batch, num_particles,
                               num_components, nx, ny, nt, rows_per_tile, num_tiles, per_run,
                               orders, num_orders, stream);
}

int cic_gather_tiled_f32(const void* grids, const void* pos, const void* perm,
                         const void* offsets, void* out, int64_t batch, int64_t num_particles,
                         int num_components, int nx, int ny, int nt, int num_tiles,
                         int64_t per_run, const int* orders, int num_orders, void* stream) {
  return gather_tiled<float>(grids, pos, perm, offsets, out, batch, num_particles,
                             num_components, nx, ny, nt, num_tiles, per_run, orders,
                             num_orders, stream);
}

int cic_gather_tiled_f64(const void* grids, const void* pos, const void* perm,
                         const void* offsets, void* out, int64_t batch, int64_t num_particles,
                         int num_components, int nx, int ny, int nt, int num_tiles,
                         int64_t per_run, const int* orders, int num_orders, void* stream) {
  return gather_tiled<double>(grids, pos, perm, offsets, out, batch, num_particles,
                              num_components, nx, ny, nt, num_tiles, per_run, orders,
                              num_orders, stream);
}

}  // extern "C"
