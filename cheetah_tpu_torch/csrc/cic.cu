// Multi-order cloud-in-cell (CIC) deposit and trilinear gather for Hopper.
//
// Built by cheetah_tpu_torch/ops/nvcc.py (wrappers in ops/cic_kernels.py) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// The kernels keep the contract of the TPU kernels they replace:
//
//   deposit: cheetah_tpu/ops/pallas_cic.py  _deposit_multi_x32 (:316, kernel
//            body _deposit_multi_kernel :193 / _deposit_multi_acc :160).
//            normalized (B, N, 3), rows (B, O, C, N) -> out (B, C, nx, ny, nt),
//            out[b, c, i, j, k] += sum_o rows[b, o, c, n] * wx_o(i) wy_o(j) wt_o(k)
//   gather:  cheetah_tpu/ops/pallas_cic.py  _gather_multi_x32 (:238, kernel
//            body _gather_multi_kernel :147 / _gather_multi_values :122).
//            grids (B, C, nx, ny, nt), normalized (B, N, 3) -> out (O, B, C, N),
//            out[o, b, c, n] = sum_corners wx_o wy_o wt_o * grids[b, c, corner].
//            The exact adjoint of the deposit at the same orders.
//
// The corner weights and the range test are in cic_common.cuh.
//
// Design. The TPU kernels build dense two-hot tiles in VMEM and contract
// them on the MXU, with the deposit's grid accumulated in an output block
// that the sequential TPU grid revisits from program 0. Blocks on Hopper run
// in parallel and in no order, so nothing carries over between them.
//
// Deposit. Every deposit gives the same bits on every run, as the TPU's do
// (cheetah_tpu/ops/cloud_in_cell.py:14): its adds are integer adds, in
// fixed point (cic_common.cuh), whose sums do not depend on the order in
// which blocks and threads meet. Of the two designs weighed, integer
// accumulation was chosen over a fixed-order reduction of per-block parts
// (the TPU's revisited output block): the latter needs a stored part per
// block and cell (17 MB of copies at the 32^3 path shape, some 30-50 MB of
// windows for the tiled deposit at 128^3) and an ordered home for every
// corner added to the grid directly, where fixed point needs one int64
// grid (16 MB at 128^3) and no order at all. Where `group` grid components
// fit one block's shared memory (32^3 in int32 is 128 KB of the 227 KB),
// deposit_private_kernel gives every block a private copy of the grid there
// and a share of the instance's particles, one block per SM: the 8 corners
// of each particle go to shared-memory atomics, not to the global atomics
// on a Gaussian beam's crowded centre cells that held the first port (one
// thread a particle, 0.206 ms at 32^3 on an H100 80GB HBM3 at 700 W). A
// copy holds int32 fixed point for the value order set in float32 (Hopper
// has no shared-memory float add: a float atomicAdd there is a
// compare-and-swap loop, where a 32-bit integer add is native and ~3x
// faster) and int64 for every other order set and float64, each at a scale
// from the copy's sum of |rows| (cic_common.cuh FixedWindow). Each block
// then stores its copy, zeros included, to a (B, C, copies, cells) scratch,
// and deposit_reduce_kernel sums the copies in a fixed order; one copy
// writes the output directly. Grids whose window passes a block's budget
// (64^3 in int32 is 1 MB, 32^3 in int64 256 KB: float64 32^3, and the
// raised orders in float32) take deposit_multi_kernel: one thread a
// particle, each corner a 64-bit integer reduction into int64 grids in
// global memory at one power-of-two scale per (instance, component), fixed
// before from the largest |row| (row_max_kernel) and converted after
// (fixed_to_output_kernel; cic_common.cuh fixed_point_deposit). A cluster
// of 8 blocks sharing a 64^3 copy through distributed shared memory, and 8
// blocks each keeping a slab of it and reading all its particles, both
// took 2-3x as long as global atomics (PERF.md). On an H100 80GB HBM3 at
// 700 W the privatised deposit took 0.0365 ms at the path's 32^3 shape (1M
// particles, C = 1; 1.13x the float-atomic version before it, in the same
// call) and 0.0891 ms at C = 3 (1.08x); the global route 0.1062 ms at
// 64^3 (1.05x) and 0.1412 ms for float64 32^3 (1.07x) (compare_deposits.py;
// PERF.md section 6).
//
// Gather. It reads 8 corners per component: where a component of the grid
// fits shared memory (32^3 in f32 is 128 KB of the 227 KB; the value and
// raised order sets), gather_staged_kernel stages it there with one bulk
// copy per component (Hopper's cp.async.bulk, completion on an mbarrier)
// and each block reads its particles' corners from it; elsewhere (64^3 is 1
// MB, f64 32^3 is 256 KB, other order sets) gather_multi_kernel reads them
// through L1 from the grid resident in the 50 MB L2. On an H100 80GB HBM3
// at 700 W the staged kernel took 0.024 ms at the path's 32^3 shape (1M
// particles, C = 3) against 0.037 ms for the L1/L2 kernel (chip_smoke.py's
// gather_order_sets; PERF.md).
//
// No tensor cores, on purpose: the gather does 8 * O * C multiply-adds per
// particle (24M for 1M particles, one order, C = 3), and a two-hot product
// like the TPU's would multiply thousands of zeros for every 8 non-zeros of
// an (nx * ny)-wide row. The kernels work on loads, latency and atomics.
//
// Bound on the card: bytes, not operations. Per particle the deposit does
// 8 * C * (O + 1) multiply-adds and the gather 8 * C * O, far below the
// 67 TFLOP/s f32 rate for the bytes they move: positions (12 B), rows
// (4 * O * C B) and the outputs (the grid once, or 4 * O * C B per
// particle), at 3.35 TB/s. What limits them is not DRAM: shared-memory
// atomics, about 8M a deposit at C = 1 at a lane or two a clock per SM
// (deposit), and the latency of 8 * C scattered L1/L2 reads per particle
// (gather). The gather is therefore specialised (cic_common.cuh): the
// order set, the component count and int32 indices at compile time, the
// weights made once per particle, and all 8 * C loads in flight before the
// first multiply-add, which cuts its registers and lets C components' loads
// overlap; and staged where the grid fits shared memory, whose reads are
// cheaper than L1's misses.

#include "cic_common.cuh"

namespace {

using cic::allow_staging;
using cic::Axis;
using cic::BulkStage;
using cic::corner_sum;
using cic::device_limits;
using cic::DeviceLimits;
using cic::fixed_point_deposit;
using cic::dispatch_gather;
using cic::fits_int32;
using cic::gather_particle;
using cic::gather_staged_particle;
using cic::kCachedDevices;
using cic::kMaxOrders;
using cic::make_axis;
using cic::make_orders;
using cic::order_kind;
using cic::OrderKind;
using cic::OrderSet;
using cic::FixedScratch;
using cic::fixed_add;
using cic::FixedWindow;
using cic::stageable;
using cic::valid_orders;

constexpr int kThreads = 256;

// The global route: one thread a particle, each corner added to its
// instance's and component's int64 grid in global memory at the grid's
// scale (cic_common.cuh FixedScratch, fixed_add).
template <typename T>
__global__ void __launch_bounds__(kThreads)
deposit_multi_kernel(const T* __restrict__ pos, const T* __restrict__ rows, FixedScratch fixed,
                     int64_t batch, int64_t num_particles, int num_components, int nx, int ny,
                     int nt, OrderSet orders) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= batch * num_particles) return;
  const int64_t b = tid / num_particles;
  const int64_t n = tid - b * num_particles;

  const T* p = pos + tid * 3;
  const Axis<T> ax = make_axis(p[0], nx);
  const Axis<T> ay = make_axis(p[1], ny);
  const Axis<T> at = make_axis(p[2], nt);
  if (!(ax.any() && ay.any() && at.any())) return;

  const int64_t cells = static_cast<int64_t>(nx) * ny * nt;
  const int num_orders = orders.count;
  for (int c = 0; c < num_components; ++c) {
    // Fully unrolled over kMaxOrders so that r[] stays in registers.
    T r[kMaxOrders];
#pragma unroll
    for (int o = 0; o < kMaxOrders; ++o) {
      r[o] = o < num_orders
                 ? rows[((b * num_orders + o) * num_components + c) * num_particles + n]
                 : T(0);
    }
    const int64_t grid = b * num_components + c;
    const double scale = fixed.scale(grid);
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      const int cx = corner >> 2, cy = (corner >> 1) & 1, ct = corner & 1;
      if (!(ax.valid(cx) && ay.valid(cy) && at.valid(ct))) continue;
      const int64_t cell =
          (static_cast<int64_t>(ax.i0 + cx) * ny + (ay.i0 + cy)) * nt + (at.i0 + ct);
      fixed_add(fixed.acc, fixed.poison, grid * cells + cell,
                static_cast<double>(corner_sum(r, orders, cx, cy, ct, ax, ay, at)), scale);
    }
  }
}

// The privatised deposit, for grids whose `group` components fit one
// block's shared memory (32^3 in float32 is 128 KB of the 227 KB). Grid
// (copies, groups * batch): blockIdx.y picks the instance and the group of
// `group` components, blockIdx.x the copy p, which takes the instance's
// particles [N p / P, N (p + 1) / P). The block adds them into its copy of
// the grid in shared memory (fixed point, cic_common.cuh FixedWindow: int32
// for the value order set in float32, else int64), then stores every cell
// as T, zeros included, to dst[b, c, p, cell] of a (B, C, P, cells) array:
// the output itself when P = 1, else the scratch that deposit_reduce_kernel
// sums.
template <typename T, int Kind>
__global__ void __launch_bounds__(cic::kDepositThreads, 1)
deposit_private_kernel(const T* __restrict__ pos, const T* __restrict__ rows,
                       T* __restrict__ dst, int64_t num_particles, int num_components, int nx,
                       int ny, int nt, int group, int copies, OrderSet orders) {
  using Acc = cic::Accumulator<T, Kind>;
  extern __shared__ __align__(16) unsigned char window_storage[];
  __shared__ double partial[33];
  const int groups = (num_components + group - 1) / group;
  const int64_t b = blockIdx.y / groups;
  const int c0 = static_cast<int>(blockIdx.y - b * groups) * group;
  const int pass = min(group, num_components - c0);
  const int cells = nx * ny * nt;
  const int copy = blockIdx.x;
  FixedWindow<T, Acc> window{reinterpret_cast<Acc*>(window_storage)};
  // The rows of component c0, order 0, of the instance.
  const T* component_rows = rows + (b * orders.count * num_components + c0) * num_particles;
  const int64_t begin = num_particles * copy / copies;
  const int64_t end = num_particles * (copy + 1) / copies;
  const int64_t order_stride = static_cast<int64_t>(num_components) * num_particles;
  const T* instance_pos = pos + b * num_particles * 3;
  auto identity = [](int64_t i) { return i; };
  cic::prepare_window(window, pass * cells, component_rows, begin + threadIdx.x, end, blockDim.x,
                      identity, num_particles, order_stride, orders.count, pass, partial);
  if (window.exact) {
    cic::deposit_particles<T, Kind>(
        instance_pos, component_rows, begin + threadIdx.x, end, blockDim.x, identity,
        num_particles, order_stride, pass, nx, ny, nt, orders,
        [&](int g, int ix, int iy, int it, T value) {
          window.add(g * cells + (ix * ny + iy) * nt + it, value);
        });
  } else if (threadIdx.x == 0) {
    cic::deposit_particles<T, Kind>(
        instance_pos, component_rows, begin, end, 1, identity, num_particles, order_stride, pass,
        nx, ny, nt, orders, [&](int g, int ix, int iy, int it, T value) {
          window.add_in_order(g * cells + (ix * ny + iy) * nt + it, value);
        });
  }
  __syncthreads();

  for (int v = threadIdx.x; v < pass * cells; v += blockDim.x) {
    const int g = v / cells;
    dst[((b * num_components + c0 + g) * copies + copy) * cells + (v - g * cells)] =
        window.read(v);
  }
}

// out[i] = sum_p scratch[bc, p, cell] for i = bc * cells + cell: the
// copies' sum, in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
deposit_reduce_kernel(const T* __restrict__ scratch, T* __restrict__ out, int64_t outputs,
                      int cells, int copies) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= outputs) return;
  const int64_t bc = i / cells;
  const T* s = scratch + bc * copies * cells + (i - bc * cells);
  T acc[4] = {T(0), T(0), T(0), T(0)};
  int p = 0;
  for (; p + 4 <= copies; p += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += s[static_cast<int64_t>(p + q) * cells];
  }
  for (; p < copies; ++p) acc[0] += s[static_cast<int64_t>(p) * cells];
  out[i] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <typename T, typename I, int Kind, int O, int C>
__global__ void __launch_bounds__(kThreads)
gather_multi_kernel(const T* __restrict__ grids, const T* __restrict__ pos,
                    T* __restrict__ out, I batch, I num_particles, int num_components, int nx,
                    int ny, int nt, OrderSet orders) {
  const I tid = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= batch * num_particles) return;
  const I b = tid / num_particles;
  const I n = tid - b * num_particles;
  const int comps = C > 0 ? C : num_components;
  const I cells = static_cast<I>(nx) * ny * nt;
  const T* p = pos + tid * 3;
  gather_particle<T, I, Kind, O, C>(grids + b * comps * cells, p[0], p[1], p[2], out,
                                    batch * comps * num_particles,
                                    b * comps * num_particles + n, num_particles, comps, nx,
                                    ny, nt, orders);
}

// The Hopper variant for grids whose component fits shared memory (32^3
// in f32 is 128 KB of the 227 KB): one block of kStagedThreads per SM and
// instance, each taking a share of the instance's particles; per
// component, thread 0 stages the component's whole grid in shared memory
// with one bulk copy (cp.async.bulk, completion on an mbarrier) and the
// block gathers that component of its particles from shared memory.
constexpr int kStagedThreads = 1024;

template <typename T, int Kind, int O>
__global__ void __launch_bounds__(kStagedThreads, 1)
gather_staged_kernel(const T* __restrict__ grids, const T* __restrict__ pos,
                     T* __restrict__ out, int64_t batch, int64_t num_particles,
                     int num_components, int nx, int ny, int nt, OrderSet orders) {
  extern __shared__ __align__(128) unsigned char staged_bytes[];
  __shared__ uint64_t barrier;
  T* grid = reinterpret_cast<T*>(staged_bytes);
  BulkStage stage{&barrier, 0};
  stage.init();
  const int64_t b = blockIdx.y;
  const int64_t cells = static_cast<int64_t>(nx) * ny * nt;
  const int64_t start = num_particles * blockIdx.x / gridDim.x;
  const int64_t end = num_particles * (blockIdx.x + 1) / gridDim.x;
  const int64_t order_stride = batch * num_components * num_particles;
  const T* p = pos + b * num_particles * 3;
  for (int c = 0; c < num_components; ++c) {
    __syncthreads();  // the previous component's reads of `grid` are done
    stage.copy(grid, grids + (b * num_components + c) * cells,
               static_cast<uint32_t>(cells * sizeof(T)));
    stage.wait();
    const int64_t row = (b * num_components + c) * num_particles;
    for (int64_t n = start + threadIdx.x; n < end; n += blockDim.x) {
      gather_staged_particle<T, Kind, O>(grid, 0, p[n * 3], p[n * 3 + 1], p[n * 3 + 2], out,
                                         order_stride, row + n, nx, ny, nt, orders);
    }
  }
}

unsigned int num_blocks(int64_t work) {
  return static_cast<unsigned int>((work + kThreads - 1) / kThreads);
}

template <typename T, int Kind>
cudaError_t deposit_private(const T* pos, const T* rows, T* out, void* scratch,
                            int64_t scratch_bytes, int64_t batch, int64_t num_particles,
                            int num_components, int nx, int ny, int nt, int group, int copies,
                            const OrderSet& set, cudaStream_t stream) {
  DeviceLimits limits;
  cudaError_t status = device_limits(&limits);
  if (status != cudaSuccess) return status;
  const int64_t cells = static_cast<int64_t>(nx) * ny * nt;
  const int groups = (num_components + group - 1) / group;
  const int64_t shared = cic::window_bytes<cic::Accumulator<T, Kind>>(group * cells);
  const int64_t copies_bytes =
      static_cast<int64_t>(sizeof(T)) * batch * num_components * copies * cells;
  if (shared > limits.staging || groups * batch > 65535 ||
      (copies > 1 && (scratch == nullptr || scratch_bytes < copies_bytes)))
    return cudaErrorInvalidValue;
  static bool configured[kCachedDevices] = {};
  auto kernel = deposit_private_kernel<T, Kind>;
  status = allow_staging(kernel, limits, configured);
  if (status != cudaSuccess) return status;
  T* copied = copies > 1 ? static_cast<T*>(scratch) : out;
  const dim3 grid(static_cast<unsigned int>(copies), static_cast<unsigned int>(groups * batch));
  kernel<<<grid, cic::kDepositThreads, shared, stream>>>(pos, rows, copied, num_particles,
                                                         num_components, nx, ny, nt, group,
                                                         copies, set);
  status = cudaGetLastError();
  if (status != cudaSuccess || copies == 1) return status;
  const int64_t outputs = batch * num_components * cells;
  deposit_reduce_kernel<T><<<num_blocks(outputs), kThreads, 0, stream>>>(
      copied, out, outputs, static_cast<int>(cells), copies);
  return cudaGetLastError();
}

// group > 0: the privatised deposit of `group` components a block, with
// `copies` copies of the grid per instance and group (ops/cic_kernels.py
// untiled_deposit_geometry sizes them from the card), into `out` directly
// or through `scratch` (B * C * copies * cells values of T). group = 0:
// deposit_multi_kernel into int64 grids carved from `scratch`
// (cic_common.cuh FixedScratch, which this zeroes), then `out` from them.
// `scratch_bytes` is the scratch's size, checked against what the route
// needs.
template <typename T>
int deposit(const void* pos, const void* rows, void* out, void* scratch, int64_t scratch_bytes,
            int64_t batch, int64_t num_particles, int num_components, int nx, int ny, int nt,
            int group, int copies, const int* orders, int num_orders, void* stream) {
  if (!valid_orders(orders, num_orders) || group < 0 || copies < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const OrderSet set = make_orders(orders, num_orders);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* p = static_cast<const T*>(pos);
  const T* r = static_cast<const T*>(rows);
  T* o = static_cast<T*>(out);
  if (group > 0) {
    return static_cast<int>(
        order_kind(orders, num_orders) == cic::kValueOrders
            ? deposit_private<T, cic::kValueOrders>(p, r, o, scratch, scratch_bytes, batch,
                                                    num_particles, num_components, nx, ny, nt,
                                                    group, copies, set, s)
            : deposit_private<T, cic::kGenericOrders>(p, r, o, scratch, scratch_bytes, batch,
                                                      num_particles, num_components, nx, ny,
                                                      nt, group, copies, set, s));
  }
  const int64_t cells = static_cast<int64_t>(nx) * ny * nt;
  return static_cast<int>(fixed_point_deposit(
      r, scratch, scratch_bytes, o, batch, num_particles, num_components, num_orders, cells, s,
      [&](const FixedScratch& fixed) {
        deposit_multi_kernel<T><<<num_blocks(batch * num_particles), kThreads, 0, s>>>(
            p, r, fixed, batch, num_particles, num_components, nx, ny, nt, set);
        return cudaGetLastError();
      }));
}

template <typename T, int Kind, int O>
cudaError_t gather_staged(const T* grids, const T* pos, T* out, int64_t batch,
                          int64_t num_particles, int num_components, int nx, int ny, int nt,
                          const OrderSet& set, const DeviceLimits& limits, int64_t bytes,
                          cudaStream_t stream) {
  static bool configured[kCachedDevices] = {};
  auto kernel = gather_staged_kernel<T, Kind, O>;
  const cudaError_t status = allow_staging(kernel, limits, configured);
  if (status != cudaSuccess) return status;
  const dim3 grid(static_cast<unsigned int>(limits.sms), static_cast<unsigned int>(batch));
  kernel<<<grid, kStagedThreads, bytes, stream>>>(grids, pos, out, batch, num_particles,
                                                  num_components, nx, ny, nt, set);
  return cudaGetLastError();
}

// The value and raised order sets run on gather_staged_kernel where a
// component of the grid fits shared memory and the instances fit the
// grid's y dimension; every other call on gather_multi_kernel, whose 1-D
// grid takes any batch.
template <typename T>
int gather(const void* grids, const void* pos, void* out, int64_t batch,
           int64_t num_particles, int num_components, int nx, int ny, int nt,
           const int* orders, int num_orders, void* stream) {
  if (!valid_orders(orders, num_orders)) return static_cast<int>(cudaErrorInvalidValue);
  const OrderSet set = make_orders(orders, num_orders);
  const int64_t cells = static_cast<int64_t>(nx) * ny * nt;
  const OrderKind kind = order_kind(orders, num_orders);
  if (kind != cic::kGenericOrders && batch <= 65535) {
    DeviceLimits limits;
    const cudaError_t status = device_limits(&limits);
    if (status != cudaSuccess) return static_cast<int>(status);
    const int64_t bytes = cells * static_cast<int64_t>(sizeof(T));
    if (stageable(reinterpret_cast<uintptr_t>(grids), bytes, limits.staging)) {
      const cudaStream_t s = static_cast<cudaStream_t>(stream);
      const T* g = static_cast<const T*>(grids);
      const T* p = static_cast<const T*>(pos);
      T* o = static_cast<T*>(out);
      return static_cast<int>(
          kind == cic::kValueOrders
              ? gather_staged<T, cic::kValueOrders, 1>(g, p, o, batch, num_particles,
                                                       num_components, nx, ny, nt, set, limits,
                                                       bytes, s)
              : gather_staged<T, cic::kRaisedOrders, 3>(g, p, o, batch, num_particles,
                                                        num_components, nx, ny, nt, set, limits,
                                                        bytes, s));
    }
  }
  const bool small = fits_int32(batch, num_particles, num_components, cells, num_orders);
  return static_cast<int>(dispatch_gather(
      orders, num_orders, num_components, small,
      [&](auto kind, auto count, auto components, auto index) {
        using I = decltype(index);
        gather_multi_kernel<T, I, decltype(kind)::value, decltype(count)::value,
                            decltype(components)::value>
            <<<num_blocks(batch * num_particles), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
                static_cast<const T*>(grids), static_cast<const T*>(pos), static_cast<T*>(out),
                static_cast<I>(batch), static_cast<I>(num_particles), num_components, nx, ny,
                nt, set);
        return cudaGetLastError();
      }));
}

}  // namespace

// Plain C interface. Every function launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" {

int cic_device_limits(int device, int* out) { return cic::limits_of_device(device, out); }

int cic_deposit_multi_f32(const void* pos, const void* rows, void* out, void* scratch,
                          int64_t scratch_bytes, int64_t batch, int64_t num_particles,
                          int num_components, int nx, int ny, int nt, int group, int copies,
                          const int* orders, int num_orders, void* stream) {
  return deposit<float>(pos, rows, out, scratch, scratch_bytes, batch, num_particles,
                        num_components, nx, ny, nt, group, copies, orders, num_orders, stream);
}

int cic_deposit_multi_f64(const void* pos, const void* rows, void* out, void* scratch,
                          int64_t scratch_bytes, int64_t batch, int64_t num_particles,
                          int num_components, int nx, int ny, int nt, int group, int copies,
                          const int* orders, int num_orders, void* stream) {
  return deposit<double>(pos, rows, out, scratch, scratch_bytes, batch, num_particles,
                         num_components, nx, ny, nt, group, copies, orders, num_orders, stream);
}

int cic_gather_multi_f32(const void* grids, const void* pos, void* out, int64_t batch,
                         int64_t num_particles, int num_components, int nx, int ny,
                         int nt, const int* orders, int num_orders, void* stream) {
  return gather<float>(grids, pos, out, batch, num_particles, num_components, nx, ny, nt,
                       orders, num_orders, stream);
}

int cic_gather_multi_f64(const void* grids, const void* pos, void* out, int64_t batch,
                         int64_t num_particles, int num_components, int nx, int ny,
                         int nt, const int* orders, int num_orders, void* stream) {
  return gather<double>(grids, pos, out, batch, num_particles, num_components, nx, ny, nt,
                        orders, num_orders, stream);
}

}  // extern "C"
