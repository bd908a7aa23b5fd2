// Shared pieces of the multi-order CIC kernels (cic.cu, cic_tiled.cu).
//
// Both deposits privatise their grid or window in shared memory
// (FixedWindow, deposit_particles below): a block adds its particles'
// corner values there with shared-memory atomics and adds or stores each
// cell to global memory once. A grid or window larger than one block's
// budget takes global atomics instead (the wrappers' geometry decides).
// Every add is an integer add (fixed point, below), so that each deposit
// gives the same bits on every run.
//
// Per axis, with i0 = floor(p) and f = p - i0, order 0 weighs corner i0 with
// 1 - f and corner i0 + 1 with f; order 1 (the a.e. derivative) weighs them
// -1 and +1. A corner outside [0, n - 1] weighs 0. The range is tested in
// floating point BEFORE the conversion to int, so NaN, +-inf and huge
// positions (for which the conversion is undefined) give weight 0 at every
// corner; the JAX package parks such particles at -2 for the same reason.
//
// The gather body (gather_particle) is specialised at compile time on the
// order set, the component count and the index width, because a body that
// takes them at run time unrolls all 8 order slots with a test and three
// weight branches per slot and corner (over 100 registers a thread) and
// cannot keep the loads of several components in flight together. The
// paths ask for few order sets (space_charge_kick.py and the autograd
// closure of ops/cic_kernels.py):
//
//   the forward kick:                 VALUE  ((0,0,0))                 C = 3
//   GatherMulti.backward:             RAISED ((1,0,0),(0,1,0),(0,0,1)) C = 3
//   DepositMulti.backward (charges):  RAISED                           C = 1
//
// These run specialised instantiations with int32 indices; every other
// call (another order set or component count, or an index past int32) runs
// a generic one templated on the order count only (with the orders as data,
// a run-time component loop and int64 indices), which is right for all 8
// orders but not tuned. The JAX kernels take their orders as a static
// argument too.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cic {

constexpr int kMaxOrders = 8;

struct OrderSet {
  int count;
  int x[kMaxOrders];
  int y[kMaxOrders];
  int t[kMaxOrders];
};

// Which instantiation of the gather body serves an order set.
enum OrderKind : int {
  kGenericOrders = 0,  // any set, the orders read from the OrderSet
  kValueOrders = 1,    // ((0, 0, 0))
  kRaisedOrders = 2,   // ((1, 0, 0), (0, 1, 0), (0, 0, 1)): order o raises axis o
};

template <int V>
using Int = std::integral_constant<int, V>;

// The derivative order on `axis` of order slot `o`: a constant for the
// specialised kinds once `o` is unrolled.
template <int Kind>
__device__ __forceinline__ int order_of(const OrderSet& orders, int o, int axis) {
  if constexpr (Kind == kValueOrders) {
    return 0;
  } else if constexpr (Kind == kRaisedOrders) {
    return o == axis ? 1 : 0;
  } else {
    return axis == 0 ? orders.x[o] : (axis == 1 ? orders.y[o] : orders.t[o]);
  }
}

template <typename T>
struct Axis {
  int i0;     // floor(p), valid only when v0 or v1
  T f;        // p - floor(p); 0 when neither corner is on the grid
  bool v0;    // corner i0 lies on the grid
  bool v1;    // corner i0 + 1 lies on the grid

  __device__ __forceinline__ bool any() const { return v0 || v1; }
  __device__ __forceinline__ bool valid(int c) const { return c ? v1 : v0; }
  // Weight of corner `c` (0: i0, 1: i0 + 1) at derivative order `o`.
  __device__ __forceinline__ T weight(int o, int c) const {
    if (o == 0) return c ? f : T(1) - f;
    return c ? T(1) : T(-1);
  }
};

template <typename T>
__device__ __forceinline__ Axis<T> make_axis(T p, int n) {
  Axis<T> a;
  T fl = floor(p);
  // Comparisons with NaN are false; +-inf and huge values fail the range.
  a.v0 = (fl >= T(0)) && (fl <= T(n - 1));
  a.v1 = (fl >= T(-1)) && (fl <= T(n - 2));
  a.i0 = (a.v0 || a.v1) ? static_cast<int>(fl) : 0;
  // A finite weight for a particle off the grid on this axis (inf - inf is
  // NaN), so that its zero loads stay zero in the gather's products.
  a.f = (a.v0 || a.v1) ? p - fl : T(0);
  return a;
}

// sum_o r[o] * w_o(corner): the deposit's value at one corner, summed over
// the orders in registers.
template <typename T>
__device__ __forceinline__ T corner_sum(const T (&r)[kMaxOrders], const OrderSet& orders,
                                        int cx, int cy, int ct, const Axis<T>& ax,
                                        const Axis<T>& ay, const Axis<T>& at) {
  T acc = T(0);
#pragma unroll
  for (int o = 0; o < kMaxOrders; ++o) {
    if (o < orders.count)
      acc += r[o] * ax.weight(orders.x[o], cx) * ay.weight(orders.y[o], cy) *
             at.weight(orders.t[o], ct);
  }
  return acc;
}

// w[o][k]: the weight of corner k (cx = k >> 2, cy = (k >> 1) & 1, ct =
// k & 1) at order o.
template <typename T, int Kind, int O>
__device__ __forceinline__ void corner_weights(const Axis<T>& ax, const Axis<T>& ay,
                                               const Axis<T>& at, const OrderSet& orders,
                                               T (&w)[O][8]) {
#pragma unroll
  for (int o = 0; o < O; ++o) {
    const int ox = order_of<Kind>(orders, o, 0);
    const int oy = order_of<Kind>(orders, o, 1);
    const int ot = order_of<Kind>(orders, o, 2);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      w[o][k] = ax.weight(ox, k >> 2) * ay.weight(oy, (k >> 1) & 1) * at.weight(ot, k & 1);
    }
  }
}

// The gather of one particle at (px, py, pt): for each order o and component
// c, out[o * order_stride + out_index + c * component_stride] = sum over the
// 8 corners of w_o(corner) * grid[c, corner]. `grid` points at the
// particle's instance, (C, nx, ny, nt).
//
// The weights are made once per particle: per axis at most two orders at
// two corners, shared by every component and order. All 8 * C loads are
// issued (predicated on the corner lying on the grid, so nothing outside
// the grid is read and an off-grid corner adds an exact zero) before the
// first multiply-add. I is int32_t where every index of the call fits, else
// int64_t. C = 0 takes the component count at run time.
template <typename T, typename I, int Kind, int O, int C>
__device__ __forceinline__ void gather_particle(const T* __restrict__ grid, T px, T py, T pt,
                                                T* __restrict__ out, I order_stride,
                                                I out_index, I component_stride,
                                                int num_components, int nx, int ny, int nt,
                                                const OrderSet& orders) {
  const Axis<T> ax = make_axis(px, nx);
  const Axis<T> ay = make_axis(py, ny);
  const Axis<T> at = make_axis(pt, nt);
  const I plane = static_cast<I>(ny) * nt;
  const I cells = static_cast<I>(nx) * plane;
  const I base = static_cast<I>(ax.i0) * plane + static_cast<I>(ay.i0) * nt + at.i0;

  bool valid[8];
  I offset[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int cx = k >> 2, cy = (k >> 1) & 1, ct = k & 1;
    valid[k] = ax.valid(cx) && ay.valid(cy) && at.valid(ct);
    offset[k] = base + cx * plane + cy * nt + ct;
  }
  T w[O][8];
  corner_weights<T, Kind, O>(ax, ay, at, orders, w);

  if constexpr (C > 0) {
    T v[C][8];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[c][k] = valid[k] ? __ldg(grid + c * cells + offset[k]) : T(0);
    }
#pragma unroll
    for (int o = 0; o < O; ++o) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += w[o][k] * v[c][k];
        out[o * order_stride + out_index + c * component_stride] = acc;
      }
    }
  } else {
    for (int c = 0; c < num_components; ++c) {
      T v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = valid[k] ? __ldg(grid + c * cells + offset[k]) : T(0);
#pragma unroll
      for (int o = 0; o < O; ++o) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += w[o][k] * v[k];
        out[o * order_stride + out_index + c * component_stride] = acc;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Gathers from a grid staged in shared memory (Hopper's bulk copy).
// ---------------------------------------------------------------------------

// One component's gather of one particle from `window`, the rows x0 ..
// x0 + rows - 1 of the component staged in shared memory: out[o *
// order_stride + out_index] for each order. Every corner on the grid lies
// in the window (the caller stages the rows its particles can touch).
template <typename T, int Kind, int O>
__device__ __forceinline__ void gather_staged_particle(const T* window, int x0, T px, T py,
                                                       T pt, T* __restrict__ out,
                                                       int64_t order_stride, int64_t out_index,
                                                       int nx, int ny, int nt,
                                                       const OrderSet& orders) {
  const Axis<T> ax = make_axis(px, nx);
  const Axis<T> ay = make_axis(py, ny);
  const Axis<T> at = make_axis(pt, nt);
  const int plane = ny * nt;
  const int base = (ax.i0 - x0) * plane + ay.i0 * nt + at.i0;
  T v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int cx = k >> 2, cy = (k >> 1) & 1, ct = k & 1;
    const bool valid = ax.valid(cx) && ay.valid(cy) && at.valid(ct);
    v[k] = valid ? window[base + cx * plane + cy * nt + ct] : T(0);
  }
  T w[O][8];
  corner_weights<T, Kind, O>(ax, ay, at, orders, w);
#pragma unroll
  for (int o = 0; o < O; ++o) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += w[o][k] * v[k];
    out[o * order_stride + out_index] = acc;
  }
}

// A one-shot barrier in shared memory for the bulk copies of one block:
// thread 0 starts each copy, every thread waits for it.
struct BulkStage {
  uint64_t* barrier;
  uint32_t phase;

  // Thread 0 initialises the barrier; then the block synchronises.
  __device__ __forceinline__ void init() {
    if (threadIdx.x == 0) {
      const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(barrier));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(addr) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    phase = 0;
    __syncthreads();
  }

  // Thread 0: copy `bytes` (a multiple of 16, both addresses 16-byte
  // aligned) from global memory to shared memory. The block must have
  // synchronised since its last reads of `dst`.
  __device__ __forceinline__ void copy(void* dst, const void* src, uint32_t bytes) {
    if (threadIdx.x != 0) return;
    const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(barrier));
    const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    // Order the block's earlier reads of dst (generic proxy) before the
    // copy's writes (async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(to),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  }

  // Every thread: wait for the copy started last.
  __device__ __forceinline__ void wait() {
    const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(barrier));
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(phase)
          : "memory");
    }
    phase ^= 1u;
  }
};

// ---------------------------------------------------------------------------
// Deposits in fixed point (cic.cu, cic_tiled.cu).
// ---------------------------------------------------------------------------
//
// Every deposit adds its corner values as integers, so that its result does
// not depend on the order in which blocks and threads meet: integer adds
// give the same bits in any order, where float adds and atomics do not.
// Value v is added as rn(v * scale), read back as the integer sum times
// 1 / scale. A scale is fixed before any add from S, a bound on the sum of
// |rows| over every order and particle that adds into the cells: no cell's
// sum exceeds it, since a particle adds at most one corner to a cell and
// no corner weighs more than 1.
//
// - A window in shared memory (a privatised untiled grid, a tile's
//   window) takes S, the sum of its own particles' |rows| (prepare_window):
//   it holds int32 at scale 2^30 / S for the value order set in float32
//   (Hopper's shared-memory int32 add is native, a float add a
//   compare-and-swap loop; a term rounds by at most S 2^-31), else int64 at
//   2^(61 - floor(log2 S)) (by at most S 2^-62).
// - A grid in global memory (the untiled global route, the tiled kernel's
//   grid) is int64 at one power-of-two scale per (instance, component)
//   within a factor 4 of 2^62 / S, S = N O M: N particles, O orders, M the
//   largest finite |row| of the instance and component (row_max_kernel; a
//   max is the same in any order). A term rounds by at most S 2^-61.
//   Windows are converted to it when they are added.
//
// A cell of K terms rounds by at most K such halves. In a global grid a
// non-finite term is not added: it sets the cell's two poison bits (+inf
// 1, -inf 2, NaN both), and the cell reads +inf, -inf or NaN, as a float
// sum of the same terms would in any order. A window whose rows are not
// all finite, or whose S passes T's range, is not exact: one thread adds
// its particles in their order as floats instead (rare; the same order on
// every run).

// Threads of a deposit block (DEPOSIT_THREADS in ops/cic_common.py).
constexpr int kDepositThreads = 512;

// The row_max pass: 2048 particles a block, 8 a thread, loaded together.
constexpr int kRowMaxThreads = 256;
constexpr int kRowMaxUnroll = 8;

// The poison bits of a cell: 2 bits a cell, 16 cells a 32-bit word.
__device__ __forceinline__ void add_poison(uint32_t* poison, int64_t cell, double value) {
  const uint32_t bits = value != value ? 3u : (value > 0 ? 1u : 2u);
  atomicOr(poison + (cell >> 4), bits << ((cell & 15) * 2));
}

__device__ __forceinline__ uint32_t poison_of(const uint32_t* poison, int64_t cell) {
  return (poison[cell >> 4] >> ((cell & 15) * 2)) & 3u;
}

template <typename T>
__device__ __forceinline__ T poisoned(uint32_t bits) {
  if constexpr (std::is_same<T, float>::value) {
    return __int_as_float(
        static_cast<int>(bits == 1u ? 0x7f800000u : (bits == 2u ? 0xff800000u : 0x7fc00000u)));
  } else {
    return __longlong_as_double(bits == 1u   ? 0x7ff0000000000000LL
                                : bits == 2u ? static_cast<long long>(0xfff0000000000000ULL)
                                             : 0x7ff8000000000000LL);
  }
}

// 2^e for e in [-1022, 1022], exactly, from its bits (e clamped there).
__device__ __forceinline__ double pow2(int e) {
  e = e < -1022 ? -1022 : (e > 1022 ? 1022 : e);
  return __longlong_as_double(static_cast<long long>(1023 + e) << 52);
}

// 2^(61 - floor(log2 s)) for s > 0 (1 for s = 0): with it, |sum| <= s
// stays below 2^62, and a term rounds by at most s * 2^-62.
__device__ __forceinline__ double power_of_two_scale(double s) {
  return s > 0.0 ? pow2(61 - ilogb(s)) : 1.0;
}

// Adds `value` to int64 cell `cell` of a global grid at `scale`, or sets
// its poison bits. The add compiles to a reduction (RED.E.ADD.64).
__device__ __forceinline__ void fixed_add(long long* acc, uint32_t* poison, int64_t cell,
                                          double value, double scale) {
  if (!isfinite(value)) {
    add_poison(poison, cell, value);
    return;
  }
  atomicAdd(reinterpret_cast<unsigned long long*>(acc) + cell,
            static_cast<unsigned long long>(__double2ll_rn(value * scale)));
}

// The scratch of a deposit into int64 global grids, B * C grids of `cells`
// cells, carved from one zeroed buffer (ops/cic_common.py
// fixed_scratch_bytes): the int64 grids, their poison bits, and each
// grid's largest finite |row| M as float64 bits (row_max_kernel).
// `terms` = N O.
struct FixedScratch {
  long long* acc;
  uint32_t* poison;
  unsigned long long* row_max;
  double terms;

  static int64_t bytes(int64_t grids, int64_t cells) {
    const int64_t values = grids * cells;
    return 8 * (values + (values + 31) / 32 + grids);
  }

  static FixedScratch carve(void* base, int64_t grids, int64_t cells, double terms) {
    long long* words = static_cast<long long*>(base);
    const int64_t values = grids * cells;
    return FixedScratch{words, reinterpret_cast<uint32_t*>(words + values),
                        reinterpret_cast<unsigned long long*>(words + values + (values + 31) / 32),
                        terms};
  }

  // e of the grid's scale 2^e (pow2): 2^e N O M < 2^62, within a factor
  // 4 of it.
  __device__ __forceinline__ int exponent(int64_t grid) const {
    const double m = __longlong_as_double(static_cast<long long>(row_max[grid]));
    return m > 0.0 ? 60 - ilogb(terms) - ilogb(m) : 0;
  }

  __device__ __forceinline__ double scale(int64_t grid) const { return pow2(exponent(grid)); }
};

// The row_max pass, grid (blocks * B * C): block k of (instance b,
// component c) takes the largest finite |rows[b, o, c, n]| over every
// order o and its share of the particles n, and folds it into
// row_max[b C + c] (non-negative doubles order as their bits do). A max is
// the same in any order.
template <typename T>
__global__ void __launch_bounds__(kRowMaxThreads)
row_max_kernel(const T* __restrict__ rows, FixedScratch scratch, int64_t num_particles,
               int num_components, int num_orders, int blocks) {
  __shared__ double warp_max[kRowMaxThreads / 32];
  const int64_t bc = blockIdx.x / blocks;
  const int k = static_cast<int>(blockIdx.x - bc * blocks);
  const int64_t b = bc / num_components;
  const int c = static_cast<int>(bc - b * num_components);
  const int64_t start = num_particles * k / blocks;
  const int64_t end = num_particles * (k + 1) / blocks;
  double largest = 0.0;
  for (int o = 0; o < num_orders; ++o) {
    const T* row = rows + ((b * num_orders + o) * num_components + c) * num_particles;
    for (int64_t base = start + threadIdx.x; base < end;
         base += kRowMaxUnroll * static_cast<int64_t>(blockDim.x)) {
      T value[kRowMaxUnroll];
#pragma unroll
      for (int u = 0; u < kRowMaxUnroll; ++u) {
        const int64_t n = base + static_cast<int64_t>(u) * blockDim.x;
        value[u] = n < end ? row[n] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kRowMaxUnroll; ++u) {
        const double magnitude = fabs(static_cast<double>(value[u]));
        if (isfinite(magnitude)) largest = fmax(largest, magnitude);
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    largest = fmax(largest, __shfl_down_sync(0xffffffffu, largest, d));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x / 32] = largest;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kRowMaxThreads / 32; ++w) largest = fmax(largest, warp_max[w]);
    atomicMax(scratch.row_max + bc, static_cast<unsigned long long>(__double_as_longlong(largest)));
  }
}

// out[i] = the int64 cell i times its grid's 1 / scale as T, or the cell's
// poison: grids (B * C) of `cells` cells, two cells a thread (one 16-byte
// load; an even cell and the next share their poison word).
template <typename T>
__global__ void __launch_bounds__(256)
fixed_to_output_kernel(FixedScratch scratch, T* __restrict__ out, int64_t values, int64_t cells) {
  const int64_t i = 2 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= values) return;
  auto convert = [&](int64_t cell, long long value) {
    const uint32_t bits = poison_of(scratch.poison, cell);
    return bits ? poisoned<T>(bits)
                : static_cast<T>(static_cast<double>(value) *
                                 pow2(-scratch.exponent(cell / cells)));
  };
  if (i + 1 < values) {
    const longlong2 pair = *reinterpret_cast<const longlong2*>(scratch.acc + i);
    out[i] = convert(i, pair.x);
    out[i + 1] = convert(i + 1, pair.y);
  } else {
    out[i] = convert(i, scratch.acc[i]);
  }
}

// Zeroes `scratch` (a FixedScratch of B * C = `grids` grids), finds each
// grid's M (row_max_kernel), launches `deposit` (which adds into the int64
// grids), then writes `out` from them (fixed_to_output_kernel), all on
// `stream`.
template <typename T, typename Deposit>
cudaError_t fixed_point_deposit(const T* rows, void* scratch, int64_t scratch_bytes, T* out,
                                int64_t batch, int64_t num_particles, int num_components,
                                int num_orders, int64_t cells, cudaStream_t stream,
                                Deposit deposit) {
  const int64_t grids = batch * num_components;
  const int64_t per_grid = (num_particles + 2047) / 2048;
  const int blocks = static_cast<int>(per_grid < 1024 ? per_grid : 1024);
  if (scratch == nullptr || scratch_bytes < FixedScratch::bytes(grids, cells) ||
      grids * blocks > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaError_t status = cudaMemsetAsync(scratch, 0, scratch_bytes, stream);
  if (status != cudaSuccess) return status;
  const FixedScratch fixed = FixedScratch::carve(
      scratch, grids, cells, static_cast<double>(num_particles) * num_orders);
  row_max_kernel<T><<<static_cast<unsigned int>(grids * blocks), kRowMaxThreads, 0, stream>>>(
      rows, fixed, num_particles, num_components, num_orders, blocks);
  status = cudaGetLastError();
  if (status != cudaSuccess) return status;
  status = deposit(fixed);
  if (status != cudaSuccess) return status;
  const int64_t values = grids * cells;
  fixed_to_output_kernel<T><<<static_cast<unsigned int>((values + 511) / 512), 256, 0, stream>>>(
      fixed, out, values, cells);
  return cudaGetLastError();
}

// Where a block adds its corner values: a window of `group` components
// (the whole grid, or a tile's R + 1 rows) in shared memory, `Acc` cells
// (int for the value order set in float32, else long long). An exact
// window adds in fixed point (add, any thread, any order); a window that
// is not (non-finite rows, or S past T's range) holds T values, added by
// one thread in the particles' order (add_in_order).
template <typename T, typename Acc>
struct FixedWindow {
  using Scale = typename std::conditional<sizeof(Acc) == 4, float, double>::type;
  Acc* local;
  Scale scale;
  Scale unscale;
  bool exact;

  __device__ __forceinline__ void add(int v, T value) const {
    if constexpr (sizeof(Acc) == 4) {
      atomicAdd(reinterpret_cast<int*>(local) + v, __float2int_rn(value * scale));
    } else {
      const long long units = __double2ll_rn(static_cast<double>(value) * scale);
      atomicAdd(reinterpret_cast<unsigned long long*>(local) + v,
                static_cast<unsigned long long>(units));
    }
  }

  __device__ __forceinline__ void add_in_order(int v, T value) const {
    reinterpret_cast<T*>(local)[v] += value;
  }

  __device__ __forceinline__ T read(int v) const {
    if (!exact) return reinterpret_cast<const T*>(local)[v];
    return static_cast<T>(static_cast<Scale>(local[v]) * unscale);
  }
};

// Bytes of a window of `values` cells of `Acc`, rounded up to 16, plus
// `stage` bytes after them (ops/cic_common.py window_bytes).
template <typename Acc>
__host__ __device__ inline int64_t window_bytes(int64_t values, int64_t stage = 0) {
  return (values * static_cast<int64_t>(sizeof(Acc)) + 15) / 16 * 16 + stage;
}

template <typename T, int Kind>
using Accumulator =
    typename std::conditional<std::is_same<T, float>::value && Kind == kValueOrders, int,
                              long long>::type;

// The window's scale from S = `total`, and whether it is exact: every row
// finite (`finite`, the whole block's) and S within T's range, so that no
// term is infinite.
template <typename T, typename Acc>
__device__ __forceinline__ void set_window_scale(FixedWindow<T, Acc>& window, double total,
                                                 bool finite) {
  window.exact = finite && total <= static_cast<double>(std::is_same<T, float>::value
                                                            ? 3.4028234663852886e38
                                                            : 1.7976931348623157e308);
  if constexpr (sizeof(Acc) == 4) {
    window.scale = window.unscale = 1.0f;
    if (total > 0.0) {
      window.scale = fminf(static_cast<float>(1073741824.0 / total), 3.0e38f);
      window.unscale = static_cast<float>(total * (1.0 / 1073741824.0));
    }
  } else {
    window.scale = power_of_two_scale(total);
    window.unscale = 1.0 / window.scale;
  }
}

// Zeroes `bytes` bytes at `local` (16-byte aligned; a multiple of 4),
// every thread of the block.
__device__ __forceinline__ void zero_shared(void* local, int64_t bytes) {
  const int quads = static_cast<int>(bytes / 16);
  for (int i = threadIdx.x; i < quads; i += blockDim.x)
    reinterpret_cast<int4*>(local)[i] = make_int4(0, 0, 0, 0);
  for (int i = quads * 4 + threadIdx.x; i < static_cast<int>(bytes / 4); i += blockDim.x)
    reinterpret_cast<int*>(local)[i] = 0;
}

// Sums `sum` over the block (each thread's share, then the warps' shuffle
// trees, then the warps in turn: the same order on every run) into
// partial[32], and whether `finite` holds on every thread. `partial` is 33
// doubles of the block's shared memory. Ends with the block synchronised.
__device__ __forceinline__ bool block_sum(double sum, bool finite, double* partial) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, d);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x / 32] = sum;
  finite = __syncthreads_and(finite);
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) total += partial[w];
    partial[32] = total;
  }
  __syncthreads();
  return finite;
}

// Every thread of the block: zeroes the window's `values` cells (16 bytes
// a store; `local` is 16-byte aligned) and fixes the window's scale from S,
// the sum of |rows[o * order_stride + g * row_stride + index(i)]| over the
// orders, the group's components and the particles first + k * stride
// below `end`, summed in float64: 2^30 / S for an int32 window (a term
// rounds by at most S * 2^-31: with at most 16384 particles a copy or
// chunk, the wrappers' MAX_WINDOW_PARTICLES, 2^-17 of the largest row),
// else power_of_two_scale(S). `partial` is 33 doubles of the block's shared
// memory. Ends with the block synchronised, the window ready for adds.
template <typename T, typename Acc, typename Index>
__device__ __forceinline__ void prepare_window(FixedWindow<T, Acc>& window, int values,
                                               const T* __restrict__ rows, int64_t first,
                                               int64_t end, int64_t stride, Index index,
                                               int64_t row_stride, int64_t order_stride,
                                               int num_orders, int group, double* partial) {
  zero_shared(window.local, values * static_cast<int64_t>(sizeof(Acc)));
  double sum = 0.0;
  bool finite = true;
  // Eight particles' loads in flight together.
  for (int64_t base = first; base < end; base += 8 * stride) {
    int64_t n[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) n[u] = base + u * stride < end ? index(base + u * stride) : -1;
    for (int o = 0; o < num_orders; ++o) {
      for (int g = 0; g < group; ++g) {
        const T* component = rows + o * order_stride + g * row_stride;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const double value = n[u] >= 0 ? fabs(static_cast<double>(component[n[u]])) : 0.0;
          finite = finite && isfinite(value);
          sum += value;
        }
      }
    }
  }
  finite = block_sum(sum, finite, partial);
  set_window_scale(window, partial[32], finite);
}

// The deposit of particles first, first + stride, ... below `end`: for each
// corner on the grid of each particle, and each component g < group of
// `rows`, add(g, ix, iy, it, value) with the corner's grid indices and its
// value summed over the orders. Particle i's position is pos[3i .. 3i + 2]
// and its row of order o and component g rows[o * order_stride + g *
// row_stride + index(i)]. The value order set (every path's deposit) keeps
// the loads of kUnroll particles in flight together, so that the latency of
// a row read through a permutation is paid once for several particles;
// other sets take one particle at a time. A particle's axes are made after
// its loads, to keep registers free.
template <typename T, int Kind, typename Index, typename Add>
__device__ __forceinline__ void deposit_particles(const T* __restrict__ pos,
                                                  const T* __restrict__ rows, int64_t first,
                                                  int64_t end, int64_t stride, Index index,
                                                  int64_t row_stride, int64_t order_stride,
                                                  int group, int nx, int ny, int nt,
                                                  const OrderSet& orders, Add add) {
  constexpr int kUnroll = Kind == kValueOrders ? (sizeof(T) == 4 ? 4 : 2) : 1;
  for (int64_t base = first; base < end; base += kUnroll * stride) {
    T px[kUnroll], py[kUnroll], pt[kUnroll];
    int64_t n[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      live[u] = i < end;
      const T* p = pos + (live[u] ? i : first) * 3;
      px[u] = p[0];
      py[u] = p[1];
      pt[u] = p[2];
      n[u] = live[u] ? index(i) : 0;
    }
    for (int g = 0; g < group; ++g) {
      const T* component = rows + g * row_stride;
      if constexpr (Kind == kValueOrders) {
        T r[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) r[u] = live[u] ? component[n[u]] : T(0);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const Axis<T> ax = make_axis(px[u], nx);
          const Axis<T> ay = make_axis(py[u], ny);
          const Axis<T> at = make_axis(pt[u], nt);
          if (!(live[u] && ax.any() && ay.any() && at.any())) continue;
#pragma unroll
          for (int corner = 0; corner < 8; ++corner) {
            const int cx = corner >> 2, cy = (corner >> 1) & 1, ct = corner & 1;
            if (!(ax.valid(cx) && ay.valid(cy) && at.valid(ct))) continue;
            add(g, ax.i0 + cx, ay.i0 + cy, at.i0 + ct,
                r[u] * (ax.weight(0, cx) * ay.weight(0, cy) * at.weight(0, ct)));
          }
        }
      } else {
        const Axis<T> ax = make_axis(px[0], nx);
        const Axis<T> ay = make_axis(py[0], ny);
        const Axis<T> at = make_axis(pt[0], nt);
        if (!(live[0] && ax.any() && ay.any() && at.any())) continue;
        T r[kMaxOrders];
#pragma unroll
        for (int o = 0; o < kMaxOrders; ++o)
          r[o] = o < orders.count ? component[o * order_stride + n[0]] : T(0);
#pragma unroll
        for (int corner = 0; corner < 8; ++corner) {
          const int cx = corner >> 2, cy = (corner >> 1) & 1, ct = corner & 1;
          if (!(ax.valid(cx) && ay.valid(cy) && at.valid(ct))) continue;
          add(g, ax.i0 + cx, ay.i0 + cy, at.i0 + ct, corner_sum(r, orders, cx, cy, ct, ax, ay, at));
        }
      }
    }
  }
}

// Whether `bytes` from `offset` elements past a 256-byte-aligned tensor
// can be one bulk copy into a buffer of `budget` bytes.
inline bool stageable(int64_t offset_bytes, int64_t bytes, int64_t budget) {
  return bytes > 0 && bytes <= budget && bytes % 16 == 0 && offset_bytes % 16 == 0;
}

// What the launches need to know of the current card, read once per device
// (the host's time per launch counts on paths of many small launches).
constexpr int kCachedDevices = 64;

struct DeviceLimits {
  int device;       // the current device's index
  int sms;          // streaming multiprocessors
  int64_t staging;  // the shared memory a block may take for a staged grid:
                    // the opt-in limit less 1 KB for the barrier and the
                    // other static shared memory
};

inline cudaError_t device_limits(DeviceLimits* limits) {
  static DeviceLimits cache[kCachedDevices] = {};
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return status;
  if (device < kCachedDevices && cache[device].sms > 0) {
    *limits = cache[device];
    return cudaSuccess;
  }
  int sms = 0, optin = 0;
  status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (status != cudaSuccess) return status;
  *limits = DeviceLimits{device, sms, static_cast<int64_t>(optin) - 1024};
  if (device < kCachedDevices) cache[device] = *limits;
  return cudaSuccess;
}

// What the wrappers size a deposit's launch from (ops/cic_common.py
// device_limits): out = {SMs, the staging budget of a block, the shared
// memory of one SM}, all of device `device`.
inline int limits_of_device(int device, int* out) {
  int sms = 0, optin = 0, per_sm = 0;
  cudaError_t status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (status == cudaSuccess)
    status =
        cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (status != cudaSuccess) return static_cast<int>(status);
  out[0] = sms;
  out[1] = optin - 1024;  // as DeviceLimits::staging
  out[2] = per_sm;
  return 0;
}

// Lets a staged kernel take the whole staging budget of dynamic shared
// memory on the current device, once per device: `configured` is the
// launcher's own (a static of the instantiation that launches `kernel`).
template <typename Kernel>
cudaError_t allow_staging(Kernel kernel, const DeviceLimits& limits,
                          bool (&configured)[kCachedDevices]) {
  if (limits.device < kCachedDevices && configured[limits.device]) return cudaSuccess;
  const cudaError_t status = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(limits.staging));
  if (status == cudaSuccess && limits.device < kCachedDevices) configured[limits.device] = true;
  return status;
}

inline OrderSet make_orders(const int* orders, int num_orders) {
  OrderSet set{};
  set.count = num_orders;
  for (int o = 0; o < num_orders; ++o) {
    set.x[o] = orders[3 * o];
    set.y[o] = orders[3 * o + 1];
    set.t[o] = orders[3 * o + 2];
  }
  return set;
}

inline bool valid_orders(const int* orders, int num_orders) {
  if (num_orders < 1 || num_orders > kMaxOrders) return false;
  for (int i = 0; i < 3 * num_orders; ++i) {
    if (orders[i] != 0 && orders[i] != 1) return false;
  }
  return true;
}

inline OrderKind order_kind(const int* orders, int num_orders) {
  if (num_orders == 1 && orders[0] == 0 && orders[1] == 0 && orders[2] == 0)
    return kValueOrders;
  if (num_orders == 3) {
    bool raised = true;
    for (int o = 0; o < 3; ++o)
      for (int axis = 0; axis < 3; ++axis) raised &= orders[3 * o + axis] == (o == axis);
    if (raised) return kRaisedOrders;
  }
  return kGenericOrders;
}

// Whether every element index of a gather fits int32: the grids (B, C,
// cells), the outputs (O, B, C, N) and the positions (B, N, 3).
inline bool fits_int32(int64_t batch, int64_t num_particles, int num_components,
                       int64_t cells, int num_orders) {
  const int64_t limit = INT32_MAX;
  return batch * num_components * cells <= limit &&
         num_orders * batch * num_components * num_particles <= limit &&
         batch * num_particles * 3 <= limit;
}

// Calls launch(Int<Kind>{}, Int<O>{}, Int<C>{}, index) with the
// instantiation of the gather body that serves the call, `index` being an
// int32_t or int64_t value whose type is I: the specialised order sets at C
// = 1 and 3 where every index fits int32 (`small`); every other call the
// generic body with O orders, C at run time and int64_t indices. Returns
// what launch returns.
template <typename Launch>
cudaError_t dispatch_gather(const int* orders, int num_orders, int num_components, bool small,
                            Launch&& launch) {
  auto with_components = [&](auto kind, auto count) -> cudaError_t {
    if (num_components == 1) return launch(kind, count, Int<1>{}, int32_t{});
    if (num_components == 3) return launch(kind, count, Int<3>{}, int32_t{});
    return launch(Int<kGenericOrders>{}, count, Int<0>{}, int64_t{});
  };
  switch (small ? order_kind(orders, num_orders) : kGenericOrders) {
    case kValueOrders: return with_components(Int<kValueOrders>{}, Int<1>{});
    case kRaisedOrders: return with_components(Int<kRaisedOrders>{}, Int<3>{});
    default: break;
  }
  const auto generic = Int<kGenericOrders>{};
  const auto runtime = Int<0>{};
  switch (num_orders) {
    case 1: return launch(generic, Int<1>{}, runtime, int64_t{});
    case 2: return launch(generic, Int<2>{}, runtime, int64_t{});
    case 3: return launch(generic, Int<3>{}, runtime, int64_t{});
    case 4: return launch(generic, Int<4>{}, runtime, int64_t{});
    case 5: return launch(generic, Int<5>{}, runtime, int64_t{});
    case 6: return launch(generic, Int<6>{}, runtime, int64_t{});
    case 7: return launch(generic, Int<7>{}, runtime, int64_t{});
    default: return launch(generic, Int<8>{}, runtime, int64_t{});
  }
}

}  // namespace cic
