// Multi-order cloud-in-cell (CIC) deposit and trilinear gather for Hopper.
//
// Built by cheetah_tpu_torch/ops/nvcc.py (wrappers in ops/cic_kernels.py) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// Both kernels keep the contract of the TPU kernels they replace:
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
// in parallel and in no order, so nothing carries over between them: here
// one thread handles one (instance, particle). The deposit scatters its 8
// corners x C components (summed over the O orders in registers) with
// atomicAdd into a grid that the wrapper zeroes; the order of the atomic sums
// changes from run to run, so results agree with a fixed-order sum only to
// f32 (or f64) rounding. The gather reads 8 corners per component straight
// from the grid, which stays resident in the 50 MB L2 (a 32^3 f32 component
// is 128 KB, 64^3 is 1 MB).
//
// Bound on the card: bytes, not operations. Per particle the deposit does
// 8 * C * (O + 1) multiply-adds and the gather 8 * C * O, far below the
// 67 TFLOP/s f32 rate for the bytes they move: positions (12 B), rows
// (4 * O * C B) and the outputs (the grid once, or 4 * O * C B per
// particle), at 3.35 TB/s. Random atomics and L2 reads, not DRAM, limit
// these simple kernels; a later PR can privatise a 32^3 grid in shared
// memory (128 KB f32) per block.

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

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
deposit_multi_kernel(const T* __restrict__ pos, const T* __restrict__ rows,
                     T* __restrict__ out, int64_t batch, int64_t num_particles,
                     int num_components, int nx, int ny, int nt, OrderSet orders) {
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
    T* grid = out + (b * num_components + c) * cells;
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      const int cx = corner >> 2, cy = (corner >> 1) & 1, ct = corner & 1;
      if (!(ax.valid(cx) && ay.valid(cy) && at.valid(ct))) continue;
      const int64_t cell =
          (static_cast<int64_t>(ax.i0 + cx) * ny + (ay.i0 + cy)) * nt + (at.i0 + ct);
      atomicAdd(grid + cell, corner_sum(r, orders, cx, cy, ct, ax, ay, at));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_multi_kernel(const T* __restrict__ grids, const T* __restrict__ pos,
                    T* __restrict__ out, int64_t batch, int64_t num_particles,
                    int num_components, int nx, int ny, int nt, OrderSet orders) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= batch * num_particles) return;
  const int64_t b = tid / num_particles;
  const int64_t n = tid - b * num_particles;
  const int64_t cells = static_cast<int64_t>(nx) * ny * nt;
  gather_particle(grids + b * num_components * cells, pos + tid * 3, out,
                  batch * num_components * num_particles, b * num_components * num_particles + n,
                  num_particles, num_components, nx, ny, nt, orders);
}

unsigned int num_blocks(int64_t work) {
  return static_cast<unsigned int>((work + kThreads - 1) / kThreads);
}

template <typename T>
int deposit(const void* pos, const void* rows, void* out, int64_t batch,
            int64_t num_particles, int num_components, int nx, int ny, int nt,
            const int* orders, int num_orders, void* stream) {
  if (!valid_orders(orders, num_orders)) return static_cast<int>(cudaErrorInvalidValue);
  deposit_multi_kernel<T><<<num_blocks(batch * num_particles), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos), static_cast<const T*>(rows), static_cast<T*>(out),
      batch, num_particles, num_components, nx, ny, nt, make_orders(orders, num_orders));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gather(const void* grids, const void* pos, void* out, int64_t batch,
           int64_t num_particles, int num_components, int nx, int ny, int nt,
           const int* orders, int num_orders, void* stream) {
  if (!valid_orders(orders, num_orders)) return static_cast<int>(cudaErrorInvalidValue);
  gather_multi_kernel<T><<<num_blocks(batch * num_particles), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(grids), static_cast<const T*>(pos), static_cast<T*>(out),
      batch, num_particles, num_components, nx, ny, nt, make_orders(orders, num_orders));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface. Every function launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" {

int cic_deposit_multi_f32(const void* pos, const void* rows, void* out, int64_t batch,
                          int64_t num_particles, int num_components, int nx, int ny,
                          int nt, const int* orders, int num_orders, void* stream) {
  return deposit<float>(pos, rows, out, batch, num_particles, num_components, nx, ny, nt,
                        orders, num_orders, stream);
}

int cic_deposit_multi_f64(const void* pos, const void* rows, void* out, int64_t batch,
                          int64_t num_particles, int num_components, int nx, int ny,
                          int nt, const int* orders, int num_orders, void* stream) {
  return deposit<double>(pos, rows, out, batch, num_particles, num_components, nx, ny, nt,
                         orders, num_orders, stream);
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
