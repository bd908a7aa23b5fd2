// Shared pieces of the multi-order CIC kernels (cic.cu, cic_tiled.cu).
//
// Per axis, with i0 = floor(p) and f = p - i0, order 0 weighs corner i0 with
// 1 - f and corner i0 + 1 with f; order 1 (the a.e. derivative) weighs them
// -1 and +1. A corner outside [0, n - 1] weighs 0. The range is tested in
// floating point BEFORE the conversion to int, so NaN, +-inf and huge
// positions (for which the conversion is undefined) give weight 0 at every
// corner; the JAX package parks such particles at -2 for the same reason.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cic {

constexpr int kMaxOrders = 8;

struct OrderSet {
  int count;
  int x[kMaxOrders];
  int y[kMaxOrders];
  int t[kMaxOrders];
};

template <typename T>
struct Axis {
  int i0;     // floor(p), valid only when v0 or v1
  T f;        // p - floor(p)
  bool v0;    // corner i0 lies on the grid
  bool v1;    // corner i0 + 1 lies on the grid

  __device__ __forceinline__ bool any() const { return v0 || v1; }
  __device__ __forceinline__ bool valid(int c) const { return c ? v1 : v0; }
};

template <typename T>
__device__ __forceinline__ Axis<T> make_axis(T p, int n) {
  Axis<T> a;
  T fl = floor(p);
  // Comparisons with NaN are false; +-inf and huge values fail the range.
  a.v0 = (fl >= T(0)) && (fl <= T(n - 1));
  a.v1 = (fl >= T(-1)) && (fl <= T(n - 2));
  a.i0 = (a.v0 || a.v1) ? static_cast<int>(fl) : 0;
  a.f = p - fl;
  return a;
}

// Weight of corner `c` (0: i0, 1: i0 + 1) at derivative order `o`.
template <typename T>
__device__ __forceinline__ T weight(int o, int c, T f) {
  if (o == 0) return c ? f : T(1) - f;
  return c ? T(1) : T(-1);
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
      acc += r[o] * weight(orders.x[o], cx, ax.f) * weight(orders.y[o], cy, ay.f) *
             weight(orders.t[o], ct, at.f);
  }
  return acc;
}

// The gather of one particle: for each component c, out[o * plane + offset +
// c * num_particles] = sum over the 8 corners of w_o * grid[c, corner].
// `grid` points at the particle's instance, (C, nx, ny, nt).
template <typename T>
__device__ __forceinline__ void gather_particle(const T* __restrict__ grid, const T* p,
                                                T* __restrict__ out, int64_t plane,
                                                int64_t offset, int64_t num_particles,
                                                int num_components, int nx, int ny, int nt,
                                                const OrderSet& orders) {
  const Axis<T> ax = make_axis(p[0], nx);
  const Axis<T> ay = make_axis(p[1], ny);
  const Axis<T> at = make_axis(p[2], nt);
  const int64_t cells = static_cast<int64_t>(nx) * ny * nt;
  for (int c = 0; c < num_components; ++c) {
    const T* g = grid + c * cells;
    T acc[kMaxOrders];
#pragma unroll
    for (int o = 0; o < kMaxOrders; ++o) acc[o] = T(0);
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      const int cx = corner >> 2, cy = (corner >> 1) & 1, ct = corner & 1;
      if (!(ax.valid(cx) && ay.valid(cy) && at.valid(ct))) continue;
      const int64_t cell =
          (static_cast<int64_t>(ax.i0 + cx) * ny + (ay.i0 + cy)) * nt + (at.i0 + ct);
      const T value = __ldg(g + cell);
#pragma unroll
      for (int o = 0; o < kMaxOrders; ++o) {
        if (o < orders.count)
          acc[o] += weight(orders.x[o], cx, ax.f) * weight(orders.y[o], cy, ay.f) *
                    weight(orders.t[o], ct, at.f) * value;
      }
    }
    const int64_t index = offset + c * num_particles;
#pragma unroll
    for (int o = 0; o < kMaxOrders; ++o) {
      if (o < orders.count) out[o * plane + index] = acc[o];
    }
  }
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

}  // namespace cic
