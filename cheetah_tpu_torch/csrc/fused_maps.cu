// The first-order 7x7 map of a fused linear run, built and composed in one
// launch, for Hopper.
//
// Built by cheetah_tpu_torch/ops/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes; the
// wrapper is in cheetah_tpu_torch/ops/fused_maps.py.
//
// A fused run's map is M_{n-1} @ ... @ M_0 @ I over its elements' first-order
// maps, each broadcast over the run's instances (the broadcast of every
// parameter's and the energy's vector shape, flattened). Built element by
// element in PyTorch that is about 15 small operators an element; here one
// launch builds every element's map of every instance and composes them.
// The JAX package has no Pallas kernel here: XLA fused its maps.
//
// Design. Seven threads an instance, one column j of the running product
// each: (M @ P)[:, j] = M @ P[:, j], so a thread keeps 7 values, applies
// each element's map to them in the run's order, and writes its column of
// the (..., 7, 7) result once. Each thread builds the element's map in
// registers from the instance's parameters with the formulas of the
// composite path (ops/transfer_maps.py, utils/maths.py, utils/physics.py),
// in the tensors' own dtype: compute_relativistic_factors, cos_sqrt,
// sinc_sqrt and si1mdiv with their branches at 0 and below 0, base_rmatrix
// with its zero curvature computed through every entry, drift_matrix, the
// correctors' kicks, and a quadrupole's misalignment and tilt frames
// (R_exit @ R @ R_entry, applied to the column one after another). The
// maps are applied densely, identity entries and all.
//
// The element table is a kernel parameter (__grid_constant__, read from the
// constant bank, the same entry by every thread): each entry is an opcode
// and up to five parameters, each a device address and a stride over the
// flattened instance index (0 for a parameter every instance shares). A run
// longer than kMaxEntries is built by consecutive launches, each starting
// from the product the one before wrote.

#include <cuda_runtime.h>

#include <cstring>

namespace fused {

constexpr int kSlots = 5;
constexpr int kMaxEntries = 32;
constexpr int kThreads = 128;

// The opcodes of ops/fused_maps.py.
enum Opcode : long long {
  kMarker = 0,
  kDrift = 1,
  kQuadrupole = 2,
  kHorizontalCorrector = 3,
  kVerticalCorrector = 4,
  kCombinedCorrector = 5,
};

// A parameter: its address and its stride (in elements) over the flattened
// instance index.
struct Slot {
  long long address;
  long long stride;
};

// An element: its opcode and its parameters in the wrapper's order (a
// quadrupole's: length, k1, misalignment x, misalignment y, tilt).
struct Entry {
  long long opcode;
  Slot slot[kSlots];
};

// The table the wrapper packs as int64 words in this layout.
struct Table {
  Slot energy;
  Slot mass;
  long long count;
  Entry entry[kMaxEntries];
};
static_assert(sizeof(Table) == (5 + 11 * kMaxEntries) * 8, "packed layout");
static_assert(sizeof(Table) < 4000, "a kernel parameter");

template <typename T>
__device__ __forceinline__ T load(const Slot& slot, long long instance) {
  return reinterpret_cast<const T*>(slot.address)[slot.stride * instance];
}

// torch.clamp(x, min=0): NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_min0(T x) {
  return x < T(0) ? T(0) : x;
}

// utils/maths.py _cos_sqrt_value.
template <typename T>
__device__ __forceinline__ T cos_sqrt(T x) {
  return x >= T(0) ? cos(sqrt(clamp_min0(x))) : cosh(sqrt(clamp_min0(-x)));
}

// utils/maths.py _sinc_sqrt_value.
template <typename T>
__device__ __forceinline__ T sinc_sqrt(T x) {
  if (x == T(0)) return T(1);
  if (x >= T(0)) {
    const T xp = sqrt(clamp_min0(x));
    return sin(xp) / (xp == T(0) ? T(1) : xp);
  }
  const T xn = sqrt(clamp_min0(-x));
  return sinh(xn) / (xn == T(0) ? T(1) : xn);
}

// utils/maths.py _si1mdiv_value.
template <typename T>
__device__ __forceinline__ T si1mdiv(T x) {
  return x == T(0) ? T(1.0 / 6.0) : (T(1) - sinc_sqrt(x)) / x;
}

template <typename T>
struct Map {
  T m[7][7];

  __device__ __forceinline__ Map() {
#pragma unroll
    for (int i = 0; i < 7; ++i) {
#pragma unroll
      for (int k = 0; k < 7; ++k) m[i][k] = i == k ? T(1) : T(0);
    }
  }

  // column <- m @ column, each row summed over k in order.
  __device__ __forceinline__ void apply(T (&column)[7]) const {
    T result[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      T sum = m[i][0] * column[0];
#pragma unroll
      for (int k = 1; k < 7; ++k) sum += m[i][k] * column[k];
      result[i] = sum;
    }
#pragma unroll
    for (int i = 0; i < 7; ++i) column[i] = result[i];
  }
};

// ops/transfer_maps.py drift_matrix, with the kicks of corrector_matrix.
template <typename T>
__device__ __forceinline__ Map<T> drift(T length, T igamma2, T beta) {
  Map<T> map;
  map.m[0][1] = length;
  map.m[2][3] = length;
  map.m[4][5] = -length / (beta * beta) * igamma2;
  return map;
}

// ops/transfer_maps.py quadrupole_matrix: base_rmatrix with hx = 0 inside
// combined_rotation_misalignment_matrix's frames.
template <typename T>
__device__ __forceinline__ void quadrupole(const Entry& entry, long long instance, T igamma2,
                                           T beta, T (&column)[7]) {
  const T length = load<T>(entry.slot[0], instance);
  const T k1 = load<T>(entry.slot[1], instance);
  const T mis_x = load<T>(entry.slot[2], instance);
  const T mis_y = load<T>(entry.slot[3], instance);
  const T tilt = load<T>(entry.slot[4], instance);
  const T cs = cos(tilt);
  const T sn = sin(tilt);

  Map<T> entry_frame;
  entry_frame.m[0][0] = cs;
  entry_frame.m[0][2] = sn;
  entry_frame.m[1][1] = cs;
  entry_frame.m[1][3] = sn;
  entry_frame.m[2][0] = -sn;
  entry_frame.m[2][2] = cs;
  entry_frame.m[3][1] = -sn;
  entry_frame.m[3][3] = cs;
  entry_frame.m[0][6] = -mis_x * cs - mis_y * sn;
  entry_frame.m[2][6] = mis_x * sn - mis_y * cs;
  entry_frame.apply(column);

  const T hx = T(0);
  const T kx2 = k1 + hx * hx;
  const T ky2 = -k1;
  const T l2 = length * length;
  const T cx = cos_sqrt(kx2 * l2);
  const T cy = cos_sqrt(ky2 * l2);
  const T sx = sinc_sqrt(kx2 * l2) * length;
  const T sy = sinc_sqrt(ky2 * l2) * length;
  const T r = sinc_sqrt(T(0.25) * kx2 * l2);
  const T dx = hx * T(0.5) * l2 * (r * r);
  const T beta2 = beta * beta;
  const T r56 = hx * hx * (length * length * length) * si1mdiv(kx2 * l2) / beta2 -
                length / beta2 * igamma2;
  Map<T> body;
  body.m[0][0] = cx;
  body.m[0][1] = sx;
  body.m[0][5] = dx / beta;
  body.m[1][0] = -kx2 * sx;
  body.m[1][1] = cx;
  body.m[1][5] = sx * hx / beta;
  body.m[2][2] = cy;
  body.m[2][3] = sy;
  body.m[3][2] = -ky2 * sy;
  body.m[3][3] = cy;
  body.m[4][0] = sx * hx / beta;
  body.m[4][1] = dx / beta;
  body.m[4][5] = r56;
  body.apply(column);

  Map<T> exit_frame;
  exit_frame.m[0][0] = cs;
  exit_frame.m[2][0] = sn;
  exit_frame.m[1][1] = cs;
  exit_frame.m[3][1] = sn;
  exit_frame.m[0][2] = -sn;
  exit_frame.m[2][2] = cs;
  exit_frame.m[1][3] = -sn;
  exit_frame.m[3][3] = cs;
  exit_frame.m[0][6] = mis_x;
  exit_frame.m[2][6] = mis_y;
  exit_frame.apply(column);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_run_map_kernel(const __grid_constant__ Table table, long long instances,
                         const T* init, T* out) {
  const long long thread = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (thread >= instances * 7) return;
  const long long instance = thread / 7;
  const int j = static_cast<int>(thread - instance * 7);

  T column[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    column[i] = init != nullptr ? init[instance * 49 + i * 7 + j] : T(i == j ? 1 : 0);
  }

  // utils/physics.py compute_relativistic_factors.
  const T gamma = load<T>(table.energy, instance) / load<T>(table.mass, instance);
  const T igamma2 = T(1) / (gamma * gamma);
  const T beta = sqrt(T(1) - igamma2);

  for (long long e = 0; e < table.count; ++e) {
    const Entry& entry = table.entry[e];
    switch (entry.opcode) {
      case kMarker:
        Map<T>().apply(column);
        break;
      case kDrift:
        drift(load<T>(entry.slot[0], instance), igamma2, beta).apply(column);
        break;
      case kQuadrupole:
        quadrupole(entry, instance, igamma2, beta, column);
        break;
      case kHorizontalCorrector: {
        Map<T> map = drift(load<T>(entry.slot[0], instance), igamma2, beta);
        map.m[1][6] = load<T>(entry.slot[1], instance);
        map.apply(column);
        break;
      }
      case kVerticalCorrector: {
        Map<T> map = drift(load<T>(entry.slot[0], instance), igamma2, beta);
        map.m[3][6] = load<T>(entry.slot[1], instance);
        map.apply(column);
        break;
      }
      case kCombinedCorrector: {
        Map<T> map = drift(load<T>(entry.slot[0], instance), igamma2, beta);
        map.m[1][6] = load<T>(entry.slot[1], instance);
        map.m[3][6] = load<T>(entry.slot[2], instance);
        map.apply(column);
        break;
      }
    }
  }

  T* target = out + instance * 49 + j;
#pragma unroll
  for (int i = 0; i < 7; ++i) target[i * 7] = column[i];
}

template <typename T>
int launch(const long long* packed, long long instances, const void* init, void* out,
           cudaStream_t stream) {
  Table table;
  std::memset(&table, 0, sizeof(table));
  std::memcpy(&table, packed, 5 * sizeof(long long));
  if (table.count < 1 || table.count > kMaxEntries || instances < 1) {
    return cudaErrorInvalidValue;
  }
  std::memcpy(table.entry, packed + 5, table.count * sizeof(Entry));
  const long long blocks = (instances * 7 + kThreads - 1) / kThreads;
  fused_run_map_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      table, instances, static_cast<const T*>(init), static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace fused

extern "C" {

// packed: the Table as 5 + 11 * count int64 words; init: the product to
// start from, (instances, 7, 7), or null for the identity (it may be out).
int fused_run_map_f32(const long long* packed, long long instances, const void* init,
                      void* out, void* stream) {
  return fused::launch<float>(packed, instances, init, out,
                              static_cast<cudaStream_t>(stream));
}

int fused_run_map_f64(const long long* packed, long long instances, const void* init,
                      void* out, void* stream) {
  return fused::launch<double>(packed, instances, init, out,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
