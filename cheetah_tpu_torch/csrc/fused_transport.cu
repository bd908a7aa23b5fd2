// A particle beam through a 7x7 first-order map, and the survival-weighted
// sums of the outgoing particles' components and of their squares, in one
// pass, for Hopper.
//
// Built by cheetah_tpu_torch/ops/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes; the
// wrapper is in cheetah_tpu_torch/ops/fused_transport.py.
//
// out[b, n, i] = sum_k map[b, i, k] * particles[b, n, k] for each instance b
// (the flattened broadcast of the particles', the map's and the weights'
// vector shapes), and s1[b, i] = sum_n w[b, n] out[b, n, i], s2[b, i] =
// sum_n w[b, n] out[b, n, i]^2. In PyTorch that is a GEMM that writes the
// outgoing beam, a square that reads it and writes a second array of its
// size, and two matrix-vector products that read both. The JAX package has
// no Pallas kernel here: XLA fused its transport and its moments.
//
// What bounds it: the bytes of the outgoing beam, written once. In the env
// step every instance shares one incoming beam (a zero stride), which stays
// in L2; 4096 x 10000 particles of float32 write 1.147 GB. The arithmetic,
// 49 FMAs a particle and the sums, is a tenth of that time.
//
// Design. A block takes one instance's particles, or a chunk of them, in
// tiles of kThreads groups; a group is the particles of 7 16-byte words (4
// in float32, 2 in float64). A thread reads its group with 16-byte loads,
// applies the map (in the tensors' dtype, each output a 7-term sum in the
// order k = 0..6, with FMAs) and stages the outgoing group in shared memory,
// which the block then stores as a contiguous run of 16-byte words (two
// buffers, so one barrier a tile). The sums are accumulated in float64
// registers from the outgoing values the thread holds, then reduced by
// warp shuffles and a fixed-order sum over the block's warps. Where one
// instance's particles span several blocks, each writes its 14 partial sums
// and a second launch adds them over the chunks in order. No atomics: the
// same inputs give the same bits on every run. A tensor that is not
// 16-byte aligned takes scalar loads and stores.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace transport {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// s1 (7 components) then s2 (7 components).
constexpr int kSums = 14;
constexpr int kSumThreads = 256;

// One 16-byte word as raw bits and as the values it holds.
template <typename T>
union Word {
  uint4 raw;
  T value[16 / sizeof(T)];
};

__device__ __forceinline__ bool aligned16(const void* pointer) {
  return (reinterpret_cast<uintptr_t>(pointer) & 15) == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    transport_moments_kernel(const T* __restrict__ particles, long long particle_stride,
                             const T* __restrict__ maps, long long map_stride,
                             const T* __restrict__ weights, long long weight_stride,
                             long long n, long long chunk, long long chunks, T* __restrict__ out,
                             T* __restrict__ s1, T* __restrict__ s2,
                             double* __restrict__ partials) {
  // Particles a group, and values a 16-byte word: a group is 7 words.
  constexpr int G = 16 / sizeof(T);
  constexpr int kTile = kThreads * G;
  __shared__ __align__(16) T staged[2][kTile * 7];
  __shared__ T map[49];
  __shared__ double warp_sums[kWarps][kSums];

  const long long block = blockIdx.x;
  const long long instance = block / chunks;
  const long long begin = (block - instance * chunks) * chunk;
  const long long end = min(begin + chunk, n);
  const T* in = particles + instance * particle_stride;
  const T* w = weights + instance * weight_stride;
  T* target = out + instance * n * 7;
  const bool vector_in = aligned16(in);

  if (threadIdx.x < 49) map[threadIdx.x] = maps[instance * map_stride + threadIdx.x];
  __syncthreads();

  double sums[kSums];
#pragma unroll
  for (int c = 0; c < kSums; ++c) sums[c] = 0.0;

  int buffer = 0;
  for (long long start = begin; start < end; start += kTile, buffer ^= 1) {
    const int count = static_cast<int>(min(static_cast<long long>(kTile), end - start));
    T* tile = staged[buffer];
    const int first = threadIdx.x * G;
    if (first < count) {
      const int valid = min(G, count - first);
      const T* source = in + (start + first) * 7;
      Word<T> group[7];
      if (valid == G && vector_in) {
        const uint4* words = reinterpret_cast<const uint4*>(source);
#pragma unroll
        for (int j = 0; j < 7; ++j) group[j].raw = __ldg(words + j);
      } else {
#pragma unroll
        for (int q = 0; q < 7 * G; ++q) {
          group[q / G].value[q % G] = q < valid * 7 ? __ldg(source + q) : T(0);
        }
      }
      T weight[G];
#pragma unroll
      for (int g = 0; g < G; ++g) weight[g] = g < valid ? __ldg(w + start + first + g) : T(0);

      Word<T> result[7];
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        T row[7];
#pragma unroll
        for (int k = 0; k < 7; ++k) row[k] = map[i * 7 + k];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          T value = row[0] * group[(g * 7) / G].value[(g * 7) % G];
#pragma unroll
          for (int k = 1; k < 7; ++k) {
            value = fma(row[k], group[(g * 7 + k) / G].value[(g * 7 + k) % G], value);
          }
          result[(g * 7 + i) / G].value[(g * 7 + i) % G] = value;
        }
      }

#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < valid) {
          const double wd = static_cast<double>(weight[g]);
#pragma unroll
          for (int i = 0; i < 7; ++i) {
            const double od = static_cast<double>(result[(g * 7 + i) / G].value[(g * 7 + i) % G]);
            const double weighted = wd * od;
            sums[i] += weighted;
            sums[7 + i] = fma(weighted, od, sums[7 + i]);
          }
        }
      }

      uint4* slots = reinterpret_cast<uint4*>(tile + first * 7);
#pragma unroll
      for (int j = 0; j < 7; ++j) slots[j] = result[j].raw;
    }
    __syncthreads();

    // The tile's outgoing particles, contiguous in the output.
    T* destination = target + start * 7;
    const int values = count * 7;
    int done = 0;
    if (aligned16(destination)) {
      const int words = values / G;
      const uint4* from = reinterpret_cast<const uint4*>(tile);
      uint4* to = reinterpret_cast<uint4*>(destination);
      for (int q = threadIdx.x; q < words; q += kThreads) __stcs(to + q, from[q]);
      done = words * G;
    }
    for (int q = done + threadIdx.x; q < values; q += kThreads) __stcs(destination + q, tile[q]);
  }

  // The block's sums: each warp's by shuffles, then the warps' in order.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kSums; ++c) {
    double value = sums[c];
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      value += __shfl_xor_sync(0xffffffffu, value, offset);
    }
    if (lane == 0) warp_sums[warp][c] = value;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    const int c = threadIdx.x;
    double total = warp_sums[0][c];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) total += warp_sums[k][c];
    if (partials != nullptr) {
      partials[block * kSums + c] = total;
    } else {
      (c < 7 ? s1 : s2)[instance * 7 + c % 7] = static_cast<T>(total);
    }
  }
}

// The sums of instances whose particles span several blocks: each of the
// instance's chunks' partial sums, added in the chunks' order.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    transport_sums_kernel(const double* __restrict__ partials, long long chunks,
                          long long instances, T* __restrict__ s1, T* __restrict__ s2) {
  const long long index = static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (index >= instances * kSums) return;
  const long long instance = index / kSums;
  const int c = static_cast<int>(index - instance * kSums);
  const double* partial = partials + instance * chunks * kSums + c;
  double total = 0.0;
  for (long long k = 0; k < chunks; ++k) total += partial[k * kSums];
  (c < 7 ? s1 : s2)[instance * 7 + c % 7] = static_cast<T>(total);
}

template <typename T>
int launch(const void* particles, long long particle_stride, const void* maps,
           long long map_stride, const void* weights, long long weight_stride, long long n,
           long long instances, long long chunk, void* out, void* s1, void* s2, void* partials,
           cudaStream_t stream) {
  constexpr long long kTile = kThreads * (16 / sizeof(T));
  if (n < 1 || instances < 1 || chunk < 1 || chunk % kTile != 0) return cudaErrorInvalidValue;
  const long long chunks = (n + chunk - 1) / chunk;
  if ((chunks > 1) != (partials != nullptr) || instances > LLONG_MAX / chunks ||
      instances * chunks > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  transport_moments_kernel<T><<<static_cast<unsigned>(instances * chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(particles), particle_stride, static_cast<const T*>(maps), map_stride,
      static_cast<const T*>(weights), weight_stride, n, chunk, chunks, static_cast<T*>(out),
      static_cast<T*>(s1), static_cast<T*>(s2), static_cast<double*>(partials));
  if (chunks > 1) {
    const cudaError_t status = cudaGetLastError();
    if (status != cudaSuccess) return status;
    const long long blocks = (instances * kSums + kSumThreads - 1) / kSumThreads;
    transport_sums_kernel<T><<<static_cast<unsigned>(blocks), kSumThreads, 0, stream>>>(
        static_cast<const double*>(partials), chunks, instances, static_cast<T*>(s1),
        static_cast<T*>(s2));
  }
  return cudaGetLastError();
}

}  // namespace transport

extern "C" {

// particles (instances at particle_stride, (n, 7) contiguous each), maps
// (at map_stride, (7, 7) each), weights (at weight_stride, n each); out
// (instances, n, 7), s1 and s2 (instances, 7), contiguous; chunk: the
// particles a block takes, a multiple of its tile; partials: 14 float64 a
// block where an instance spans several chunks, else null.
int transport_moments_f32(const void* particles, long long particle_stride, const void* maps,
                          long long map_stride, const void* weights, long long weight_stride,
                          long long n, long long instances, long long chunk, void* out, void* s1,
                          void* s2, void* partials, void* stream) {
  return transport::launch<float>(particles, particle_stride, maps, map_stride, weights,
                                  weight_stride, n, instances, chunk, out, s1, s2, partials,
                                  static_cast<cudaStream_t>(stream));
}

int transport_moments_f64(const void* particles, long long particle_stride, const void* maps,
                          long long map_stride, const void* weights, long long weight_stride,
                          long long n, long long instances, long long chunk, void* out, void* s1,
                          void* s2, void* partials, void* stream) {
  return transport::launch<double>(particles, particle_stride, maps, map_stride, weights,
                                   weight_stride, n, instances, chunk, out, s1, s2, partials,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
