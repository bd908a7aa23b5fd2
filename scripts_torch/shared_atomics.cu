// Throughput of the shared-memory adds a privatised CIC deposit can use, on
// one card: each of 132 blocks of 512 threads adds 61000 values (7600
// particles x 8 corners, a 32^3 deposit's share of one SM) into a 128 KB
// window, at Gaussian-distributed or uniform cells. Built and run by
// bench_shared_atomics.py; prints one JSON line per kind.
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <cuda_runtime.h>

constexpr int kCells = 32768;
constexpr int kBlocks = 132;
constexpr int kAdds = 61000;

template <int Kind>
__global__ void __launch_bounds__(512, 1) add_kernel(const int* __restrict__ cells, float* out) {
  extern __shared__ unsigned char raw[];
  float* f = reinterpret_cast<float*>(raw);
  int* i32 = reinterpret_cast<int*>(raw);
  for (int i = threadIdx.x; i < kCells; i += blockDim.x) i32[i] = 0;
  __syncthreads();
  const int* c = cells + static_cast<size_t>(blockIdx.x) * kAdds;
  for (int k = threadIdx.x; k < kAdds; k += blockDim.x) {
    const float v = 0.37f * (k & 7);
    if (Kind == 0) atomicAdd(f + c[k], v);                               // compare-and-swap loop
    if (Kind == 1) atomicAdd(i32 + c[k], __float2int_rn(v * 1048576.0f));  // native int add
  }
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = f[c[0]];
}

int main(int argc, char** argv) {
  const bool uniform = argc > 1 && std::strcmp(argv[1], "uniform") == 0;
  static int host[kBlocks * kAdds];
  unsigned s = 12345;
  for (int k = 0; k < kBlocks * kAdds; ++k) {
    int v[3];
    for (int a = 0; a < 3; ++a) {  // a sum of 12 uniforms: near-Gaussian, sigma ~5.5 cells
      int acc = 0;
      for (int q = 0; q < 12; ++q) {
        s = s * 1664525u + 1013904223u;
        acc += (s >> 16) % 11;
      }
      v[a] = (acc - 60) / 3 + 16;
      v[a] = v[a] < 0 ? 0 : (v[a] > 31 ? 31 : v[a]);
    }
    s = s * 1664525u + 1013904223u;
    host[k] = uniform ? static_cast<int>((s >> 8) % kCells) : (v[0] * 32 + v[1]) * 32 + v[2];
  }
  int* cells;
  float* out;
  cudaMalloc(&cells, sizeof(host));
  cudaMalloc(&out, sizeof(float) * kBlocks);
  cudaMemcpy(cells, host, sizeof(host), cudaMemcpyHostToDevice);
  auto run = [&](auto kernel, const char* name) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCells * 4);
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    kernel<<<kBlocks, 512, kCells * 4>>>(cells, out);
    cudaEventRecord(a);
    for (int r = 0; r < 20; ++r) kernel<<<kBlocks, 512, kCells * 4>>>(cells, out);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, a, b);
    const int status = static_cast<int>(cudaGetLastError());
    printf("{\"cells\": \"%s\", \"kind\": \"%s\", \"ms\": %.5f, \"cuda_error\": %d}\n",
           uniform ? "uniform" : "gaussian", name, ms / 20, status);
    return status;
  };
  const int failed = run(add_kernel<0>, "f32_atomicAdd") | run(add_kernel<1>, "s32_fixed_point");
  return failed ? 1 : 0;
}
