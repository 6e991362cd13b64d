// A host stand-in for the CUDA runtime, for compiling the kernel sources
// with g++ and running them on the CPU (tests/test_torch_k1_refill_emulated.py).
// Each block's threads run as std::threads, one block after another; a
// block's barriers are a std::barrier that a returning thread drops out
// of, as an exited thread stops counting at a barrier on the card. The
// warp intrinsics act on the calling thread alone: every warp is one
// thread wide, which the kernels' results do not depend on.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline float2 make_float2(float x, float y) { return {x, y}; }

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local std::barrier<>* emu_bar = nullptr;
inline thread_local std::atomic<int>* emu_count = nullptr;
inline thread_local float* emu_smem = nullptr;

inline void __syncthreads() { emu_bar->arrive_and_wait(); }
inline int __syncthreads_count(int p) {
  emu_bar->arrive_and_wait();
  if (p) emu_count->fetch_add(1);
  emu_bar->arrive_and_wait();
  const int c = emu_count->load();
  emu_bar->arrive_and_wait();
  if (threadIdx.x == 0) emu_count->store(0);
  return c;
}
inline unsigned __activemask() { return 1u << (threadIdx.x & 31); }
inline bool __any_sync(unsigned, bool p) { return p; }
inline unsigned __ballot_sync(unsigned, bool p) {
  return p ? __activemask() : 0u;
}
inline void __syncwarp(unsigned = 0xffffffffu) {}
template <class T>
inline T __shfl_sync(unsigned, T v, int) { return v; }
inline int __popc(unsigned m) { return __builtin_popcount(m); }
inline int __ffs(unsigned m) { return __builtin_ffs(m); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(p, &old, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct cudaFuncAttributes {
  int numRegs = 0;
  size_t localSizeBytes = 0;
};
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return 0;
}
template <class K>
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  *a = {};
  return 0;
}
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, K,
                                                                 int,
                                                                 size_t) {
  *b = 2;
  return 0;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

// what `kernel<<<grid, block, smem, stream>>>(a)` becomes
template <class Arg>
inline void emu_launch(void (*kernel)(Arg), int grid, int block, int smem,
                       cudaStream_t, Arg a) {
  for (int b = 0; b < grid; ++b) {
    std::vector<float> shared(smem / 4 + 1, NAN);
    std::barrier<> bar(block);
    std::atomic<int> count{0};
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = block;
        gridDim.x = grid;
        emu_bar = &bar;
        emu_count = &count;
        emu_smem = shared.data();
        kernel(a);
        bar.arrive_and_drop();
      });
    for (auto& th : threads) th.join();
  }
}
