// Host stand-in for csrc/async_copy.cuh (see cuda_runtime.h here): with
// EMU_LATE a copy lands at the last wait that lets it land, else at once,
// the two ends of what the card may do.
#pragma once
#include <utility>
#include <vector>

namespace mega {

__device__ __forceinline__ float* ring_base() { return emu_smem; }

#ifndef EMU_LATE
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  *dst = *src;
}
__device__ __forceinline__ void copy_commit() {}
template <int N>
__device__ __forceinline__ void copy_wait() {}
#else
inline thread_local std::vector<std::pair<float*, const float*>> emu_open;
inline thread_local std::vector<std::vector<std::pair<float*, const float*>>>
    emu_groups;
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  emu_open.emplace_back(dst, src);
}
__device__ __forceinline__ void copy_commit() {
  emu_groups.push_back(std::move(emu_open));
  emu_open.clear();
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  while (static_cast<int>(emu_groups.size()) > N) {
    for (auto& c : emu_groups.front()) *c.first = *c.second;
    emu_groups.erase(emu_groups.begin());
  }
}
#endif

}  // namespace mega
