// Asynchronous global -> shared copies for the solve kernel's knot ring
// (solve_mega.cu), the only inline PTX of the kernels.
//
// Each thread copies its own lane's 4-byte words with `cp.async.ca` (a
// warp's 32 copies of one row are consecutive addresses, so the warp's
// request is coalesced), closes a knot's copies with `commit_group`, and
// waits with `wait_group N` until at most N of its latest groups are
// still in flight. Nothing here synchronizes two threads, so a thread
// that leaves the SQP loop early (the per-thread exit) never strands
// another. The kernel's dynamic shared memory is `ring_smem`; the
// launcher sizes it.
#pragma once

namespace mega {

extern __shared__ float ring_smem[];

// the block's dynamic shared memory
__device__ __forceinline__ float* ring_base() { return ring_smem; }

// *dst = *src, asynchronously (dst in shared, src in global memory)
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// close the copies issued since the last commit into one group
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mega
