// Warp-level helpers of the kernels that give a scenario several lanes or
// warps (riccati_mid.cu, riccati_kernel.cuh, rollout.cuh): asynchronous
// copies into shared memory, a named barrier over a team, and warp
// reductions.
#pragma once

#include "common.cuh"

namespace tfmpc {

constexpr unsigned kFullMask = 0xffffffffu;

// Copy kBytes (4, 8 or 16, aligned to it) from device to shared memory
// without holding a register; completes at cp_async_wait_all.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies; a barrier then makes them visible to the
// rest of the team.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most one group of this thread's copies is in flight (the
// latest): the group before it has landed.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until at most ``pending`` (0..7) groups of this thread's copies
// are in flight: the groups committed before them have landed.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Barrier ``id`` (1..15; 0 is __syncthreads') over ``threads`` threads,
// whole warps.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The sum of v over the warp, reduced down to lane 0 and broadcast from
// it, so every lane holds the same bits (a butterfly would leave each lane
// its own rounding, and a branch on the sum could then diverge).
template <typename S>
__device__ __forceinline__ S warp_sum(S v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return __shfl_sync(kFullMask, v, 0);
}

}  // namespace tfmpc
