// Warp-level helpers of the kernels that give a scenario several lanes or
// warps (riccati_mid.cu, riccati_kernel.cuh, riccati_small.cuh,
// rollout.cuh): asynchronous copies into shared memory (one a thread, or in
// bulk with a barrier object), a named barrier over a team, and warp
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

// A shared-memory barrier object (mbarrier) and bulk copies (the TMA's
// one-instruction copy of contiguous bytes into shared memory, completion
// counted on the barrier in bytes).
__device__ __forceinline__ unsigned shared_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Initialize the barrier for ``count`` arrivals a phase (one thread).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on the barrier and expect ``bytes`` of bulk copies this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(shared_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Copy ``bytes`` (a multiple of 16, both ends 16-byte aligned) from device
// to shared memory, counted on ``bar`` when they land.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(shared_u32(bar))
      : "memory");
}

// Wait until the barrier's phase of parity ``phase`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  const unsigned a = shared_u32(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(phase)
        : "memory");
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
