// Bulk asynchronous copies and mbarriers for csrc/vk_chain.cu (Hopper).
//
// `bulk_load` copies a contiguous run of bytes from device memory into
// shared memory through the Tensor Memory Accelerator and completes on an
// mbarrier in shared memory (the barrier's transaction count falls by the
// bytes as they land). Sizes are multiples of 16 bytes and both addresses
// 16-byte aligned. A barrier's phase completes when all its expected arrivals
// have arrived and all the bytes announced with `bar_expect` have landed;
// `bar_wait(bar, k & 1)` waits for its k-th completion.
//
// The host build of the tests (tests/test_torch_vk_host.py) replaces this
// header with plain copies and a barrier; nothing else in vk_chain.cu
// differs between the two builds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vka {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

// after every bar_init, before any other thread uses the barriers
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar))
               : "memory");
}

// one arrival that also announces `bytes` of bulk loads on this phase
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   saddr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

}  // namespace vka
