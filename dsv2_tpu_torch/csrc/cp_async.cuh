// Asynchronous 16-byte copies from device memory into shared memory for
// csrc/probe_gang.cu (Ampere's cp.async, on Hopper too).
//
// `copy16` copies 16 bytes (both addresses 16-byte aligned) and fills the
// rest of the 16 with zeros when `bytes` < 16; `commit` closes the
// thread's current group of copies; `wait1` waits until at most the last
// group committed is still in flight. A copy is visible to the thread
// that made it after the wait, and to the other lanes of its warp after a
// __syncwarp.
//
// The host build of the tests (tests/test_torch_probe_gang.py) replaces
// this header with plain copies; nothing else in probe_gang.cu differs
// between the two builds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cpa {

__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

}  // namespace cpa
