// Integer helpers of the motion search's metric (csrc/hme_block.cuh
// quad_metr: the quad average of absolute differences) that the gang cost
// probe (csrc/probe_gang.cu) computes with the same code.
#pragma once

namespace {

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }
__device__ __forceinline__ int uavg4(int a, int b, int c, int d) {
  return (a + b + c + d + 2) >> 2;
}

}  // namespace
