// K3: per-block popcount, int32[n] from a pool int32[n, 2048].
//
// Replaces block_counts_pallas (bitmagic_tpu/ops/pallas_kernels.py:146-161,
// body _popcount_body :140-143).  Bound: the 8 KiB read of each row (the
// 4-byte count written per row is 1/2048 of that).  Design: one CTA per
// row, two 16-byte loads per thread, __popc, a warp reduction with
// __reduce_add_sync and the eight warp sums through shared memory.  The
// TPU kernel's 8-row tiles and sequential grid become 132 SMs each running
// many independent one-row CTAs.
#include "bm_common.cuh"

namespace {

__global__ void __launch_bounds__(bm::kThreads)
block_counts_kernel(const uint4* __restrict__ pool, int32_t* __restrict__ out) {
  const uint4* row = pool + static_cast<size_t>(blockIdx.x) * bm::kBlockVec;
  uint32_t c[1] = {0u};
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) {
    c[0] += bm::popc4(__ldg(row + threadIdx.x + j * bm::kThreads));
  }
  __shared__ uint32_t total[1];
  bm::block_sum(c, total);
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<int32_t>(total[0]);
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched).  n >= 1.
extern "C" int bm_block_counts(const void* pool, int n, void* out,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  block_counts_kernel<<<n, bm::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
