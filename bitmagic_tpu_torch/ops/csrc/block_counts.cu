// K3: per-block popcount of a pool int32[n, 2048]: the counts int32[n],
// their int64 total, or both.
//
// Replaces block_counts_pallas (bitmagic_tpu/ops/pallas_kernels.py:147-161,
// body _popcount_body :140-143).  Bound: the 8 KiB read of each row (the
// 4-byte count written per row is 1/2048 of that).  Design: one CTA of 256
// threads per row, each thread's two 16-byte loads issued together and
// allocating no L1 line (bm::load_once), __popc, a warp reduction with
// __reduce_add_sync and the eight warp sums through shared memory; the
// total leaves with one 64-bit atomicAdd per row into a counter the
// launcher zeroes on the same stream, so a count needs no second kernel.
// The TPU kernel's 8-row tiles and sequential grid become 132 SMs each
// running many independent one-row CTAs.  A warp per row (its 8 KiB in
// flight in registers, or in shared memory through cp.async.bulk) measured
// slower on the H100 at 1024, 1536 and 16384 rows, and the more warps
// share a row the faster the kernel ran (PERF.md, PR 4).
#include "bm_common.cuh"

namespace {

__global__ void __launch_bounds__(bm::kThreads)
block_counts_kernel(const uint4* __restrict__ pool, int32_t* __restrict__ out,
                    unsigned long long* __restrict__ total) {
  const bm::RowSrc s{pool + static_cast<size_t>(blockIdx.x) * bm::kBlockVec,
                     0u};
  uint4 v[bm::kVecPerThread];
  bm::load_row(v, s);
  uint32_t c = 0u;
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) c += bm::popc4(v[j]);
  c = __reduce_add_sync(0xFFFFFFFFu, c);
  __shared__ uint32_t part[bm::kWarps];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0u;
#pragma unroll
    for (int w = 0; w < bm::kWarps; ++w) t += part[w];
    if (out != nullptr) out[blockIdx.x] = static_cast<int32_t>(t);
    if (total != nullptr) atomicAdd(total, static_cast<unsigned long long>(t));
  }
}

}  // namespace

// out: int32[n] per-block counts or null; total: one int64, zeroed here on
// the stream and then summed into, or null; not both null.  Returns the
// CUDA error of the launch (0 = launched).  n >= 1.
extern "C" int bm_block_counts(const void* pool, int n, void* out,
                               void* total, void* stream) {
  if (n <= 0 || (out == nullptr && total == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total != nullptr) {
    const cudaError_t e = cudaMemsetAsync(total, 0, 8, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  block_counts_kernel<<<n, bm::kThreads, 0, st>>>(
      static_cast<const uint4*>(pool), static_cast<int32_t*>(out),
      static_cast<unsigned long long*>(total));
  return static_cast<int>(cudaGetLastError());
}
