// K2: gather-fused, multi-metric per-block popcount of a OP b.
//
// Replaces count_op_pallas (bitmagic_tpu/ops/pallas_kernels.py:118-137,
// body _count_body :100-115) and, on the card, the XLA fusion
// _metric_kernel (bitmagic_tpu/algo/setops.py:39-67) that
// distance_operation runs.  The result rows are never written: the output
// is int32[n_metrics, k].  Bound: reading both operands' 8 KiB rows (rows
// that are FULL or absent are not read at all).  Design: one CTA per
// aligned block; each operand's source (pool row, aux row, all ones or
// zero) is resolved once per CTA, so the branch is uniform; two 16-byte
// loads per operand and thread; every requested metric of
// setops.py:25-36 is counted from the same registers in one pass and
// reduced with __reduce_add_sync and shared memory.
#include "bm_common.cuh"

namespace {

constexpr int kMetrics = 7;

// metric codes: the index in blockops.METRICS
__device__ __forceinline__ uint4 metric(int c, uint4 a, uint4 b) {
  switch (c) {
    case 0: return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
    case 1: return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
    case 2: return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
    case 3: return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z,
                              a.w & ~b.w);
    case 4: return make_uint4(b.x & ~a.x, b.y & ~a.y, b.z & ~a.z,
                              b.w & ~a.w);
    case 5: return a;
    default: return b;
  }
}

__global__ void __launch_bounds__(bm::kThreads)
count_metrics_kernel(bm::Operand a, bm::Operand b, uint32_t codes,
                     int n_metrics, int k, int32_t* __restrict__ out) {
  const int i = blockIdx.x;
  const bm::RowSrc sa = bm::resolve(a, i);
  const bm::RowSrc sb = bm::resolve(b, i);
  uint32_t want = 0u;
  for (int j = 0; j < n_metrics; ++j) want |= 1u << ((codes >> (3 * j)) & 7u);
  uint32_t cnt[kMetrics] = {0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int v = 0; v < bm::kVecPerThread; ++v) {
    const int idx = threadIdx.x + v * bm::kThreads;
    const uint4 x = bm::load(sa, idx);
    const uint4 y = bm::load(sb, idx);
#pragma unroll
    for (int c = 0; c < kMetrics; ++c) {
      if (want & (1u << c)) cnt[c] += bm::popc4(metric(c, x, y));
    }
  }
  __shared__ uint32_t total[kMetrics];
  bm::block_sum(cnt, total);
  const int j = static_cast<int>(threadIdx.x);
  if (j < n_metrics) {
    out[static_cast<size_t>(j) * k + i] =
        static_cast<int32_t>(total[(codes >> (3 * j)) & 7u]);
  }
}

}  // namespace

// codes: n_metrics metric codes, 3 bits each (metric j at bits 3j..3j+2).
// Returns the CUDA error of the launch (0 = launched).  k >= 1.
extern "C" int bm_count_metrics(
    const void* a_pool, int a_pool_rows, const void* a_slot,
    const void* a_full, const void* a_aux, int a_aux_rows,
    const void* a_aux_slot,
    const void* b_pool, int b_pool_rows, const void* b_slot,
    const void* b_full, const void* b_aux, int b_aux_rows,
    const void* b_aux_slot,
    int codes, int n_metrics, int k, void* out, void* stream) {
  if (k <= 0 || n_metrics < 1 || n_metrics > kMetrics) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bm::Operand a{static_cast<const uint4*>(a_pool), a_pool_rows,
                      static_cast<const int32_t*>(a_slot),
                      static_cast<const uint8_t*>(a_full),
                      static_cast<const uint4*>(a_aux), a_aux_rows,
                      static_cast<const int32_t*>(a_aux_slot)};
  const bm::Operand b{static_cast<const uint4*>(b_pool), b_pool_rows,
                      static_cast<const int32_t*>(b_slot),
                      static_cast<const uint8_t*>(b_full),
                      static_cast<const uint4*>(b_aux), b_aux_rows,
                      static_cast<const int32_t*>(b_aux_slot)};
  count_metrics_kernel<<<k, bm::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      a, b, static_cast<uint32_t>(codes), n_metrics, k,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
