// K2: gather-fused, multi-metric per-block popcount of a OP b.
//
// Replaces count_op_pallas (bitmagic_tpu/ops/pallas_kernels.py:119-137,
// body _count_body :100-115) and, on the card, the XLA fusion
// _metric_kernel (bitmagic_tpu/algo/setops.py:39-67) that
// distance_operation runs.  The result rows are never written: the output
// is the per-block counts int32[n_metrics, k], their int64 totals
// int64[n_metrics], or both.  Bound: reading both operands' 8 KiB rows
// (rows that are FULL or absent are not read at all).  Design: one CTA of
// 256 threads per aligned block, K3's shape for two operands
// (block_counts.cu).  In each warp, lanes 0-5 read the six descriptor words
// of the block (aux slot, FULL flag, pool slot of each operand) in one
// round trip and shuffles broadcast them, so the branch on each source is
// uniform; each thread then issues its two 16-byte loads of each operand
// together, allocating no L1 line.  The counted metrics are reduced per
// warp with __reduce_add_sync and across the eight warps through shared
// memory; the totals leave with one 64-bit atomicAdd per block and metric
// into counters the launcher zeroes on the same stream.
//
// Popcounts: the caller (blockops.count_plan) names at most three metrics
// to count (codes of setops.py:25-36): the requested metrics themselves
// or, when fewer, the base counts |a&b|, |a| and |b| they follow from.
// Each requested metric is then a combination of the counted ones with
// small integer coefficients (the recipe), exact per block in 32 bits
// (counts <= 65536): or = a + b - and, xor = a + b - 2 and, sub_ab = a -
// and, sub_ba = b - and.  So the seven metrics of distance_operation take
// three popcounts per word pair and count_and one; the kernel is
// instantiated for one, two and three counted metrics, so only their
// counters occupy registers.
#include "bm_common.cuh"

namespace {

constexpr int kMaxCounted = 3;
constexpr int kMetrics = 7;

// metric codes: the index in blockops.METRICS
template <int C>
__device__ __forceinline__ uint32_t metric_popc(uint4 a, uint4 b) {
  if constexpr (C == 0) {
    return bm::popc4(make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w));
  } else if constexpr (C == 1) {
    return bm::popc4(make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w));
  } else if constexpr (C == 2) {
    return bm::popc4(make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w));
  } else if constexpr (C == 3) {
    return bm::popc4(
        make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w));
  } else if constexpr (C == 4) {
    return bm::popc4(
        make_uint4(b.x & ~a.x, b.y & ~a.y, b.z & ~a.z, b.w & ~a.w));
  } else if constexpr (C == 5) {
    return bm::popc4(a);
  } else {
    return bm::popc4(b);
  }
}

template <int C>
__device__ __forceinline__ uint32_t row_popc(
    const uint4 (&x)[bm::kVecPerThread], const uint4 (&y)[bm::kVecPerThread]) {
  uint32_t c = 0u;
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) c += metric_popc<C>(x[j], y[j]);
  return c;
}

// This thread's popcounts of the N counted metrics (codes 3 bits each in
// `counted`); the branch on a code is uniform and outside the words.
template <int N>
__device__ __forceinline__ void count_row(
    const uint4 (&x)[bm::kVecPerThread], const uint4 (&y)[bm::kVecPerThread],
    uint32_t counted, uint32_t (&cnt)[N]) {
#pragma unroll
  for (int s = 0; s < N; ++s) {
    switch ((counted >> (3 * s)) & 7u) {
      case 0: cnt[s] = row_popc<0>(x, y); break;
      case 1: cnt[s] = row_popc<1>(x, y); break;
      case 2: cnt[s] = row_popc<2>(x, y); break;
      case 3: cnt[s] = row_popc<3>(x, y); break;
      case 4: cnt[s] = row_popc<4>(x, y); break;
      case 5: cnt[s] = row_popc<5>(x, y); break;
      default: cnt[s] = row_popc<6>(x, y); break;
    }
  }
}

template <int N>
__global__ void __launch_bounds__(bm::kThreads)
count_metrics_kernel(bm::Operand a, bm::Operand b, uint32_t counted,
                     int n_metrics, unsigned long long recipe, int k,
                     int32_t* __restrict__ out,
                     unsigned long long* __restrict__ total) {
  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31;
  bm::RowSrc sa, sb;
  bm::warp_sources(a, b, bm::desc_word(a, b, i, lane), sa, sb);
  uint4 x[bm::kVecPerThread], y[bm::kVecPerThread];
  bm::load_row(x, sa);
  bm::load_row(y, sb);
  uint32_t cnt[N];
  count_row(x, y, counted, cnt);
  __shared__ uint32_t part[bm::kWarps][N];
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const uint32_t c = __reduce_add_sync(0xFFFFFFFFu, cnt[s]);
    if (lane == 0) part[threadIdx.x >> 5][s] = c;
  }
  __syncthreads();
  const int j = static_cast<int>(threadIdx.x);
  if (j < n_metrics) {
    // metric j: its coefficients over the counted metrics, 3 bits each
    // biased by 4
    const uint32_t coef = static_cast<uint32_t>(recipe >> (9 * j)) & 0x1FFu;
    int32_t v = 0;
#pragma unroll
    for (int s = 0; s < N; ++s) {
      uint32_t t = 0u;
#pragma unroll
      for (int w = 0; w < bm::kWarps; ++w) t += part[w][s];
      v += (static_cast<int32_t>((coef >> (3 * s)) & 7u) - 4) *
           static_cast<int32_t>(t);
    }
    if (out != nullptr) out[static_cast<size_t>(j) * k + i] = v;
    if (total != nullptr) {
      atomicAdd(total + j, static_cast<unsigned long long>(v));
    }
  }
}

template <int N>
void launch(const bm::Operand& a, const bm::Operand& b, uint32_t counted,
            int n_metrics, unsigned long long recipe, int k, int32_t* out,
            unsigned long long* total, cudaStream_t st) {
  count_metrics_kernel<N><<<k, bm::kThreads, 0, st>>>(
      a, b, counted, n_metrics, recipe, k, out, total);
}

}  // namespace

// counted: the codes of the n_counted (1..3) metrics popcounted, 3 bits
// each (metric s at bits 3s..3s+2); recipe: for each output metric j <
// n_metrics (1..7), its coefficients over the counted metrics, 3 bits each
// biased by 4, at bits 9j + 3s.  out: int32[n_metrics, k] or null; total:
// int64[n_metrics], zeroed here on the stream and then summed into, or
// null; not both null.  Returns the CUDA error of the launch (0 =
// launched).  k >= 1.
extern "C" int bm_count_metrics(
    const void* a_pool, int a_pool_rows, const void* a_slot,
    const void* a_full, const void* a_aux, int a_aux_rows,
    const void* a_aux_slot,
    const void* b_pool, int b_pool_rows, const void* b_slot,
    const void* b_full, const void* b_aux, int b_aux_rows,
    const void* b_aux_slot,
    int n_counted, int counted, int n_metrics, unsigned long long recipe,
    int k, void* out, void* total, void* stream) {
  if (k <= 0 || n_counted < 1 || n_counted > kMaxCounted ||
      n_metrics < 1 || n_metrics > kMetrics ||
      (out == nullptr && total == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total != nullptr) {
    const cudaError_t e = cudaMemsetAsync(total, 0, 8 * n_metrics, st);
    if (e != cudaSuccess) return static_cast<int>(e);
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
  const uint32_t c = static_cast<uint32_t>(counted);
  int32_t* o = static_cast<int32_t*>(out);
  auto* t = static_cast<unsigned long long*>(total);
  if (n_counted == 1) {
    launch<1>(a, b, c, n_metrics, recipe, k, o, t, st);
  } else if (n_counted == 2) {
    launch<2>(a, b, c, n_metrics, recipe, k, o, t, st);
  } else {
    launch<3>(a, b, c, n_metrics, recipe, k, o, t, st);
  }
  return static_cast<int>(cudaGetLastError());
}
