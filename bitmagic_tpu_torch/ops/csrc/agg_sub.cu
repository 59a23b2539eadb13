// B4: K-way AND-SUB sweep with early exit (the aggregator's device pass).
//
// Replaces agg_and_sub_pallas (bitmagic_tpu/ops/pallas_kernels.py:270-289,
// call :241-267, body _agg_sweep_body :171-238) and, on the card, the XLA
// fusions _agg_kernel / _agg_any_kernel (bitmagic_tpu/agg/aggregator.py:80,
// :108) and the per-request vmap of _pipeline_results_kernel (:875).
//
// Per result column i (one 8 KiB block row):
//   AND/SUB mode: acc = ~0; acc &= row_k (k < n_and); acc &= ~row_k (k >= n_and)
//   OR mode:      acc =  0; acc |= row_k for every k
// Each operand comes as the gather descriptor of bm_common.cuh (pool, slot,
// full, aux, aux_slot) in a device table of n_ops entries, so one kernel
// serves the per-vector descriptors of the aggregator's combine_* calls and
// the arena form (one pool, a slot matrix; an AND operand's slot -1 is
// passed as `full`, a SUB operand's stays zero: the identity rule of
// pallas_kernels.py:221-228).  An absent or FULL row is never read.
//
// Bound: the operand rows read until the column's accumulator is zero, and
// the result rows written.  Design: one CTA per column, the accumulator in
// registers (256 threads x 2 uint4).  The CTA first resolves up to 256
// operand sources at once (one thread each) into shared memory, so the
// descriptor reads are not serialised behind the row loads; it then loads
// four operands' rows before folding them (8 independent 16-byte loads in
// flight per thread) and takes one block-wide vote (__syncthreads_or) per
// four operands: once the column is zero the remaining loads are skipped
// (in OR mode: once it is all ones).  Loads are plain __ldg, so no copy is
// in flight when the CTA leaves (the Pallas body issues copy k+1 before its
// zero test and never waits on it, :210-233).  A 0-row pool is legal: every
// slot must then be -1.  Either output may be omitted: `counts` alone is
// the rows-off form (per-column popcount, _agg_any_kernel).
#include <cstddef>

#include "bm_common.cuh"

static_assert(sizeof(bm::Operand) == 56, "descriptor table: 7 x 8 bytes");
static_assert(offsetof(bm::Operand, pool_rows) == 8, "descriptor layout");
static_assert(offsetof(bm::Operand, slot) == 16, "descriptor layout");
static_assert(offsetof(bm::Operand, full) == 24, "descriptor layout");
static_assert(offsetof(bm::Operand, aux) == 32, "descriptor layout");
static_assert(offsetof(bm::Operand, aux_rows) == 40, "descriptor layout");
static_assert(offsetof(bm::Operand, aux_slot) == 48, "descriptor layout");

namespace {

constexpr int kChunk = bm::kThreads;   // operands resolved per pass
constexpr int kGroup = 4;              // operands folded between two votes

__global__ void __launch_bounds__(bm::kThreads)
agg_sweep_kernel(const bm::Operand* __restrict__ ops, int n_ops, int n_and,
                 int or_mode, uint4* __restrict__ out,
                 int32_t* __restrict__ counts) {
  const int i = blockIdx.x;
  __shared__ bm::RowSrc src[kChunk];
  const uint32_t init = or_mode ? 0u : 0xFFFFFFFFu;
  uint4 acc[bm::kVecPerThread];
#pragma unroll
  for (int v = 0; v < bm::kVecPerThread; ++v) {
    acc[v] = make_uint4(init, init, init, init);
  }
  bool live = true;
  for (int k0 = 0; k0 < n_ops && live; k0 += kChunk) {
    const int n = min(kChunk, n_ops - k0);
    __syncthreads();                    // the previous chunk's src is read
    if (static_cast<int>(threadIdx.x) < n) {
      src[threadIdx.x] = bm::resolve(ops[k0 + threadIdx.x], i);
    }
    __syncthreads();
    for (int j = 0; j < n && live; j += kGroup) {
      uint4 r[kGroup][bm::kVecPerThread];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const bm::RowSrc s = src[min(j + g, n - 1)];
#pragma unroll
        for (int v = 0; v < bm::kVecPerThread; ++v) {
          r[g][v] = bm::load(s, threadIdx.x + v * bm::kThreads);
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (j + g >= n) break;
        const int k = k0 + j + g;
#pragma unroll
        for (int v = 0; v < bm::kVecPerThread; ++v) {
          const uint4 x = r[g][v];
          uint4& a = acc[v];
          if (or_mode) {
            a.x |= x.x; a.y |= x.y; a.z |= x.z; a.w |= x.w;
          } else if (k < n_and) {
            a.x &= x.x; a.y &= x.y; a.z &= x.z; a.w &= x.w;
          } else {
            a.x &= ~x.x; a.y &= ~x.y; a.z &= ~x.z; a.w &= ~x.w;
          }
        }
      }
      int mine = 0;
#pragma unroll
      for (int v = 0; v < bm::kVecPerThread; ++v) {
        const uint4 a = acc[v];
        mine |= or_mode ? ((a.x & a.y & a.z & a.w) != 0xFFFFFFFFu)
                        : ((a.x | a.y | a.z | a.w) != 0u);
      }
      // AND/SUB: go on while some word is nonzero; OR: while some word
      // is not yet all ones
      live = __syncthreads_or(mine) != 0;
    }
  }
  if (out != nullptr) {
#pragma unroll
    for (int v = 0; v < bm::kVecPerThread; ++v) {
      out[static_cast<size_t>(i) * bm::kBlockVec + threadIdx.x +
          v * bm::kThreads] = acc[v];
    }
  }
  if (counts != nullptr) {
    uint32_t c[1] = {0u};
#pragma unroll
    for (int v = 0; v < bm::kVecPerThread; ++v) c[0] += bm::popc4(acc[v]);
    __shared__ uint32_t total[1];
    bm::block_sum(c, total);
    if (threadIdx.x == 0) counts[i] = static_cast<int32_t>(total[0]);
  }
}

}  // namespace

// ops: device table of n_ops bm::Operand descriptors (n_ops >= 1), all
// aligned on k columns (k >= 1).  out: int32[k, 2048] or null; counts:
// int32[k] or null.  Returns the CUDA error of the launch (0 = launched).
extern "C" int bm_agg_and_sub(const void* ops, int n_ops, int n_and,
                              int or_mode, int k, void* out, void* counts,
                              void* stream) {
  if (k <= 0 || n_ops <= 0 || n_and < 0 || n_and > n_ops ||
      (out == nullptr && counts == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  agg_sweep_kernel<<<k, bm::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bm::Operand*>(ops), n_ops, n_and, or_mode,
      static_cast<uint4*>(out), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
