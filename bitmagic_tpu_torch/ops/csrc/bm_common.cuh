// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// A block row is 2048 32-bit words = 8 KiB = 512 16-byte vectors.  K1-K3
// and B6 give one CTA of 256 threads to one row: each thread moves two
// 16-byte vectors, neighbouring threads on neighbouring addresses, so a
// warp's load is 512 contiguous bytes.  They read each input byte once and
// write each output byte once; they are bound by device memory bandwidth,
// not by the popcount / logic instructions.  B4 and B5 cut rows
// differently (agg_sub.cu, pipeline_counts.cu).
//
// Words arrive as the int32 storage of PyTorch tensors and are treated as
// uint32_t: the bits are the reference's uint32 words.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bm {

constexpr int kBlockWords = 2048;                     // words per block row
constexpr int kBlockVec = kBlockWords / 4;            // uint4 per row: 512
constexpr int kThreads = 256;                         // CTA size
constexpr int kVecPerThread = kBlockVec / kThreads;   // 2
constexpr int kWarps = kThreads / 32;                 // 8
constexpr int kBlockWaves = 64;                       // 32-word waves per row

// One operand of a binary op: the gather descriptor
// (pool, slot, full, aux, aux_slot) of core/blocks.operand_args.
//   row i = aux[aux_slot[i]]      if aux_slot[i] >= 0 (expanded GAP block)
//         = all ones              else if full[i]
//         = pool[slot[i]]         else if slot[i] >= 0
//         = zero                  otherwise
// slot == nullptr means the aligned form: row i of the pool.
struct Operand {
  const uint4* pool;
  int pool_rows;
  const int32_t* slot;
  const uint8_t* full;
  const uint4* aux;
  int aux_rows;
  const int32_t* aux_slot;
};

// Where row i comes from: a row in memory, or a constant fill word.
struct RowSrc {
  const uint4* ptr;
  uint32_t fill;
};

// Resolved once per row by every thread of the CTA (one broadcast read of
// the descriptor), so the branch on the source is uniform in the CTA.  The
// aux-slot, FULL and slot reads are issued together: one round trip after
// the descriptor, not up to three in a row.
__device__ __forceinline__ RowSrc resolve(const Operand& o, int i) {
  const int ar = o.aux_rows > 0 && o.aux_slot != nullptr ? o.aux_slot[i] : -1;
  const bool full = o.full != nullptr && o.full[i] != 0;
  const int r = o.slot != nullptr ? o.slot[i] : i;
  RowSrc s{nullptr, 0u};
  if (ar >= 0) {
    s.ptr = o.aux + static_cast<size_t>(ar) * kBlockVec;
  } else if (full) {
    s.fill = 0xFFFFFFFFu;
  } else if (r >= 0 && o.pool_rows > 0) {
    s.ptr = o.pool + static_cast<size_t>(r) * kBlockVec;
  }
  return s;
}

__device__ __forceinline__ uint4 load(const RowSrc& s, int v) {
  if (s.ptr != nullptr) return __ldg(s.ptr + v);
  return make_uint4(s.fill, s.fill, s.fill, s.fill);
}

__device__ __forceinline__ uint32_t popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// Sum N per-thread counters over the CTA: a warp reduction, then the eight
// warp partials through shared memory.  total (shared, N entries) holds the
// sums for every thread on return.
template <int N>
__device__ __forceinline__ void block_sum(const uint32_t (&v)[N],
                                          uint32_t* total) {
  __shared__ uint32_t part[kWarps][N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint32_t s = __reduce_add_sync(0xFFFFFFFFu, v[n]);
    if (lane == 0) part[warp][n] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const uint32_t s = __reduce_add_sync(
          0xFFFFFFFFu, lane < kWarps ? part[lane][n] : 0u);
      if (lane == 0) total[n] = s;
    }
  }
  __syncthreads();
}

}  // namespace bm
