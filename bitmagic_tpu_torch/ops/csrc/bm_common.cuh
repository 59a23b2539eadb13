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

// A 16-byte load that allocates no L1 line (ld.global.nc.L1::no_allocate):
// K2 and K3 read each row once, and on the card these loads beat __ldg at
// every row count measured (PERF.md, PR 4).
__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// This thread's kVecPerThread vectors of a row (s is uniform in the CTA).
__device__ __forceinline__ void load_row(uint4 (&v)[kVecPerThread],
                                         const RowSrc& s) {
  if (s.ptr != nullptr) {
#pragma unroll
    for (int j = 0; j < kVecPerThread; ++j) {
      v[j] = load_once(s.ptr + threadIdx.x + j * kThreads);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVecPerThread; ++j) {
      v[j] = make_uint4(s.fill, s.fill, s.fill, s.fill);
    }
  }
}

// The source of a row from its three descriptor words (see resolve): the
// aux slot, the FULL flag and the pool slot.
__device__ __forceinline__ RowSrc row_source(const Operand& o, int ar,
                                             int full, int r) {
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

// One descriptor word of row i for a warp that resolves two operands:
// lanes 0-2 read a's aux slot, FULL flag and pool slot, lanes 3-5 b's, so
// the six reads are one round trip of six loads (resolve has every thread
// load all three); warp_sources broadcasts them.
__device__ __forceinline__ int desc_word(const Operand& a, const Operand& b,
                                         int i, int lane) {
  const bool is_a = lane < 3;
  const int f = is_a ? lane : lane - 3;
  const int32_t* aux_slot = is_a ? a.aux_slot : b.aux_slot;
  const int aux_rows = is_a ? a.aux_rows : b.aux_rows;
  const uint8_t* full = is_a ? a.full : b.full;
  const int32_t* slot = is_a ? a.slot : b.slot;
  if (lane >= 6) return 0;
  if (f == 0) return aux_rows > 0 && aux_slot != nullptr ? aux_slot[i] : -1;
  if (f == 1) return full != nullptr ? full[i] : 0;
  return slot != nullptr ? slot[i] : i;
}

__device__ __forceinline__ void warp_sources(const Operand& a,
                                             const Operand& b, int w,
                                             RowSrc& sa, RowSrc& sb) {
  const unsigned all = 0xFFFFFFFFu;
  sa = row_source(a, __shfl_sync(all, w, 0), __shfl_sync(all, w, 1),
                  __shfl_sync(all, w, 2));
  sb = row_source(b, __shfl_sync(all, w, 3), __shfl_sync(all, w, 4),
                  __shfl_sync(all, w, 5));
}

}  // namespace bm
