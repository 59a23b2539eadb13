// B8: the Bitap chain of combine_shift_right_and in one launch.
//
// Replaces the JAX package's jitted _shift_and_chain
// (bitmagic_tpu/agg/aggregator.py:117, an XLA lax.scan called from
// combine_shift_right_and :558), which the port ran as eager PyTorch: a
// gather, a shift, a mask and an AND per operand, ~466 kernels a call at
// 32 operands.  The chain is acc = rows_0, then acc = shift_up1(acc) &
// rows_j over the block list's rows as one flat bit string, where
// first_mask[b] with bit 0 clear stops the carry into block b (its list
// predecessor is not its address predecessor).  Its closed form, which
// this kernel computes: with k operands, flat bit p of the result is
//   AND over j of rows_j[p - s_j],  s_j = k - 1 - j,
// where a source bit that lies before the run of adjacent blocks holding
// p (before the list, or across a block whose first_mask marks it) reads
// 0.  Every term is independent of the others: no step waits on the one
// before, and the AND may take the operands in any order.
//
// Operands arrive as B4's do: K gather descriptors (pool, slot, full,
// aux, aux_slot) of bm_common.cuh in one device table.  An absent row
// reads 0 and a FULL row ones, without a load.
//
// Bound on this card: the bytes, every distinct operand row read once
// (operands that repeat a vector, a pattern's repeated letter, share its
// rows) and the result written once (config 1's 32-letter pattern: 4
// vectors, 62.9 MB, 0.0188 ms); the slices' early exit leaves less to
// read (51.1 MB there).  Each operand loads its own words, so a repeated
// vector's rows are read again from L2.  Design:
//  - A CTA of 4 warps owns 512 words of one output row (4 CTAs a row); a
//    warp owns a 128-word slice, a lane its words l, l + 32, l + 64 and
//    l + 96, so each of the warp's loads is 128 contiguous bytes, offset
//    by the shift.  For operand j with s = 32 q + r, word x of the result
//    takes (src[x - q] << r) | (src[x - q - 1] >> (32 - r)): the word
//    before comes from the next lower lane by a shuffle (lane 0's from
//    lane 31 of the word 32 lower, and for the slice's first word one
//    more load by lane 0).  The sources of a CTA's words span at most two
//    list blocks (q <= 65536 / 32 reaches one block back; a longer chain
//    takes a contiguous block range, where the rows are read further
//    back the same way).
//  - The CTA resolves the descriptors of 64 operands at once, a thread
//    per (operand, source block), into shared memory; the run start of
//    its row (the lowest word a source may come from) is walked once from
//    first_mask by the last thread, beside the first chunk's loads.
//  - The slice stops reading at zero, as B4's sweep does: a vote per
//    group of 4 operands (16 loads a lane in flight), none ahead of it.
//  - Indices stay relative to the output row, so no 64-bit flat index is
//    needed however long the list.
#include "bm_common.cuh"

namespace {

constexpr int kWarpsPerCta = 4;
constexpr int kCtaThreads = 32 * kWarpsPerCta;                // 128
constexpr int kSliceWords = 128;                              // a warp's
constexpr int kCtaWords = kSliceWords * kWarpsPerCta;         // 512
constexpr int kCtasPerRow = bm::kBlockWords / kCtaWords;      // 4
constexpr int kRowShift = 11;                                 // 2048 words
constexpr int kChunk = kCtaThreads / 2;   // operands resolved at once
constexpr int kGroup = 4;                 // operands per early-exit vote
constexpr unsigned kAll = 0xFFFFFFFFu;

// One operand's source words for the CTA: its rows at two consecutive
// list blocks (a pointer, or nullptr and a fill word, each).
struct Pair {
  const uint32_t* p0;
  const uint32_t* p1;
  uint32_t f0, f1;
};

// Word ``y`` (relative to the output row's first word) of an operand
// whose two source rows start at row-relative word ``base``; 0 before
// ``lo``, the first word of the row's run of adjacent blocks.
__device__ __forceinline__ uint32_t src_word(const Pair& s, int base, int lo,
                                             int y) {
  if (y < lo) return 0u;
  const int rel = y - base;                 // 0 .. 2559
  const bool hi = rel >= bm::kBlockWords;
  const uint32_t* p = hi ? s.p1 : s.p0;
  return p != nullptr ? __ldg(p + (hi ? rel - bm::kBlockWords : rel))
                      : (hi ? s.f1 : s.f0);
}

__global__ void __launch_bounds__(kCtaThreads)
shift_and_chain_kernel(const bm::Operand* __restrict__ ops, int k,
                       const int32_t* __restrict__ first_mask, int n,
                       uint32_t* __restrict__ out) {
  __shared__ const uint32_t* s_ptr[kChunk][2];
  __shared__ uint32_t s_fill[kChunk][2];
  __shared__ int s_lo;
  const int b = blockIdx.x / kCtasPerRow;
  const int c0 = (blockIdx.x % kCtasPerRow) * kCtaWords;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w0 = c0 + warp * kSliceWords + lane;   // this lane's first word
  uint32_t acc[4] = {kAll, kAll, kAll, kAll};
  bool alive = true;
  for (int j0 = 0;;) {
    // resolve the chunk's descriptors
    {
      const int jj = threadIdx.x >> 1;
      const int h = threadIdx.x & 1;
      const int j = j0 + jj;
      const uint32_t* ptr = nullptr;
      uint32_t fill = 0u;
      if (j < k) {
        const int q = (k - 1 - j) >> 5;
        const int blk = b + ((c0 - q - 1) >> kRowShift) + h;
        if (blk >= 0 && blk < n) {
          const bm::RowSrc s = bm::resolve(ops[j], blk);
          ptr = reinterpret_cast<const uint32_t*>(s.ptr);
          fill = s.fill;
        }
      }
      s_ptr[jj][h] = ptr;
      s_fill[jj][h] = fill;
    }
    if (j0 == 0 && threadIdx.x == kCtaThreads - 1) {
      // the run start: walk first_mask back from the row to the block of
      // the deepest source word (by the last thread, whose operand slot
      // is empty for k < 64, so the walk overlaps the others' loads)
      const long long deep = static_cast<long long>(c0) - ((k - 1) >> 5) - 1;
      long long lowest = static_cast<long long>(b) +
                         (deep >= 0 ? 0 : -((-deep + bm::kBlockWords - 1) >>
                                            kRowShift));
      if (lowest < 0) lowest = 0;
      int lb = b;
      while (lb > lowest && (__ldg(first_mask + lb) & 1)) --lb;
      s_lo = (lb - b) * bm::kBlockWords;
    }
    __syncthreads();
    const int lo = s_lo;
    const int jn = min(kChunk, k - j0);
    for (int g = 0; alive && g < jn; g += kGroup) {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int jj = g + i;
        if (jj >= jn) break;
        const int s = k - 1 - (j0 + jj);
        const int q = s >> 5;
        const int r = s & 31;
        const int base = ((c0 - q - 1) >> kRowShift) * bm::kBlockWords;
        const Pair src{s_ptr[jj][0], s_ptr[jj][1], s_fill[jj][0],
                       s_fill[jj][1]};
        uint32_t v[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          v[m] = src_word(src, base, lo, w0 + 32 * m - q);
        }
        const uint32_t edge =
            lane == 0 && r ? src_word(src, base, lo, w0 - q - 1) : 0u;
        if (r == 0) {
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[m] &= v[m];
          continue;
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          uint32_t prev = __shfl_up_sync(kAll, v[m], 1);
          const uint32_t top = __shfl_sync(kAll, v[m > 0 ? m - 1 : 0], 31);
          if (lane == 0) prev = m > 0 ? top : edge;
          acc[m] &= (v[m] << r) | (prev >> (32 - r));
        }
      }
      alive = __any_sync(kAll, (acc[0] | acc[1] | acc[2] | acc[3]) != 0u);
    }
    j0 += kChunk;
    // every warp is done with the chunk's table before the next is
    // resolved; none goes on when all are dead
    if (j0 >= k || !__syncthreads_or(alive)) break;
  }
  uint32_t* row = out + (static_cast<size_t>(b) << kRowShift);
#pragma unroll
  for (int m = 0; m < 4; ++m) row[w0 + 32 * m] = acc[m];
}

}  // namespace

// out int32[n, 2048]: the chain over the k descriptors ``ops`` (a device
// table of bm::Operand, agg_sub.cu's layout) aligned on n list blocks,
// ``first_mask`` int32[n].  Returns the CUDA error of the launch (0 =
// launched).  k >= 1, n >= 1.
extern "C" int bm_shift_and_chain(const void* ops, int k,
                                  const void* first_mask, int n, void* out,
                                  void* stream) {
  if (k <= 0 || n <= 0 || n > (1 << 29)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  shift_and_chain_kernel<<<n * kCtasPerRow, kCtaThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bm::Operand*>(ops), k,
      static_cast<const int32_t*>(first_mask), n,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
