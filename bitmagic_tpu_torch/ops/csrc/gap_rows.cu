// gap_expand and gap_compress: D-GAP blocks to dense rows and back.
//
// No TPU kernel: the JAX package expands GAP operands on the host and
// merges GAP x GAP block pairs in the run domain in host numpy
// (bitmagic_tpu/core/gapstore.py gap_binary_op :313, gap_metric_counts
// :375).  The port runs those pairs through K1 and K2 with the rest: GAP
// operands become rows on the card (gap_expand) and the results that stay
// D-GAP are re-encoded there (gap_compress), bit-identical to
// GapStore.from_dense.
//
// A store's device mirror (core/gapstore.py GapStore.device_arrays) is
//   ends  int32[total]  inclusive last bit of each run; per block strictly
//                       increasing and ending with 65535
//   offs  int32[m + 1]  block b's runs are ends[offs[b] .. offs[b + 1])
//   first uint8[m]      bit value of block b's first run (runs alternate)
//
// gap_expand: one CTA of 256 threads per selected block.  A thread owns 8
// consecutive words (256 bits): it binary-searches the block's ends for
// the run holding its first bit, walks forward run by run filling spans
// of its words, and stores them as two 16-byte vectors.  Bound: the 8 KiB
// written per row (the ends read are 4 B per run).
//
// gap_compress: two passes of one CTA per row, the rows read once each.
// A transition word t = w ^ ((w >> 1) | (next word << 31)) has bit b set
// where bit b differs from the bit after it, i.e. where a run ends.  The
// count pass popcounts them (the row's run count less one) and records
// bit 0; the caller scans the counts into offs; the write pass takes each
// thread's offset from a scan over the CTA and writes its transitions'
// positions in order, the last thread the closing end 65535.  Bound: the
// 8 KiB read per row and the 4 B written per run end.
#include "bm_common.cuh"

namespace {

constexpr int kWordsPerThread = bm::kBlockWords / bm::kThreads;   // 8
constexpr int kBitsPerThread = kWordsPerThread * 32;               // 256
constexpr int kLastBit = bm::kBlockWords * 32 - 1;                 // 65535

// Bits lo..hi of a word, 0 <= lo <= hi <= 31.
__device__ __forceinline__ uint32_t span_mask(int lo, int hi) {
  return static_cast<uint32_t>((2ull << hi) - (1ull << lo));
}

__global__ void __launch_bounds__(bm::kThreads)
gap_expand_kernel(const int32_t* __restrict__ ends,
                  const int32_t* __restrict__ offs,
                  const uint8_t* __restrict__ first,
                  const int32_t* __restrict__ sel, uint4* __restrict__ out) {
  const int blk = sel[blockIdx.x];
  const int r0 = offs[blk];
  const int bit0 = threadIdx.x * kBitsPerThread;
  // the run holding bit0: the first whose end is >= bit0 (the block's last
  // run ends at 65535, so the search stays inside the block)
  int lo = r0;
  int hi = offs[blk + 1] - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ends + mid) < bit0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int r = lo;
  int e = __ldg(ends + r);
  uint32_t val = (static_cast<uint32_t>(first[blk]) ^
                  static_cast<uint32_t>(r - r0)) & 1u;
  uint32_t w[kWordsPerThread];
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) {
    const int wb = bit0 + 32 * j;
    const int wl = wb + 31;
    if (e < wb) {          // the run ended on the last bit of the word before
      e = __ldg(ends + ++r);
      val ^= 1u;
    }
    uint32_t word = 0u;
    int p = wb;
    while (e < wl) {       // runs that end inside this word (e < 65535)
      if (val) word |= span_mask(p - wb, e - wb);
      p = e + 1;
      e = __ldg(ends + ++r);
      val ^= 1u;
    }
    if (val) word |= span_mask(p - wb, 31);
    w[j] = word;
  }
  uint4* dst = out + static_cast<size_t>(blockIdx.x) * bm::kBlockVec +
               2 * threadIdx.x;
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// This thread's transition words of row ``row``; ``head`` (shared, one
// word per thread) passes each thread's first word to the thread before.
__device__ __forceinline__ void transitions(const uint4* __restrict__ row,
                                            uint32_t* head,
                                            uint32_t (&t)[kWordsPerThread]) {
  const uint4 v0 = bm::load_once(row + 2 * threadIdx.x);
  const uint4 v1 = bm::load_once(row + 2 * threadIdx.x + 1);
  const uint32_t w[kWordsPerThread] = {v0.x, v0.y, v0.z, v0.w,
                                       v1.x, v1.y, v1.z, v1.w};
  head[threadIdx.x] = v0.x;
  __syncthreads();
  const bool last = threadIdx.x == bm::kThreads - 1;
  const uint32_t next = last ? 0u : head[threadIdx.x + 1];
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) {
    const uint32_t after = j + 1 < kWordsPerThread ? w[j + 1] : next;
    t[j] = w[j] ^ ((w[j] >> 1) | (after << 31));
  }
  // bit 65535 has no bit after it: it closes the last run
  if (last) t[kWordsPerThread - 1] &= 0x7FFFFFFFu;
}

__global__ void __launch_bounds__(bm::kThreads)
gap_count_kernel(const uint4* __restrict__ rows, int32_t* __restrict__ counts,
                 uint8_t* __restrict__ first) {
  __shared__ uint32_t head[bm::kThreads];
  __shared__ uint32_t part[bm::kWarps];
  uint32_t t[kWordsPerThread];
  transitions(rows + static_cast<size_t>(blockIdx.x) * bm::kBlockVec, head,
              t);
  uint32_t c = 0u;
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) c += __popc(t[j]);
  c = __reduce_add_sync(0xFFFFFFFFu, c);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0u;
#pragma unroll
    for (int i = 0; i < bm::kWarps; ++i) s += part[i];
    counts[blockIdx.x] = static_cast<int32_t>(s);
    first[blockIdx.x] = static_cast<uint8_t>(head[0] & 1u);
  }
}

__global__ void __launch_bounds__(bm::kThreads)
gap_write_kernel(const uint4* __restrict__ rows,
                 const int32_t* __restrict__ offs,
                 int32_t* __restrict__ ends) {
  __shared__ uint32_t head[bm::kThreads];
  __shared__ int part[bm::kWarps];
  uint32_t t[kWordsPerThread];
  transitions(rows + static_cast<size_t>(blockIdx.x) * bm::kBlockVec, head,
              t);
  int c = 0;
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) c += __popc(t[j]);
  // this thread's offset: an inclusive scan in the warp, then the warps
  // before it
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  int at = offs[blockIdx.x] + incl - c;
  for (int i = 0; i < warp; ++i) at += part[i];
  const int bit0 = threadIdx.x * kBitsPerThread;
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) {
    uint32_t x = t[j];
    while (x) {
      ends[at++] = bit0 + 32 * j + __ffs(x) - 1;
      x &= x - 1u;
    }
  }
  if (threadIdx.x == bm::kThreads - 1) {
    ends[offs[blockIdx.x + 1] - 1] = kLastBit;
  }
}

}  // namespace

// out int32[k, 2048]: row i = block sel[i] of the mirror (ends, offs,
// first).  Returns the CUDA error of the launch (0 = launched).  k >= 1.
extern "C" int bm_gap_expand(const void* ends, const void* offs,
                             const void* first, const void* sel, int k,
                             void* out, void* stream) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  gap_expand_kernel<<<k, bm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ends), static_cast<const int32_t*>(offs),
      static_cast<const uint8_t*>(first), static_cast<const int32_t*>(sel),
      static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The count pass over rows int32[n, 2048]: counts int32[n] (run ends
// before 65535 per row), first uint8[n] (bit 0 per row).  n >= 1.
extern "C" int bm_gap_count(const void* rows, int n, void* counts,
                            void* first, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  gap_count_kernel<<<n, bm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), static_cast<int32_t*>(counts),
      static_cast<uint8_t*>(first));
  return static_cast<int>(cudaGetLastError());
}

// The write pass: ends int32[offs[n]] from offs int32[n + 1], offs[i + 1]
// - offs[i] = counts[i] + 1.  n >= 1.
extern "C" int bm_gap_write(const void* rows, int n, const void* offs,
                            void* ends, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  gap_write_kernel<<<n, bm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), static_cast<const int32_t*>(offs),
      static_cast<int32_t*>(ends));
  return static_cast<int>(cudaGetLastError());
}
