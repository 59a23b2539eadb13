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
// gap_expand: one CTA of 128 threads per selected block; one launch
// expands a pair of operands' blocks from their two mirrors (CTA i < k_a:
// mirror a, else mirror b), into one tensor whose first k_a rows are a's.
// The first port had every thread binary-search the block's ends in
// global memory for its first bit, then walk them: a chain of ~12
// dependent L2 loads per thread, which was the launch, not the 8 KiB it
// writes per row.  Now a block's sel, then its offs and first, then its
// ends are read, the ends once and coalesced, and the rest is in shared
// memory: each run end but the last marks the bit after it in an 8 KiB
// transition bitmap (bit 0 too where the first run is ones), and a row's
// bit is the parity of the marks at or below it: a prefix XOR inside each
// word, and a CTA scan of the parities (a ballot per warp).  Any run count
// takes this path: nothing is staged that a block's runs could exceed.
// 128 threads a row let an operand pair's 1536 rows run in one wave (16
// CTAs an SM); thread t owns vectors t, t + 128, t + 256 and t + 384 of
// its row, so each warp store writes 512 contiguous bytes.  Measured
// against a search of the ends staged in shared memory and against 256
// threads a row, and kept (PERF.md).
// Bound: the 8 KiB written per row (the ends read are 4 B per run).
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

// A D-GAP store's device mirror (GapStore.device_arrays).
struct Mirror {
  const int32_t* ends;
  const int32_t* offs;
  const uint8_t* first;
};

constexpr int kRowThreads = 128;                        // gap_expand's CTA
constexpr int kRowVec = bm::kBlockVec / kRowThreads;    // 4 vectors a thread
constexpr int kRowWarps = kRowThreads / 32;

// Row i of the output (see the top of the file).  A vector's carry is the
// parity of the marks in the chunks before it (every warp) and before it
// in its own chunk (the warps before, then the lanes before: a ballot
// each).
__global__ void __launch_bounds__(kRowThreads)
gap_expand_kernel(Mirror a, Mirror b, const int32_t* __restrict__ sel,
                  int k_a, uint4* __restrict__ out) {
  __shared__ uint4 tog[bm::kBlockVec];            // 8 KiB of marks
  __shared__ uint32_t warp_par[kRowVec][kRowWarps];
  const Mirror m = static_cast<int>(blockIdx.x) < k_a ? a : b;
  const int blk = sel[blockIdx.x];
  const int r0 = __ldg(m.offs + blk);
  const int r1 = __ldg(m.offs + blk + 1) - 1;     // the last run: no mark
  const uint32_t v0 = __ldg(m.first + blk);
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kRowVec; ++j) {
    tog[t + j * kRowThreads] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  uint32_t* marks = reinterpret_cast<uint32_t*>(tog);
  if (t == 0 && (v0 & 1u)) atomicOr(marks, 1u);
  for (int r = r0 + t; r < r1; r += 4 * kRowThreads) {
    int p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rj = r + j * kRowThreads;
      p[j] = rj < r1 ? __ldg(m.ends + rj) + 1 : -1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (p[j] >= 0) atomicOr(marks + (p[j] >> 5), 1u << (p[j] & 31));
    }
  }
  __syncthreads();
  const int lane = t & 31;
  const int warp = t >> 5;
  uint4 v[kRowVec];
  unsigned bal[kRowVec];
#pragma unroll
  for (int j = 0; j < kRowVec; ++j) {
    v[j] = tog[t + j * kRowThreads];
    bal[j] = __ballot_sync(0xFFFFFFFFu, bm::popc4(v[j]) & 1u);
    if (lane == 0) warp_par[j][warp] = __popc(bal[j]) & 1u;
  }
  __syncthreads();
  uint32_t before = 0u;            // the parity of the chunks before j
  uint4* dst = out + static_cast<size_t>(blockIdx.x) * bm::kBlockVec + t;
#pragma unroll
  for (int j = 0; j < kRowVec; ++j) {
    uint32_t carry = before ^ (__popc(bal[j] & ((1u << lane) - 1u)) & 1u);
    uint32_t chunk = 0u;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) {
      const uint32_t pw = warp_par[j][w];
      if (w < warp) carry ^= pw;
      chunk ^= pw;
    }
    before ^= chunk;
    uint32_t x[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t y = x[k];
      const uint32_t pk = __popc(y) & 1u;
      y ^= y << 1;
      y ^= y << 2;
      y ^= y << 4;
      y ^= y << 8;
      y ^= y << 16;
      x[k] = y ^ (0u - carry);
      carry ^= pk;
    }
    dst[j * kRowThreads] = make_uint4(x[0], x[1], x[2], x[3]);
  }
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

// out int32[k, 2048]: row i = block sel[i] of mirror a (i < k_a) or of
// mirror b (i >= k_a), each (ends, offs, first); a mirror no row reads
// may be null.  Returns the CUDA error of the launch (0 = launched).
// k >= 1, 0 <= k_a <= k.
extern "C" int bm_gap_expand(const void* ends_a, const void* offs_a,
                             const void* first_a, const void* ends_b,
                             const void* offs_b, const void* first_b,
                             const void* sel, int k_a, int k, void* out,
                             void* stream) {
  if (k <= 0 || k_a < 0 || k_a > k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mirror a{static_cast<const int32_t*>(ends_a),
                 static_cast<const int32_t*>(offs_a),
                 static_cast<const uint8_t*>(first_a)};
  const Mirror b{static_cast<const int32_t*>(ends_b),
                 static_cast<const int32_t*>(offs_b),
                 static_cast<const uint8_t*>(first_b)};
  gap_expand_kernel<<<k, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, static_cast<const int32_t*>(sel), k_a, static_cast<uint4*>(out));
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
