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
// mirror a, else mirror b), into one tensor whose first k_a rows are a's;
// its many-store form (the aggregator's operands, kTable) reads each
// row's (store, block) and then that store's mirror from a table, one
// round trip more.
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
// gap_compress: one single-pass launch, a chained scan with decoupled
// look-back.  A transition word t = w ^ ((w >> 1) | (next word << 31))
// has bit b set where bit b differs from the bit after it, i.e. where a
// run ends.  A CTA of 256 threads takes a row ticket from a global
// counter (not blockIdx.x, so it waits only on CTAs already running: the
// rows far outnumber the CTAs the card holds), reads its row once (two
// 16-byte loads a thread), popcounts its transitions and publishes the
// row's run count as an aggregate flag word.  It then looks back over
// the predecessors' flags, 512 a round (two coalesced loads a thread),
// summing aggregates down to the nearest inclusive prefix, and
// publishes the row's inclusive prefix; the CTA writes its run ends at
// the exclusive prefix (each thread at its offset from a scan over the
// CTA, the last thread the closing end 65535), its offs[i + 1] and
// first[i].  A flag word is one 64-bit word (a status and a run count),
// stored and read whole, so no fence orders it against other data.  The
// counter and the flags are a scratch buffer of the call's, which the C
// entry clears (one memset) before the launch.  The output is one packed
// int32 buffer [offs (n + 1) | first (n, a word each) | ends (cap)],
// which the host downloads in one copy (core/gapstore.GapStore
// .from_packed): no scalar sync, no second pass.  ``cap`` bounds the
// total that the caller knows (core/bitvector: the summed runs of a GAP x
// GAP pair, the run counts sv_descent reports); nothing is written past
// it, offs[n] always holds the true total (clamped to int32), and a
// reader raises when it exceeds ``cap``.  Bound: the 8 KiB read per row
// and the 4 B written per run end, offset and first.  The first port
// made two launches (a count pass and a write pass reading every row
// again) around a torch.cumsum and a scalar sync for the total.
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

// Row i of the output (see the top of the file): block sel[i] of mirror
// a (i < k_a) or of mirror b; with kTable, block sel[2i + 1] of mirror
// table[sel[2i]] (a, b and k_a unused).  A vector's carry is the parity
// of the marks in the chunks before it (every warp) and before it in its
// own chunk (the warps before, then the lanes before: a ballot each).
template <bool kTable>
__global__ void __launch_bounds__(kRowThreads)
gap_expand_kernel(Mirror a, Mirror b, const Mirror* __restrict__ table,
                  const int32_t* __restrict__ sel, int k_a,
                  uint4* __restrict__ out) {
  __shared__ uint4 tog[bm::kBlockVec];            // 8 KiB of marks
  __shared__ uint32_t warp_par[kRowVec][kRowWarps];
  Mirror m;
  int blk;
  if (kTable) {
    const int2 r = reinterpret_cast<const int2*>(sel)[blockIdx.x];
    m = table[r.x];
    blk = r.y;
  } else {
    m = static_cast<int>(blockIdx.x) < k_a ? a : b;
    blk = sel[blockIdx.x];
  }
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

// Flag words of the look-back (see the top of the file): a status in
// bits 32-33 (0: not yet published, the memset's) and a run count,
// saturated to 32 bits, below.
constexpr unsigned long long kAgg = 1;         // the row's own run count
constexpr unsigned long long kPre = 2;         // its inclusive prefix
constexpr unsigned long long kValMax = 0xFFFFFFFFull;
constexpr int kMaxI32 = 0x7FFFFFFF;

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_flag(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long flag(unsigned long long status,
                                                   long long v) {
  const unsigned long long u = static_cast<unsigned long long>(v);
  return (status << 32) | (u > kValMax ? kValMax : u);
}

__device__ __forceinline__ bool ready(unsigned long long f) {
  return ((f >> 32) & 3u) != 0;
}

__device__ __forceinline__ int32_t clamp_i32(long long v) {
  return static_cast<int32_t>(v > kMaxI32 ? kMaxI32 : v);
}

// The exclusive prefix of row ``row`` (>= 1), by the whole CTA: thread t
// reads the flags of rows top - t and top - t - 256 (coalesced, the
// nearest 512 rows a round) and polls, with a short sleep, until both
// are published.  The nearest inclusive prefix ends the walk (a row
// before 0 counts as a prefix of 0).  Every thread returns the same sum.
__device__ long long look_back(const unsigned long long* flags, int row,
                               unsigned* pre_mask, long long* part) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  long long excl = 0;
  for (int top = row - 1 - t;; top -= 2 * bm::kThreads) {
    const int far = top - bm::kThreads;
    unsigned long long f0 = top >= 0 ? load_flag(flags + top) : flag(kPre, 0);
    unsigned long long f1 = far >= 0 ? load_flag(flags + far) : flag(kPre, 0);
    while (!ready(f0) || !ready(f1)) {
      __nanosleep(32);
      if (!ready(f0)) f0 = load_flag(flags + top);
      if (!ready(f1)) f1 = load_flag(flags + far);
    }
    // the nearest prefix: offset t (f0) or t + 256 (f1) from row - 1
    const unsigned p0 = __ballot_sync(0xFFFFFFFFu, ((f0 >> 32) & 3u) == kPre);
    const unsigned p1 = __ballot_sync(0xFFFFFFFFu, ((f1 >> 32) & 3u) == kPre);
    if (lane == 0) {
      pre_mask[warp] = p0;
      pre_mask[bm::kWarps + warp] = p1;
    }
    __syncthreads();
    int stop = 2 * bm::kThreads;
#pragma unroll
    for (int w = 2 * bm::kWarps - 1; w >= 0; --w) {
      if (pre_mask[w]) stop = 32 * w + __ffs(pre_mask[w]) - 1;
    }
    long long c = t <= stop ? static_cast<long long>(f0 & kValMax) : 0;
    if (t + bm::kThreads <= stop) c += static_cast<long long>(f1 & kValMax);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xFFFFFFFFu, c, o);
    if (lane == 0) part[warp] = c;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < bm::kWarps; ++w) excl += part[w];
    if (stop < 2 * bm::kThreads) return excl;
    __syncthreads();                  // pre_mask and part are read
  }
}

// out int32[2n + 1 + cap] = [offs | first | ends]; scratch uint64[n + 1],
// zeroed: the ticket counter, then the n flags.
__global__ void __launch_bounds__(bm::kThreads, 8)
gap_compress_kernel(const uint4* __restrict__ rows, int n, long long cap,
                    int32_t* __restrict__ out,
                    unsigned long long* __restrict__ scratch) {
  __shared__ uint32_t head[bm::kThreads];
  __shared__ int part[bm::kWarps];
  __shared__ unsigned pre_mask[2 * bm::kWarps];
  __shared__ long long sums[bm::kWarps];
  __shared__ int s_row;
  if (threadIdx.x == 0) {
    s_row = static_cast<int>(atomicAdd(scratch, 1ull));
  }
  __syncthreads();
  const int row = s_row;
  unsigned long long* flags = scratch + 1;
  uint32_t t[kWordsPerThread];
  transitions(rows + static_cast<size_t>(row) * bm::kBlockVec, head, t);
  int c = 0;
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) c += __popc(t[j]);
  // this thread's offset in the row: an inclusive scan in the warp, then
  // the warps before it
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
  int before = incl - c;
  int ends_in_row = 0;
#pragma unroll
  for (int i = 0; i < bm::kWarps; ++i) {
    if (i < warp) before += part[i];
    ends_in_row += part[i];
  }
  const long long runs = ends_in_row + 1;      // and the closing 65535
  if (threadIdx.x == 0) {
    store_flag(flags + row, flag(row == 0 ? kPre : kAgg, runs));
  }
  const long long base =
      row == 0 ? 0 : look_back(flags, row, pre_mask, sums);
  if (threadIdx.x == 0) {
    if (row > 0) store_flag(flags + row, flag(kPre, base + runs));
    out[row + 1] = clamp_i32(base + runs);
    out[n + 1 + row] = static_cast<int32_t>(head[0] & 1u);
    if (row == 0) out[0] = 0;
  }
  int32_t* ends = out + 2 * static_cast<size_t>(n) + 1;
  long long at = base + before;
  const int bit0 = threadIdx.x * kBitsPerThread;
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) {
    uint32_t x = t[j];
    while (x) {
      if (at < cap) ends[at] = bit0 + 32 * j + __ffs(x) - 1;
      ++at;
      x &= x - 1u;
    }
  }
  if (threadIdx.x == bm::kThreads - 1 && base + runs - 1 < cap) {
    ends[base + runs - 1] = kLastBit;
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
  gap_expand_kernel<false>
      <<<k, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          a, b, nullptr, static_cast<const int32_t*>(sel), k_a,
          static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out int32[k, 2048]: row i = block rows[2i + 1] of the store whose
// mirror is mirrors[rows[2i]] (three pointers each: ends, offs, first;
// 8-byte aligned, as rows).  Returns the CUDA error of the launch.
extern "C" int bm_gap_expand_many(const void* mirrors, const void* rows,
                                  int k, void* out, void* stream) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Mirror none{nullptr, nullptr, nullptr};
  gap_expand_kernel<true>
      <<<k, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          none, none, static_cast<const Mirror*>(mirrors),
          static_cast<const int32_t*>(rows), 0, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The packed D-GAP encoding of rows int32[n, 2048] into out int32[2n + 1
// + cap] (offs, first, at most cap ends; see gap_compress_kernel).
// scratch uint64[n + 1] is the call's: cleared here, on the stream,
// before the launch.  n >= 1, cap >= 0.  Returns the CUDA error of the
// memset or the launch (0 = launched).
extern "C" int bm_gap_compress(const void* rows, int n, long long cap,
                               void* out, void* scratch, void* stream) {
  if (n <= 0 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, (static_cast<size_t>(n) + 1) * sizeof(unsigned long long),
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  gap_compress_kernel<<<n, bm::kThreads, 0, s>>>(
      static_cast<const uint4*>(rows), n, cap, static_cast<int32_t*>(out),
      static_cast<unsigned long long*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
