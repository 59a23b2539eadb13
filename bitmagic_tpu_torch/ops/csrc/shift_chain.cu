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
// 0.  Every term is independent of the others, so the AND may take them
// in any order: grouped by operand vector (a pattern's letters repeat:
// 32 operands of a DNA pattern are 4 vectors), it is the AND over the D
// distinct vectors of the AND over each one's shifts.
//
// The wrapper (ops/cuda_kernels.shift_and_chain, ops/blockops.
// chain_groups / chain_segments) uploads, in one buffer, per distinct
// vector (the vector with the most shifts first: it kills bits fastest)
// its shifts s = 32 q + r cut into segments of word shifts q in one
// aligned span of 32, each segment (vector, qa, nq, mask offset) beside
// its vector's gather descriptor (bm::Operand, agg_sub.cu's layout), and
// the segments' masks, mask i holding bit r for each shift
// 32 (qa + i) + r.  An absent row reads 0 and a FULL row ones, without a
// load.
//
// Bound on this card: the bytes, every distinct operand row read once
// and the result written once (config 1's 32-letter pattern: 4 vectors x
// 1536 rows and the result, 62.9 MB, 0.0188 ms); the early exit leaves
// less to read.  Design:
//  - A CTA of 128 threads owns one output row: a row is the unit of the
//    list (a segment's window then spans at most two list blocks), and its
//    per-CTA work (the run-start walk, the descriptors, the barriers) is
//    spread over 8 KiB.  Thread t owns words t + 128 i (i < 16): a warp's
//    32 lanes read 32 consecutive shared words at any offset, free of bank
//    conflicts for any shift.
//  - Each segment's window, the row's words less qa and the words its
//    deepest shift reaches (qa + nq, aligned down to 16 B), is staged once
//    in one shared-memory stage by cp.async.bulk (TMA), one copy per
//    source list block, completing on one mbarrier (expect_tx).  A FULL
//    or absent source block, or one before the row's run of adjacent
//    blocks, is not copied: the threads write its fill word into the
//    stage.  One copy is in flight, issued after the vote on the segment
//    before: a Bitap row mostly dies at its first or second vector, so a
//    copy issued ahead is mostly bytes nobody needs; the card's other
//    CTAs (up to 10 an SM) hide the latency instead (PERF.md row 14: rings
//    of 1-3 stages measured, one fastest at config 1's Bitap shapes).
//  - Per word shift q the two source words w[x - q] and w[x - q - 1] are
//    read from shared memory once; each shift r of the mask then costs one
//    funnel shift and an AND.  No global load per operand, no shuffle of
//    row words.
//  - After each segment the CTA votes (__syncthreads_or): a dead row
//    issues no further copy and writes zeros.  Its last copy completed
//    before the vote, so no copy into its shared memory outlives it.
//  - A segment's record holds its descriptor, so resolving a source row
//    is two round trips (the record, then its slot / FULL / aux slot).
//    The records of 32 segments are resolved at once, a thread per
//    (segment, source block), one chunk ahead of the copies; the run start
//    of the row is walked from first_mask by the last thread beside them.
//  - Indices stay relative to the output row, so no 64-bit flat index is
//    needed however long the list; a chain longer than one block's bits
//    is any number of segments, a window each.
#include "bm_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = bm::kBlockWords / kThreads;        // 16 words
constexpr int kRowShift = 11;                                 // 2048 words
constexpr int kStageWords = bm::kBlockWords + 64;   // a window: <= 2086
constexpr int kChunk = 32;                // segments resolved at once
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  while (!ok) {
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 "
                 "p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                 : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  }
}

// The window of segment (qa, nq) in words relative to the output row's
// first word: [ws, we), both 16-byte aligned; len0 words from list block
// b + o (from its word ws - 2048 o), then len1 from block b + o + 1 (from
// its word 0).
struct Window {
  int ws, o, len0, len1;
};

__device__ __forceinline__ Window window(int qa, int nq) {
  Window w;
  w.ws = -((qa + nq + 3) & ~3);
  const int we = bm::kBlockWords - (qa & ~3);
  w.o = w.ws >> kRowShift;                 // arithmetic: floors
  const int split = (w.o + 1) << kRowShift;
  w.len0 = min(we, split) - w.ws;
  w.len1 = max(we - split, 0);
  return w;
}

// One segment as the wrapper uploads it: (vector, qa, nq, mask offset)
// and its vector's descriptor, read together in one round trip.
struct Seg {
  int4 s;
  bm::Operand op;
  int64_t pad;
};
static_assert(sizeof(Seg) == 80, "Seg is 10 int64 columns");

// The CTA's resolved segments: two chunks of kChunk (the one applied and
// the next), each segment's two source rows (nullptr: a fill word).
struct Table {
  int4 seg[2][kChunk];
  const uint32_t* ptr[2][kChunk][2];
  uint32_t fill[2][kChunk][2];
};

// Threads 0 .. 2 kChunk - 1 resolve chunk ``ch`` of the segments into
// buffer ch & 1: a thread per (segment, source block).
__device__ __forceinline__ void resolve_chunk(
    Table& t, int ch, const Seg* __restrict__ segs, int n_seg, int b) {
  const int e = threadIdx.x >> 1;
  const int h = threadIdx.x & 1;
  const int c = ch * kChunk + e;
  if (e >= kChunk || c >= n_seg) return;
  const Seg& rec = segs[c];
  const int4 sg = rec.s;
  const Window w = window(sg.y, sg.z);
  const int p = b + w.o + h;
  const uint32_t* ptr = nullptr;
  uint32_t fill = 0u;
  if ((h == 0 || w.len1 > 0) && p >= 0) {
    const bm::RowSrc s = bm::resolve(rec.op, p);
    ptr = reinterpret_cast<const uint32_t*>(s.ptr);
    fill = s.fill;
  }
  const int buf = ch & 1;
  if (h == 0) t.seg[buf][e] = sg;
  t.ptr[buf][e][h] = ptr;
  t.fill[buf][e][h] = fill;
}

// Source row of part h of segment (buf, e), or nullptr where the part is
// a fill word: no part, a FULL or absent block, or a block before the
// row's run (list-block offset below lb).
__device__ __forceinline__ const uint32_t* part_row(const Table& t, int buf,
                                                    int e, const Window& w,
                                                    int h, int lb) {
  if ((h == 1 && w.len1 == 0) || w.o + h < lb) return nullptr;
  return t.ptr[buf][e][h];
}

// Copy c into the stage (thread 0): each part with a source row by one
// bulk copy, completing on the stage's mbarrier.
__device__ __forceinline__ void issue(const Table& t, int c, int lb,
                                      uint32_t* stage, uint64_t* bar_p) {
  const int buf = (c / kChunk) & 1;
  const int e = c % kChunk;
  const int4 sg = t.seg[buf][e];
  const Window w = window(sg.y, sg.z);
  const uint32_t* p0 = part_row(t, buf, e, w, 0, lb);
  const uint32_t* p1 = part_row(t, buf, e, w, 1, lb);
  const uint32_t dst = smem_addr(stage);
  const uint32_t bar = smem_addr(bar_p);
  const uint32_t bytes0 = p0 != nullptr ? 4u * w.len0 : 0u;
  const uint32_t bytes1 = p1 != nullptr ? 4u * w.len1 : 0u;
  // the stage's earlier reads and fill writes (generic proxy) come before
  // the copy's writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes0 + bytes1) : "memory");
  if (p0 != nullptr) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];"
                 :: "r"(dst), "l"(p0 + (w.ws - (w.o << kRowShift))),
                    "r"(bytes0), "r"(bar) : "memory");
  }
  if (p1 != nullptr) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];"
                 :: "r"(dst + 4u * w.len0), "l"(p1), "r"(bytes1), "r"(bar)
                 : "memory");
  }
}

__device__ __forceinline__ void fill_words(uint32_t* dst, int len,
                                           uint32_t v) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < len / 4; i += kThreads) {
    d[i] = make_uint4(v, v, v, v);
  }
}

__global__ void __launch_bounds__(kThreads)
shift_and_chain_kernel(const Seg* __restrict__ segs, int n_seg,
                       const uint32_t* __restrict__ masks, int deep,
                       const int32_t* __restrict__ first_mask,
                       uint32_t* __restrict__ out) {
  __shared__ __align__(128) uint32_t st[kStageWords];
  __shared__ __align__(8) uint64_t bar;
  __shared__ Table t;
  __shared__ int s_lb;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid == kThreads - 1) {
    // the run start: walk first_mask back from the row to the deepest
    // block a window reaches (beside the descriptors' loads)
    const int lowest = max(0, b + deep);
    int lb = b;
    while (lb > lowest && (__ldg(first_mask + lb) & 1)) --lb;
    s_lb = lb - b;
  }
  resolve_chunk(t, 0, segs, n_seg, b);
  __syncthreads();
  const int lb = s_lb;
  uint32_t acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = kAll;
  for (int c = 0; c < n_seg; ++c) {
    // every thread is done with the stage (the vote below, or the
    // __syncthreads above for c = 0) before it is refilled
    if (tid == 0) issue(t, c, lb, st, &bar);
    const int buf = (c / kChunk) & 1;
    const int e = c % kChunk;
    if (e == 0 && c + kChunk < n_seg) {
      resolve_chunk(t, c / kChunk + 1, segs, n_seg, b);
    }
    const int4 sg = t.seg[buf][e];
    const uint32_t mine = lane < sg.z ? __ldg(masks + sg.w + lane) : 0u;
    const Window w = window(sg.y, sg.z);
    bar_wait(smem_addr(&bar), static_cast<uint32_t>(c) & 1u);
    const bool f0 = part_row(t, buf, e, w, 0, lb) == nullptr;
    const bool f1 = w.len1 > 0 && part_row(t, buf, e, w, 1, lb) == nullptr;
    if (f0) fill_words(st, w.len0, w.o >= lb ? t.fill[buf][e][0] : 0u);
    if (f1) {
      fill_words(st + w.len0, w.len1,
                 w.o + 1 >= lb ? t.fill[buf][e][1] : 0u);
    }
    if (f0 || f1) __syncthreads();
    for (int i = 0; i < sg.z; ++i) {
      const uint32_t m = __shfl_sync(kAll, mine, i);
      if (m == 0u) continue;
      // src[x] is window word x - q
      const uint32_t* src = st - (w.ws + sg.y + i);
#pragma unroll
      for (int g = 0; g < kPerThread; g += 4) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hi[j] = src[tid + (g + j) * kThreads];
          lo[j] = src[tid + (g + j) * kThreads - 1];
        }
        uint32_t mm = m;
        do {
          const int r = __ffs(mm) - 1;
          mm &= mm - 1u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[g + j] &= __funnelshift_l(lo[j], hi[j], r);
          }
        } while (mm != 0u);
      }
    }
    uint32_t any = 0u;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) any |= acc[j];
    if (!__syncthreads_or(any != 0u)) break;
  }
  uint32_t* row = out + (static_cast<size_t>(b) << kRowShift);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) row[tid + j * kThreads] = acc[j];
}

}  // namespace

// out int32[n, 2048]: the chain over ``n_seg`` segments ``segs`` (Seg,
// 80 bytes each, 16-byte aligned: vector, qa, nq, mask offset and the
// vector's bm::Operand) aligned on n list blocks, their shift masks
// ``masks`` (uint32), ``deep`` the lowest list-block offset a segment's
// window reaches, ``first_mask`` int32[n].  Returns the CUDA error of the
// launch (0 = launched).
extern "C" int bm_shift_and_chain(const void* segs, int n_seg,
                                  const void* masks, int deep,
                                  const void* first_mask, int n, void* out,
                                  void* stream) {
  if (n_seg <= 0 || n <= 0 || deep > 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  shift_and_chain_kernel<<<n, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Seg*>(segs), n_seg,
      static_cast<const uint32_t*>(masks), deep,
      static_cast<const int32_t*>(first_mask), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
