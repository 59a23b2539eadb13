// sv_descent and descent_rows: the MSB-first slice descent behind every
// ordered search of a bit-sliced column, in one launch.
//
// They replace the JAX package's chain of set operations in
// bitmagic_tpu/sv/scanner.py:210 _cmp_unsigned (find_gt/ge/lt/le/range,
// the signed split, find_gt_float's exponent and mantissa descents and,
// through the dense column, the RSC searches), and its two fused jitted
// programs over a shard's stack, bitmagic_tpu/parallel/sharded_sv.py:1182
// _descent_prog and :1208 _float_gt_prog.  For the value's bits from the
// top down, p the plane of that bit, starting from eq = the universe and
// gt = empty:
//   bit 1:  eq = eq & p
//   bit 0:  gt = gt | (eq & p);  eq = eq - p
//
// sv_descent, the structured form.  The planes arrive as the column's
// plane table (core/blocks.plane_table, layout in sv_planes.cu), the
// universe as a one-plane table of the same layout, the steps as table
// rows with the value's bits, and the walked blocks as their entry codes
// (core/blocks.descent_codes): per block one int32 a step and one for the
// universe, from the plane table's block directory -- a pool row (BIT),
// -1 (a FULL entry), kDirRun (inside a FULL run), -2 - g (D-GAP block g)
// or kDirZero.  The walked blocks are every block that the planes or the
// universe hold an entry for; every other block lies in FULL runs or is
// absent, and the host resolves it by interval algebra.  One CTA of 256
// threads walks one block.  It keeps gt and eq of its block in registers
// (two 16-byte vectors a thread) with the class that the port's set
// operation would give each after every step (core/bitvector._binary,
// core/blocks.plan_binary): absent, FULL, inside a FULL run, BIT, or
// D-GAP with its run count.  The classes follow the set operation's
// rules: the FULL / absent algebra, the D-GAP pass-throughs (FULL & GAP
// is the GAP block, FULL - GAP its complement, ...), GAP x GAP pairs of
// at most 4096 runs in all merged (absent when zero, FULL when all ones,
// else D-GAP), every other pair a BIT row, even a zero one.  A D-GAP
// operand is decoded from its store's mirror, a thread's words by a
// binary search of the block's ends and a walk.  A block whose eq becomes
// absent stops there: no later step changes it.  The kernel writes the
// block's gt row (and eq's where the caller asks) with its wave digest as
// K1 does, and both final classes, each with a D-GAP result's run count
// (the sum bounds gap_compress's output exactly); the host builds the
// result vectors from them (BIT rows as they are, D-GAP rows re-encoded
// by gap_compress).
//
// descent_rows, the dense form: one shard's stack int32[K, n_blocks,
// 2048] (sharded_sv's layout), the universe a row (ANDed with the sign row
// or its complement in modes 2 and 1), the steps stack rows (-1: a zero
// plane).
//
// Bound on this card: the bytes, each stepped plane's BIT rows (and D-GAP
// runs) and the universe's read once, the results written once.  What the
// design does about it:
// * sv_descent: a block's codes are one load, so a CTA knows every step's
//   operand after one round trip (the first port searched each plane's
//   block ids and FULL runs, a chain of ~20 dependent loads, first).  Its
//   thread 0 then streams the BIT rows, in step order, into a ring of up
//   to kMaxStages 8 KiB shared-memory stages by cp.async.bulk (TMA), one
//   mbarrier a stage, refilling a stage as soon as its row is read: up to
//   32 KiB a CTA in flight, where the first port kept one row (8 stages
//   measured no faster than 4, 2 hardly slower; PERF.md).  A step
//   costs few instructions: the block classes of a pair come from a
//   table, the all-zero / all-ones votes run only for a GAP x GAP merge,
//   the ring's stage and phase are a mask and a shift.  cell 3's 245
//   blocks run in one wave.
// * descent_rows: the descent is elementwise, so a thread owns one
//   16-byte vector of the shard's rows and loads every step's vector of
//   it kBatch steps at a time, the next batch's loads issued before this
//   one's logic (8 measured ahead of 4, 16 and all 32 at once: more
//   steps in registers cost warps an SM), and CTAs of 64 threads (an
//   eighth of a row each) fill the card from a 31-row shard (248 CTAs)
//   up; the first port ran a CTA per row with one row in flight.
#include "bm_common.cuh"

namespace {

constexpr int kMaxSteps = 64;
constexpr int kMaxStages = 4;            // sv_descent's ring
constexpr int kRowBytes = bm::kBlockWords * 4;
constexpr int kRowsThreads = 64;         // descent_rows' CTAs
constexpr int kBatch = 8;                // descent_rows' steps a batch
constexpr int kMergeMaxRuns = 4096;   // core/bitvector._GAP_MERGE_MAX_RUNS
constexpr unsigned kAll = 0xFFFFFFFFu;
// entry codes without a row (blockops.DIR_ZERO, blockops.DIR_RUN)
constexpr int32_t kDirZero = INT32_MIN;
constexpr int32_t kDirRun = INT32_MIN + 1;

// a block's class (blockops.DESCENT_CLASSES), and kMerge: a GAP x GAP
// pair whose content decides
enum : int { kZero = 0, kFull = 1, kRun = 2, kBit = 3, kGap = 4, kMerge = 5 };
enum : int { kAnd = 0, kOr = 1, kSub = 2 };

// The steps in descent order: plane-table rows (sv_descent) or stack rows
// (descent_rows, -1 a zero plane), and the value's bit of each step.
struct Steps {
  int rows[kMaxSteps];
  unsigned long long bits;
  int n;
};

// gt, eq or an operand of one block: its class, its run count (kGap) and
// this thread's vectors threadIdx.x + 256 j of the row.
struct State {
  int cls;
  int runs;
  uint4 v[bm::kVecPerThread];
};

__device__ __forceinline__ uint4 fill(uint32_t w) {
  return make_uint4(w, w, w, w);
}

__device__ __forceinline__ uint4 op4(int op, uint4 a, uint4 b) {
  if (op == kAnd) {
    return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
  }
  if (op == kOr) {
    return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  }
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}

// Class of an entry code and its pool row (kBit) or store index (kGap).
__device__ __forceinline__ int2 decode(int32_t e) {
  if (e >= 0) return make_int2(kBit, e);
  if (e == -1) return make_int2(kFull, 0);
  if (e == kDirRun) return make_int2(kRun, 0);
  if (e == kDirZero) return make_int2(kZero, 0);
  return make_int2(kGap, -2 - e);
}

// Bits lo..hi of a word, 0 <= lo <= hi <= 31.
__device__ __forceinline__ uint32_t span_mask(int lo, int hi) {
  return static_cast<uint32_t>((2ull << hi) - (1ull << lo));
}

// Words bit0 / 32 .. + 3 of D-GAP block g of the plane's store: the run
// holding bit0 by a binary search of the block's ends, then a walk.
__device__ uint4 gap_vec(const bm::Plane& p, int g, int bit0) {
  const int r0 = __ldg(p.offs + g);
  int lo = r0;
  int hi = __ldg(p.offs + g + 1) - 1;    // the last run ends at 65535
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(p.ends + mid) < bit0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int r = lo;
  int e = __ldg(p.ends + r);
  uint32_t val = (static_cast<uint32_t>(p.first[g]) ^
                  static_cast<uint32_t>(r - r0)) & 1u;
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int wb = bit0 + 32 * j;
    const int wl = wb + 31;
    if (e < wb) {          // the run ended on the last bit of the word before
      e = __ldg(p.ends + ++r);
      val ^= 1u;
    }
    uint32_t word = 0u;
    int at = wb;
    while (e < wl) {       // runs that end inside this word
      if (val) word |= span_mask(at - wb, e - wb);
      at = e + 1;
      e = __ldg(p.ends + ++r);
      val ^= 1u;
    }
    if (val) word |= span_mask(at - wb, 31);
    w[j] = word;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(kRowBytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(dst), "l"(src), "r"(kRowBytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  while (!ok) {
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 "
                 "p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                 : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  }
}

// The ring of staged BIT rows of one CTA: copy q (the q-th BIT operand in
// the order universe, step 0, step 1, ...) lands in stage q % stages and
// completes phase q / stages of that stage's mbarrier; stages is a power
// of two (2^shift), so both are a mask and a shift.  Only thread 0
// issues.
struct Ring {
  uint4* rows;                  // stages x kBlockVec vectors
  uint64_t* bars;
  int stages;
  int shift;
  int n_copies;
  const int* slot;              // slot (step, or n: the universe) of copy q
  const bm::Plane* sp;
  const int* idx;               // pool row of each slot

  __device__ __forceinline__ void issue(int q) const {
    const int s = slot[q];
    const int b = q & (stages - 1);
    bulk_load(smem_addr(rows + b * bm::kBlockVec),
              sp[s].pool + static_cast<size_t>(idx[s]) * bm::kBlockWords,
              smem_addr(bars + b));
  }

  __device__ __forceinline__ void wait(int q) const {
    bar_wait(smem_addr(bars + (q & (stages - 1))),
             static_cast<uint32_t>(q >> shift) & 1u);
  }

  // This thread's vectors of copy q, then the stage refilled with copy
  // q + stages (the CTA's barrier: every thread has read the stage).
  __device__ __forceinline__ void take(int q,
                                       uint4 (&v)[bm::kVecPerThread]) const {
    wait(q);
    const int b = q & (stages - 1);
    const uint4* r = rows + b * bm::kBlockVec;
#pragma unroll
    for (int j = 0; j < bm::kVecPerThread; ++j) {
      v[j] = r[threadIdx.x + j * bm::kThreads];
    }
    __syncthreads();
    if (threadIdx.x == 0 && q + stages < n_copies) issue(q + stages);
  }
};

// The operand of slot s; a BIT row is copy q of the ring.
__device__ __forceinline__ State operand(const Ring& ring, int cls, int idx,
                                         int q, int s) {
  State st;
  st.cls = cls;
  st.runs = 0;
  if (cls == kBit) {
    ring.take(q, st.v);
    return st;
  }
  const bm::Plane& p = ring.sp[s];
  if (cls == kGap) st.runs = __ldg(p.offs + idx + 1) - __ldg(p.offs + idx);
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) {
    if (cls == kGap) {
      st.v[j] = gap_vec(p, idx, (threadIdx.x + j * bm::kThreads) * 128);
    } else {
      st.v[j] = fill(cls == kFull || cls == kRun ? kAll : 0u);
    }
  }
  return st;
}

// pair_class's rules as a table: per op, [class of a][class of b] -> the
// class of a OP b, or kPassA / kPassB (the D-GAP block of a / of b, or
// its complement, with its run count), or kGapGap (merged when the pair
// has at most kMergeMaxRuns runs in all, else a BIT row).
enum : int { kPassA = 8, kPassB = 9, kGapGap = 10 };
__constant__ uint8_t kPairTable[3][5][5] = {
    {{0, 0, 0, 0, 0}, {0, 1, 1, 3, 9}, {0, 1, 2, 3, 9}, {0, 3, 3, 3, 3},
     {0, 8, 8, 3, 10}},                                  // and
    {{0, 1, 2, 3, 9}, {1, 1, 2, 1, 1}, {2, 2, 2, 2, 2}, {3, 1, 2, 3, 3},
     {8, 1, 2, 3, 10}},                                  // or
    {{0, 0, 0, 0, 0}, {1, 0, 0, 3, 9}, {2, 0, 0, 3, 9}, {3, 0, 0, 3, 3},
     {8, 0, 0, 3, 10}}};                                 // sub

// Class of a OP b from the operands' classes; ``runs``: the result's run
// count where it is a D-GAP pass-through.  The set operation's rules:
// and: run & run is a run, anything & absent absent, FULL & FULL FULL,
// GAP & FULL the GAP block; or: a run absorbs, absent | absent absent,
// FULL absorbs, GAP | absent the GAP block; sub: run - absent a run,
// absent - x and x - FULL absent, FULL - absent FULL, GAP - absent the
// GAP block, FULL - GAP its complement; GAP x GAP merged or BIT; every
// other pair BIT.
__device__ __forceinline__ int pair_class(int op, int sa, int sb, int na,
                                          int nb, int& runs) {
  const int c = kPairTable[op][sa][sb];
  if (c < kPassA) return c;
  if (c == kPassA) {
    runs = na;
    return kGap;
  }
  if (c == kPassB) {
    runs = nb;
    return kGap;
  }
  return na + nb <= kMergeMaxRuns ? kMerge : kBit;
}

// 1 + the bit changes along the row (GapStore.n_runs of its canonical
// D-GAP form); ``tail`` and ``part`` are the CTA's shared scratch.
__device__ int run_count(const uint4 (&v)[bm::kVecPerThread],
                         uint32_t* tail, int* part) {
  __syncthreads();                       // the last reader of part is done
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) {
    tail[threadIdx.x + j * bm::kThreads] = v[j].w;
  }
  __syncthreads();
  int c = 0;
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) {
    const int q = threadIdx.x + j * bm::kThreads;
    // bit 0 has no bit before it: compare it with itself
    uint32_t prev = q > 0 ? tail[q - 1] >> 31 : v[j].x & 1u;
    const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c += __popc(w[i] ^ ((w[i] << 1) | prev));
      prev = w[i] >> 31;
    }
  }
  c = __reduce_add_sync(kAll, c);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = c;
  __syncthreads();
  int s = 1;
#pragma unroll
  for (int i = 0; i < bm::kWarps; ++i) s += part[i];
  return s;
}

// a OP b with its class (uniform in the CTA: the barriers below are).
__device__ __forceinline__ State apply(int op, const State& a, const State& b,
                                       uint32_t* tail, int* part) {
  State r;
  r.runs = 0;
  r.cls = pair_class(op, a.cls, b.cls, a.runs, b.runs, r.runs);
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) r.v[j] = op4(op, a.v[j], b.v[j]);
  if (r.cls == kMerge) {
    bool nz = false;
    bool ones = true;
#pragma unroll
    for (int j = 0; j < bm::kVecPerThread; ++j) {
      nz |= (r.v[j].x | r.v[j].y | r.v[j].z | r.v[j].w) != 0u;
      ones &= (r.v[j].x & r.v[j].y & r.v[j].z & r.v[j].w) == kAll;
    }
    if (!__syncthreads_or(nz)) {
      r.cls = kZero;
    } else if (__syncthreads_and(ones)) {
      r.cls = kFull;
    } else {
      r.cls = kGap;
      r.runs = run_count(r.v, tail, part);
    }
  }
  return r;
}

// Row blockIdx.x of ``out`` and its wave digest (K1's layout).
__device__ __forceinline__ void store_row(const uint4 (&v)[bm::kVecPerThread],
                                          uint4* __restrict__ out,
                                          int32_t* __restrict__ digest) {
  uint4* row = out + static_cast<size_t>(blockIdx.x) * bm::kBlockVec;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) {
    const int idx = threadIdx.x + j * bm::kThreads;
    row[idx] = v[j];
    if (digest == nullptr) continue;
    // vector idx holds words 4 idx .. 4 idx + 3, i.e. wave idx / 8
    const unsigned nz =
        __ballot_sync(kAll, (v[j].x | v[j].y | v[j].z | v[j].w) != 0u);
    if ((lane & 7) == 0) {
      digest[static_cast<size_t>(blockIdx.x) * bm::kBlockWaves + (idx >> 3)] =
          ((nz >> lane) & 0xFFu) != 0u ? 1 : 0;
    }
  }
}

__global__ void __launch_bounds__(bm::kThreads, 2)
sv_descent_kernel(const int64_t* __restrict__ table,
                  const int64_t* __restrict__ utable,
                  const int32_t* __restrict__ codes, int k, Steps steps,
                  int shift, uint4* __restrict__ gt_out,
                  int32_t* __restrict__ gt_dig, uint4* __restrict__ eq_out,
                  int32_t* __restrict__ eq_dig,
                  int32_t* __restrict__ cls_out) {
  extern __shared__ __align__(128) uint4 ring_rows[];   // stages rows
  __shared__ __align__(8) uint64_t bars[kMaxStages];
  // slot s < n: step s's plane; slot n: the universe's
  __shared__ bm::Plane sp[kMaxSteps + 1];
  __shared__ int s_cls[kMaxSteps + 1];
  __shared__ int s_idx[kMaxSteps + 1];
  __shared__ int s_copy[kMaxSteps + 1];  // a BIT slot's copy in the ring
  __shared__ int s_slot[kMaxSteps + 1];  // the slot of each copy
  __shared__ int s_copies;
  __shared__ uint32_t tail[bm::kBlockVec];
  __shared__ int part[bm::kWarps];
  const int n = steps.n;
  const int stages = 1 << shift;
  if (threadIdx.x == 0) {
    for (int j = 0; j < stages; ++j) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(bars + j)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < 32) {
    // warp 0: the block's codes, one load; copies in the order universe,
    // step 0, step 1, ... (the order the descent reads them)
    const int32_t* c = codes + static_cast<size_t>(blockIdx.x) * (n + 1);
    const int lane = threadIdx.x;
    int before = 0;
    for (int o0 = 0; o0 <= n; o0 += 32) {
      const int o = o0 + lane;
      const int s = o == 0 ? n : o - 1;
      const int2 d = o <= n ? decode(__ldg(c + s)) : make_int2(kZero, 0);
      const unsigned bit = __ballot_sync(kAll, d.x == kBit);
      if (o <= n) {
        const int q = before + __popc(bit & ((1u << lane) - 1u));
        s_cls[s] = d.x;
        s_idx[s] = d.y;
        s_copy[s] = q;
        if (d.x == kBit) s_slot[q] = s;
      }
      before += __popc(bit);
    }
    if (lane == 0) s_copies = before;
  }
  int64_t* raw = reinterpret_cast<int64_t*>(sp);
  for (int j = threadIdx.x; j < (n + 1) * bm::kPlaneCols; j += blockDim.x) {
    const int s = j / bm::kPlaneCols;
    const int c = j - s * bm::kPlaneCols;
    raw[j] = s < n ? table[static_cast<int64_t>(steps.rows[s]) *
                           bm::kPlaneCols + c]
                   : utable[c];
  }
  __syncthreads();
  const Ring ring{ring_rows, bars, stages, shift, s_copies, s_slot, sp,
                  s_idx};
  if (threadIdx.x == 0) {
    const int first = min(ring.n_copies, stages);
    for (int q = 0; q < first; ++q) ring.issue(q);
  }
  State eq = operand(ring, s_cls[n], s_idx[n], s_copy[n], n);
  int taken = s_cls[n] == kBit ? 1 : 0;
  State gt;
  gt.cls = kZero;
  gt.runs = 0;
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) gt.v[j] = fill(0u);
  for (int i = 0; i < n && eq.cls != kZero; ++i) {
    const State p = operand(ring, s_cls[i], s_idx[i], s_copy[i], i);
    taken += s_cls[i] == kBit ? 1 : 0;
    if ((steps.bits >> i) & 1ull) {
      eq = apply(kAnd, eq, p, tail, part);
    } else {
      const State t = apply(kAnd, eq, p, tail, part);
      gt = apply(kOr, gt, t, tail, part);
      eq = apply(kSub, eq, p, tail, part);
    }
  }
  store_row(gt.v, gt_out, gt_dig);
  if (eq_out != nullptr) store_row(eq.v, eq_out, eq_dig);
  if (threadIdx.x == 0) {
    // a class and, for a D-GAP result, its run count (0 for the rest)
    cls_out[blockIdx.x] = gt.cls | (gt.runs << 8);
    cls_out[k + blockIdx.x] = eq.cls | (eq.runs << 8);
    // a block that stopped early: the copies still in flight land before
    // the CTA leaves its shared memory
    const int issued = min(ring.n_copies, taken + stages);
    for (int q = taken; q < issued; ++q) ring.wait(q);
  }
}

// This thread's vectors v of steps i0 .. i0 + kBatch - 1 (a zero plane,
// or past n: zero).
__device__ __forceinline__ void load_batch(uint4 (&p)[kBatch],
                                           const uint4* stack,
                                           int64_t plane_vecs, int64_t v,
                                           const int* rows, int i0, int n) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int i = i0 + j;
    const int r = i < n ? rows[i] : -1;
    p[j] = r >= 0 ? bm::load_once(stack + r * plane_vecs + v) : fill(0u);
  }
}

__global__ void __launch_bounds__(kRowsThreads)
descent_rows_kernel(const uint4* __restrict__ stack, int64_t plane_vecs,
                    const uint4* __restrict__ uni,
                    const uint4* __restrict__ sign, int mode, Steps steps,
                    uint4* __restrict__ gt_out, uint4* __restrict__ eq_out) {
  __shared__ int s_rows[kMaxSteps];
  const int n = steps.n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_rows[i] = steps.rows[i];
  }
  __syncthreads();
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kRowsThreads +
                    threadIdx.x;
  if (v >= plane_vecs) return;
  uint4 eq = bm::load_once(uni + v);
  if (mode != 0) eq = op4(mode == 2 ? kAnd : kSub, eq, bm::load_once(sign + v));
  uint4 gt = fill(0u);
  uint4 p[kBatch], q[kBatch];            // this batch and the next
  load_batch(p, stack, plane_vecs, v, s_rows, 0, n);
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    if (i0 + kBatch < n) {
      load_batch(q, stack, plane_vecs, v, s_rows, i0 + kBatch, n);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j;
      if (i >= n) break;
      if ((steps.bits >> i) & 1ull) {
        eq = op4(kAnd, eq, p[j]);
      } else {
        gt = op4(kOr, gt, op4(kAnd, eq, p[j]));
        eq = op4(kSub, eq, p[j]);
      }
    }
    if (i0 + kBatch < n) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) p[j] = q[j];
    }
  }
  gt_out[v] = gt;
  eq_out[v] = eq;
}

int steps_of(const int* rows, int n, unsigned long long bits, int lo, int hi,
             Steps* st) {
  if (n < 0 || n > kMaxSteps) return 1;
  st->n = n;
  st->bits = bits;
  for (int i = 0; i < kMaxSteps; ++i) {
    st->rows[i] = i < n ? rows[i] : 0;
    if (i < n && (rows[i] < lo || rows[i] >= hi)) return 1;
  }
  return 0;
}

bm::LaunchCache g_descent;

}  // namespace

// The structured descent over k >= 1 walked blocks, given by their entry
// codes ``codes`` int32[k, n_steps + 1] (step i's plane in column i, the
// universe's in column n_steps): the column's plane table (table
// int64[n_planes, 9]), the universe's one-plane table (utable int64[1,
// 9]), the steps' plane rows ``rows`` (host int32[n_steps], n_steps <=
// 64, in descent order) with the value's bit of step i at bit i of
// ``bits``.  Writes gt int32[k, 2048] and gt_dig int32[k, 64]; eq and
// eq_dig the same when eq is not null; cls int32[2 k]: gt's classes, then
// eq's, each class | a D-GAP result's run count << 8.  The BIT rows are
// read by cp.async.bulk: pools 16-byte aligned.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int bm_sv_descent(const void* table, int n_planes,
                             const void* utable, const void* codes,
                             long long k, const int* rows, int n_steps,
                             unsigned long long bits, void* gt, void* gt_dig,
                             void* eq, void* eq_dig, void* cls,
                             void* stream) {
  Steps st;
  if (k <= 0 || k > 0x7FFFFFFFLL || (eq == nullptr) != (eq_dig == nullptr) ||
      steps_of(rows, n_steps, bits, 0, n_planes, &st) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int shift = 0;                         // stages: 2^shift >= n_steps + 1
  while ((1 << shift) < n_steps + 1 && (1 << shift) < kMaxStages) ++shift;
  const int smem = (1 << shift) * kRowBytes;
  int dev = 0;
  cudaGetDevice(&dev);
  const int err = bm::allow_smem(sv_descent_kernel, smem, g_descent, dev);
  if (err) return err;
  sv_descent_kernel<<<static_cast<unsigned>(k), bm::kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), static_cast<const int64_t*>(utable),
      static_cast<const int32_t*>(codes), static_cast<int>(k), st, shift,
      static_cast<uint4*>(gt), static_cast<int32_t*>(gt_dig),
      static_cast<uint4*>(eq), static_cast<int32_t*>(eq_dig),
      static_cast<int32_t*>(cls));
  return static_cast<int>(cudaGetLastError());
}

// The dense descent over one shard's stack int32[n_stack_rows, n_blocks,
// 2048]: eq starts as uni int32[n_blocks, 2048] (mode 1: uni & ~sign,
// mode 2: uni & sign), the steps are stack rows ``rows`` (host
// int32[n_steps] in descent order, -1 a zero plane) with the value's bit
// of step i at bit i of ``bits``.  Writes gt and eq int32[n_blocks, 2048].
// n_blocks >= 1.
extern "C" int bm_descent_rows(const void* stack, int n_stack_rows,
                               long long n_blocks, const void* uni,
                               const void* sign, int mode, const int* rows,
                               int n_steps, unsigned long long bits, void* gt,
                               void* eq, void* stream) {
  Steps st;
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL / bm::kBlockVec || mode < 0 ||
      mode > 2 || (mode != 0 && sign == nullptr) ||
      steps_of(rows, n_steps, bits, -1, n_stack_rows, &st) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long vecs = n_blocks * bm::kBlockVec;
  descent_rows_kernel<<<static_cast<unsigned>(vecs / kRowsThreads),
                        kRowsThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(stack), vecs,
      static_cast<const uint4*>(uni), static_cast<const uint4*>(sign), mode,
      st, static_cast<uint4*>(gt), static_cast<uint4*>(eq));
  return static_cast<int>(cudaGetLastError());
}
