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
// rows with the value's bits, and the blocks to walk as sorted block ids:
// every block that holds an entry in a plane or in the universe.  Every
// other block lies in FULL runs or is absent, and the host resolves it by
// interval algebra.  One CTA of 256 threads walks one block.  It looks up
// the block's class in every step's plane first (the steps' binary
// searches in parallel, into shared memory), then keeps gt and eq of its
// block in registers (two 16-byte vectors a thread) with the class that
// the port's set operation would give each after every step
// (core/bitvector._binary, core/blocks.plan_binary): absent, FULL, inside
// a FULL run, BIT, or D-GAP with its run count.  The classes follow the
// set operation's rules: the FULL / absent algebra, the D-GAP
// pass-throughs (FULL & GAP is the GAP block, FULL - GAP its complement,
// ...), GAP x GAP pairs of at most 4096 runs in all merged (absent when
// zero, FULL when all ones, else D-GAP), every other pair a BIT row, even
// a zero one.  A BIT plane row is one coalesced read, a D-GAP block is
// decoded from its store's mirror as gap_expand does.  A block whose eq
// becomes absent stops there: no later step changes it.  The kernel
// writes the block's gt row (and eq's where the caller asks) with its
// wave digest as K1 does, and both final classes; the host builds the
// result vectors from them (BIT rows as they are, D-GAP rows re-encoded
// by gap_compress).
//
// descent_rows, the dense form: one shard's stack int32[K, n_blocks,
// 2048] (sharded_sv's layout), the universe a row (ANDed with the sign row
// or its complement in modes 2 and 1), the steps stack rows (-1: a zero
// plane).  One CTA per block row.
//
// Bound on this card: the bytes, each stepped plane's BIT rows (and D-GAP
// runs) and the universe's read once, the results written once.  Both
// kernels issue the loads of the next step's row before the current
// step's logic, so a CTA keeps two rows in flight.
#include "bm_common.cuh"

namespace {

constexpr int kMaxSteps = 64;
constexpr int kMergeMaxRuns = 4096;   // core/bitvector._GAP_MERGE_MAX_RUNS
constexpr unsigned kAll = 0xFFFFFFFFu;

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

// Class of block ``blk`` in plane ``p`` and its pool row (kBit) or store
// index (kGap).
__device__ int2 lookup(const bm::Plane& p, const int64_t* __restrict__ nb,
                       const int32_t* __restrict__ ent,
                       const int64_t* __restrict__ runs, int64_t blk) {
  const int64_t* b = nb + p.nb_off;
  int64_t lo = 0;
  int64_t hi = p.nb_len;
  while (lo < hi) {                      // first entry >= blk
    const int64_t mid = (lo + hi) >> 1;
    if (b[mid] < blk) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo < p.nb_len && b[lo] == blk) {
    const int32_t e = ent[p.nb_off + lo];
    if (e >= 0) return make_int2(kBit, e);
    if (e == -1) return make_int2(kFull, 0);
    return make_int2(kGap, -2 - e);
  }
  const int64_t* rs = runs + 2 * p.run_off;
  lo = 0;
  hi = p.run_len;
  while (lo < hi) {                      // first run starting after blk
    const int64_t mid = (lo + hi) >> 1;
    if (rs[2 * mid] <= blk) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return make_int2(lo > 0 && blk < rs[2 * (lo - 1) + 1] ? kRun : kZero, 0);
}

// Bits lo..hi of a word, 0 <= lo <= hi <= 31.
__device__ __forceinline__ uint32_t span_mask(int lo, int hi) {
  return static_cast<uint32_t>((2ull << hi) - (1ull << lo));
}

// Words bit0 / 32 .. + 3 of D-GAP block g of the plane's store: the run
// holding bit0 by a binary search of the block's ends, then a walk
// (gap_rows.cu gap_expand).
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

__device__ __forceinline__ const uint4* row_of(const bm::Plane& p, int r) {
  return reinterpret_cast<const uint4*>(p.pool) +
         static_cast<size_t>(r) * bm::kBlockVec;
}

// The operand of class ``cls`` (BIT rows come from ``pre``, loaded ahead).
__device__ __forceinline__ State operand(const bm::Plane& p, int cls,
                                         int idx,
                                         const uint4 (&pre)[bm::kVecPerThread]) {
  State s;
  s.cls = cls;
  s.runs = cls == kGap ? __ldg(p.offs + idx + 1) - __ldg(p.offs + idx) : 0;
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) {
    if (cls == kBit) {
      s.v[j] = pre[j];
    } else if (cls == kGap) {
      s.v[j] = gap_vec(p, idx, (threadIdx.x + j * bm::kThreads) * 128);
    } else {
      s.v[j] = fill(cls == kFull || cls == kRun ? kAll : 0u);
    }
  }
  return s;
}

// Class of a OP b from the operands' classes; ``runs``: the result's run
// count where it is a D-GAP pass-through.
__device__ __forceinline__ int pair_class(int op, int sa, int sb, int na,
                                          int nb, int& runs) {
  const bool ra = sa == kRun, rb = sb == kRun;
  const bool za = sa == kZero, zb = sb == kZero;
  const bool fa = ra || sa == kFull, fb = rb || sb == kFull;
  const bool ga = sa == kGap, gb = sb == kGap;
  if (op == kAnd) {
    if (ra && rb) return kRun;
    if (za || zb) return kZero;
    if (fa && fb) return kFull;
    if (ga && fb) { runs = na; return kGap; }
    if (fa && gb) { runs = nb; return kGap; }
  } else if (op == kOr) {
    if (ra || rb) return kRun;
    if (za && zb) return kZero;
    if (fa || fb) return kFull;
    if (ga && zb) { runs = na; return kGap; }
    if (za && gb) { runs = nb; return kGap; }
  } else {
    if (ra && zb) return kRun;
    if (za || fb) return kZero;
    if (fa && zb) return kFull;
    if (ga && zb) { runs = na; return kGap; }
    if (fa && gb) { runs = nb; return kGap; }   // the complement of b
  }
  if (ga && gb) return na + nb <= kMergeMaxRuns ? kMerge : kBit;
  return kBit;
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
  bool nz = false;
  bool ones = true;
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) {
    r.v[j] = op4(op, a.v[j], b.v[j]);
    nz |= (r.v[j].x | r.v[j].y | r.v[j].z | r.v[j].w) != 0u;
    ones &= (r.v[j].x & r.v[j].y & r.v[j].z & r.v[j].w) == kAll;
  }
  if (r.cls == kMerge) {
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

__device__ __forceinline__ void load_row(const uint4* row,
                                         uint4 (&v)[bm::kVecPerThread]) {
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) {
    v[j] = bm::load_once(row + threadIdx.x + j * bm::kThreads);
  }
}

__global__ void __launch_bounds__(bm::kThreads)
sv_descent_kernel(const int64_t* __restrict__ table,
                  const int64_t* __restrict__ nb,
                  const int32_t* __restrict__ ent,
                  const int64_t* __restrict__ runs,
                  const int64_t* __restrict__ utable,
                  const int64_t* __restrict__ unb,
                  const int32_t* __restrict__ uent,
                  const int64_t* __restrict__ uruns,
                  const int64_t* __restrict__ blocks, int k, Steps steps,
                  uint4* __restrict__ gt_out, int32_t* __restrict__ gt_dig,
                  uint4* __restrict__ eq_out, int32_t* __restrict__ eq_dig,
                  uint8_t* __restrict__ cls_out) {
  // the steps' planes, then the universe's; each one's class at this block
  __shared__ bm::Plane sp[kMaxSteps + 1];
  __shared__ int s_cls[kMaxSteps + 1];
  __shared__ int s_idx[kMaxSteps + 1];
  __shared__ uint32_t tail[bm::kBlockVec];
  __shared__ int part[bm::kWarps];
  const int n = steps.n;
  int64_t* raw = reinterpret_cast<int64_t*>(sp);
  for (int j = threadIdx.x; j < (n + 1) * bm::kPlaneCols; j += blockDim.x) {
    const int s = j / bm::kPlaneCols;
    const int c = j - s * bm::kPlaneCols;
    raw[j] = s < n ? table[static_cast<int64_t>(steps.rows[s]) *
                           bm::kPlaneCols + c]
                   : utable[c];
  }
  __syncthreads();
  const int64_t blk = blocks[blockIdx.x];
  if (threadIdx.x <= n) {
    const int s = threadIdx.x;
    const int2 r = s < n ? lookup(sp[s], nb, ent, runs, blk)
                         : lookup(sp[n], unb, uent, uruns, blk);
    s_cls[s] = r.x;
    s_idx[s] = r.y;
  }
  __syncthreads();
  uint4 pre[bm::kVecPerThread];
  if (s_cls[n] == kBit) load_row(row_of(sp[n], s_idx[n]), pre);
  State eq = operand(sp[n], s_cls[n], s_idx[n], pre);
  State gt;
  gt.cls = kZero;
  gt.runs = 0;
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) gt.v[j] = fill(0u);
  if (n > 0 && s_cls[0] == kBit) load_row(row_of(sp[0], s_idx[0]), pre);
  for (int i = 0; i < n && eq.cls != kZero; ++i) {
    uint4 cur[bm::kVecPerThread];
#pragma unroll
    for (int j = 0; j < bm::kVecPerThread; ++j) cur[j] = pre[j];
    if (i + 1 < n && s_cls[i + 1] == kBit) {
      load_row(row_of(sp[i + 1], s_idx[i + 1]), pre);
    }
    const State p = operand(sp[i], s_cls[i], s_idx[i], cur);
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
    cls_out[blockIdx.x] = static_cast<uint8_t>(gt.cls);
    cls_out[k + blockIdx.x] = static_cast<uint8_t>(eq.cls);
  }
}

__global__ void __launch_bounds__(bm::kThreads)
descent_rows_kernel(const uint4* __restrict__ stack, int64_t plane_vecs,
                    const uint4* __restrict__ uni,
                    const uint4* __restrict__ sign, int mode, Steps steps,
                    uint4* __restrict__ gt_out, uint4* __restrict__ eq_out) {
  __shared__ int s_rows[kMaxSteps];
  const int n = steps.n;
  if (threadIdx.x < n) s_rows[threadIdx.x] = steps.rows[threadIdx.x];
  __syncthreads();
  const size_t base = static_cast<size_t>(blockIdx.x) * bm::kBlockVec;
  uint4 eq[bm::kVecPerThread];
  uint4 gt[bm::kVecPerThread];
  load_row(uni + base, eq);
  if (mode != 0) {
    uint4 s[bm::kVecPerThread];
    load_row(sign + base, s);
#pragma unroll
    for (int j = 0; j < bm::kVecPerThread; ++j) {
      eq[j] = op4(mode == 2 ? kAnd : kSub, eq[j], s[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) gt[j] = fill(0u);
  uint4 pre[bm::kVecPerThread];
  if (n > 0 && s_rows[0] >= 0) load_row(stack + s_rows[0] * plane_vecs + base,
                                        pre);
  for (int i = 0; i < n; ++i) {
    uint4 p[bm::kVecPerThread];
#pragma unroll
    for (int j = 0; j < bm::kVecPerThread; ++j) {
      p[j] = s_rows[i] >= 0 ? pre[j] : fill(0u);
    }
    if (i + 1 < n && s_rows[i + 1] >= 0) {
      load_row(stack + s_rows[i + 1] * plane_vecs + base, pre);
    }
    const bool one = (steps.bits >> i) & 1ull;
#pragma unroll
    for (int j = 0; j < bm::kVecPerThread; ++j) {
      if (one) {
        eq[j] = op4(kAnd, eq[j], p[j]);
      } else {
        gt[j] = op4(kOr, gt[j], op4(kAnd, eq[j], p[j]));
        eq[j] = op4(kSub, eq[j], p[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < bm::kVecPerThread; ++j) {
    gt_out[base + threadIdx.x + j * bm::kThreads] = gt[j];
    eq_out[base + threadIdx.x + j * bm::kThreads] = eq[j];
  }
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

}  // namespace

// The structured descent over k >= 1 sorted block ids ``blocks`` int64[k]:
// the column's plane table (table int64[n_planes, 9], nb, ent, runs), the
// universe's one-plane table (utable int64[1, 9], unb, uent, uruns), the
// steps' plane rows ``rows`` (host int32[n_steps], n_steps <= 64, in
// descent order) with the value's bit of step i at bit i of ``bits``.
// Writes gt int32[k, 2048] and gt_dig int32[k, 64]; eq and eq_dig the same
// when eq is not null; cls uint8[2 k]: gt's classes, then eq's.  Returns
// the CUDA error of the launch (0 = launched).
extern "C" int bm_sv_descent(const void* table, int n_planes, const void* nb,
                             const void* ent, const void* runs,
                             const void* utable, const void* unb,
                             const void* uent, const void* uruns,
                             const void* blocks, long long k,
                             const int* rows, int n_steps,
                             unsigned long long bits, void* gt, void* gt_dig,
                             void* eq, void* eq_dig, void* cls,
                             void* stream) {
  Steps st;
  if (k <= 0 || k > 0x7FFFFFFFLL || (eq == nullptr) != (eq_dig == nullptr) ||
      steps_of(rows, n_steps, bits, 0, n_planes, &st) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sv_descent_kernel<<<static_cast<unsigned>(k), bm::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), static_cast<const int64_t*>(nb),
      static_cast<const int32_t*>(ent), static_cast<const int64_t*>(runs),
      static_cast<const int64_t*>(utable), static_cast<const int64_t*>(unb),
      static_cast<const int32_t*>(uent), static_cast<const int64_t*>(uruns),
      static_cast<const int64_t*>(blocks), static_cast<int>(k), st,
      static_cast<uint4*>(gt), static_cast<int32_t*>(gt_dig),
      static_cast<uint4*>(eq), static_cast<int32_t*>(eq_dig),
      static_cast<uint8_t*>(cls));
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
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL || mode < 0 || mode > 2 ||
      (mode != 0 && sign == nullptr) ||
      steps_of(rows, n_steps, bits, -1, n_stack_rows, &st) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  descent_rows_kernel<<<static_cast<unsigned>(n_blocks), bm::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(stack), n_blocks * bm::kBlockVec,
      static_cast<const uint4*>(uni), static_cast<const uint4*>(sign), mode,
      st, static_cast<uint4*>(gt), static_cast<uint4*>(eq));
  return static_cast<int>(cudaGetLastError());
}
