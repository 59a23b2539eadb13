// rs_select and rs_rank: the rank/select index's batches, in one launch
// each.
//
// They replace the JAX package's jitted select_flat
// (bitmagic_tpu/ops/select.py:77, with _in_wave_descent :54 and
// bitops.word_select32) and _rank_in_rows (bitmagic_tpu/core/rs_index.py:
// 191), and the host numpy of RSIndex.select_batch / rank_batch around
// them (rs_index.py:106-185: the segment search, the FULL offsets, the
// GAP rank_in_block / select_in_block).
//
// The index's device tables (core/rs_index.py, ops/select.py SEG_COLS,
// select_tables and rank_tables):
//   cum0    int64[m + 1]      0, then the inclusive ones prefix over segments
//   sel     int64[m + 1, 2]   per segment the position its answers count
//                             from and (a, b): BIT slot / rank before its
//                             row, D-GAP -2 - first run / run after its last
//   nb      int64[m]          the segments' first blocks
//   rec     int64[m + 2, 2]   per segment row (row 0 a sentinel, row m + 1
//                             the total) the ones before it and a packed
//                             word: route (bits 0-1) and its payload
//                             (select.rank_tables)
//   runs    int32[R, 2]       per D-GAP run its block-local end and its
//                             block's inclusive ones count up to it
//   pool    uint32[r, 2048], gwc int32[r * 64] (inclusive wave prefix)
//   gws     int32[r * 8]      gwc at the end of every 8 waves
//   gcs     int32[R / 8]      the runs' ones counts at every 8th run
//   ges     int32[R / 8]      the runs' ends at every 8th run
//   wsp     int32[r * 64]     per wave the ones of its first 1, 2 and 3
//                             32-byte sectors, 10 bits each
//   wrk     int32[r * 64, 2]  per wave the ones before it (gwc's exclusive
//                             form) beside its wsp entry
//
// rs_select, per 1-based rank x in [1, total] (else -1): the segment is
// the lower bound of x in cum0 and rem = x - cum0[segment - 1].  FULL:
// first bit + rem - 1 (int64: FULL runs pass 2^31 bits).  D-GAP: the
// first run of the block whose ones count reaches rem, then first bit +
// rem - 1 + end - ones + 1.  BIT: the pool rank g = rem + the rank before
// the slot's row; the row's 8 gws entries give the 8 waves holding it,
// one 32-byte sector of gwc (with the same sector of wsp) the wave, the
// wave's wsp entry the 32-byte sector of the wave holding the bit.
// select_flat is the same wave step over the whole pool, its 8-wave group
// the lower bound of the rank in gws.
//
// Bound on this card: the bytes moved, 8 B of query in and 8 B of answer
// out each, plus one 128 B wave per BIT-class query; the tables (a few
// hundred KB) are L2-resident and read once.  The first port ran a thread
// per query through ~11 dependent cum0 loads, 6 seg loads, a 6-step gwc
// search and eight 16-byte loads of the wave, every warp load touching 32
// lines: ~500 B of L2 sectors per query.  This design: persistent CTAs of
// 1024 threads stage cum0 (whole, or every S-th entry when it is too large),
// sel, gws and gcs in shared memory (those that fit the wrapper's budget,
// in that order; the others are read in global memory), every batch, one
// query included (staging won at every batch size measured; PERF.md), so
// a query leaves L2 only for one sector of gwc and wsp
// and one of its wave (BIT) or one 8-run window of the runs (D-GAP), each
// group of loads issued together.  A thread per query: an 8-lane group
// reading the whole wave together and finding the word by shuffles was
// measured and lost (instruction-bound; PERF.md).
//
// rs_rank, per id: an upper-bound search of its block in nb gives the
// segment s (0: before the first); outside it (a block past the segment's
// end) the answer is the ones before segment s + 1, rec[s + 1].  FULL:
// ones before + offset + 1; D-GAP: the block's first run whose end
// reaches the bit, then its ones count, less (end - bit) for a run of
// ones (what min(ones up to the run, p + bit) of ops/select.rs_rank
// gives); BIT: the ones before the wave less the row's base, the sector
// prefix of the wave's wsp entry (both in one 8-byte wrk entry), and the
// masked popcount of the one 32-byte sector holding the bit.  rank_flat is
// that BIT step over a whole pool (ShardedRSIndex).  The first port ran a
// thread per id through an 11-step search of nb, up to 6 loads of its 88 B
// segment row, a 17-step search of every run key and eight 16 B loads of
// the wave, all dependent L2 loads.
// This design: persistent CTAs of 1024 threads stage nb (whole, or every
// S-th entry), the 16 B rank record per segment and every 8th run end in
// shared memory (those that fit the wrapper's budget, in that order), so
// an id leaves L2 only for one 8-run window of the runs (D-GAP: 64 B) or
// for its wave's wrk entry and one 32-byte sector of the wave (BIT), each
// group issued together.  wrk interleaves gwc and wsp so that a rank reads
// one line where it read two (measured: rank_flat 0.0315 against 0.0383
// ms at 1M ids; PERF.md).
//
// Lower and upper bounds reproduce torch.searchsorted left and right on
// ties (zero-count segments and empty waves repeat prefix values).
#include "bm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageThreads = 1024;          // the select kernels' CTAs
constexpr int kWaveWords = 32;
constexpr int kWaveVec = kWaveWords / 4;     // uint4 per 128 B wave
constexpr int kBlockWaves = 64;
// rs_rank's record routes (ops/select.rank_tables: bits 0-1 of a record's
// packed word, its payload above them)
constexpr int kRouteFull = 1;
constexpr int kRouteBit = 2;
constexpr int kRouteGap = 3;

// First i in [0, n) with a[i] >= v (n if none): searchsorted left.
template <typename T>
__device__ __forceinline__ int64_t lower_bound(const T* __restrict__ a,
                                               int64_t n, T v) {
  int64_t lo = 0;
  int64_t hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// First i in [0, n) with a[i] > v (n if none): searchsorted right.
__device__ __forceinline__ int64_t upper_bound(const int64_t* __restrict__ a,
                                               int64_t n, int64_t v) {
  int64_t lo = 0;
  int64_t hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Position of the r-th (1-based) set bit of w: the binary popcount
// descent of bitops.word_select32, step for step (so out-of-range r gives
// what the plain version gives).
__device__ __forceinline__ int word_select32(uint32_t w, int r) {
  int pos = 0;
  uint32_t cur = w;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const uint32_t lo = cur & ((1u << width) - 1u);
    const int c = __popc(lo);
    if (r > c) {
      r -= c;
      pos += width;
      cur >>= width;
    } else {
      cur = lo;
    }
  }
  return pos;
}

// Ones among bits [0, bit] of a 128 B wave (bit in [0, 1024)), from its
// wsp entry e (the ones of its first 1, 2 and 3 32-byte sectors) and the
// sector holding the bit, (lo, hi).
__device__ __forceinline__ int sector_ones(uint4 lo, uint4 hi, uint32_t e,
                                           int bit) {
  const int k = bit >> 8;
  const int wi = (bit >> 5) & 7;
  const uint32_t part = (2u << (bit & 31)) - 1u;   // all 32 bits at 31
  const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  int n = k == 0 ? 0 : static_cast<int>((e >> (10 * (k - 1))) & 1023u);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    n += j < wi ? __popc(x[j]) : j == wi ? __popc(x[j] & part) : 0;
  }
  return n;
}

// Ones among bits [0, bit] of wave ``wave`` of the pool and every wave
// before it (bit in [0, 1024)): the wave's wrk entry (the ones before it,
// its sector prefix) and the one 32-byte sector holding the bit (its
// second half only where the bit lies there), the loads issued together
// (the sector's without an L1 line: ids rarely share one).
__device__ __forceinline__ int64_t pool_rank(const uint4* __restrict__ pool,
                                             const int2* __restrict__ wrk,
                                             long long wave, int bit) {
  const uint4* sec = pool + wave * kWaveVec + 2 * (bit >> 8);
  const uint4 lo = bm::load_once(sec);
  const uint4 hi = (bit & 128) ? bm::load_once(sec + 1)
                               : make_uint4(0u, 0u, 0u, 0u);
  const int2 w = __ldg(wrk + wave);
  return static_cast<int64_t>(w.x) +
         sector_ones(lo, hi, static_cast<uint32_t>(w.y), bit);
}

// The select kernels' arguments.  cum_stride S >= 1: every S-th entry of
// cum0 (select_flat: of gws) is staged in shared memory (S = 1: the whole
// table).  stage_*: sel, gws (rs_select) and gcs staged whole (1) or read
// in global memory (0).
struct SelectArgs {
  const int64_t* cum0;
  long long seg_rows;            // m + 1
  const longlong2* sel;
  const int32_t* runs;           // int32[n_runs, 2]
  const int32_t* gcs;
  long long n_runs;
  const uint4* pool;
  const int32_t* gwc;
  const int32_t* gws;
  const int32_t* wsp;            // int32[n_waves] sector prefix per wave
  long long n_waves;
  const int64_t* ranks;          // rs_select
  const int32_t* ranks32;        // select_flat
  long long n;
  long long total;
  int64_t* out;
  int cum_stride;
  int stage_sel, stage_gws, stage_gcs;
};

// The staged tables in shared memory (each region 16-byte aligned).
struct Staged {
  const longlong2* sel;
  const int64_t* cum;
  const int32_t* gws;
  const int32_t* gcs;
};

__device__ __forceinline__ long long round16(long long bytes) {
  return (bytes + 15) & ~15LL;
}

// Copy ``bytes`` (a multiple of 4) into a 16-byte aligned ``dst``, 16 B a
// load where ``src`` is aligned to 16, four loads in flight a thread.
__device__ __forceinline__ void stage_bytes(void* dst, const void* src,
                                            long long bytes) {
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const long long nv = bytes >> 4;
    const uint4* s = static_cast<const uint4*>(src);
    uint4* d = static_cast<uint4*>(dst);
    for (long long k0 = threadIdx.x; k0 < nv; k0 += 4LL * blockDim.x) {
      uint4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long k = k0 + j * static_cast<long long>(blockDim.x);
        if (k < nv) v[j] = __ldg(s + k);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long k = k0 + j * static_cast<long long>(blockDim.x);
        if (k < nv) d[k] = v[j];
      }
    }
    done = nv << 2;
  }
  for (long long k = done + threadIdx.x; k < (bytes >> 2); k += blockDim.x) {
    static_cast<uint32_t*>(dst)[k] =
        __ldg(static_cast<const uint32_t*>(src) + k);
  }
}

// Every S-th entry of a[0, n): smp[j] = a[min(j S + S - 1, n - 1)].
template <typename T>
__device__ __forceinline__ void stage_sample(T* smp, const T* a, long long n,
                                             int S) {
  if (S == 1) {
    stage_bytes(smp, a, n * static_cast<long long>(sizeof(T)));
    return;
  }
  const long long ns = (n + S - 1) / S;
  for (long long j = threadIdx.x; j < ns; j += blockDim.x) {
    const long long k = j * S + S - 1;
    smp[j] = __ldg(a + (k < n ? k : n - 1));
  }
}

// Lower bound in shared memory (plain loads).
template <typename T>
__device__ __forceinline__ long long lb_smem(const T* a, long long n, T v) {
  long long lo = 0;
  long long hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Lower bound of v in a[0, n) (global), through its staged sample of
// stride S >= 1 (stage_sample): the sample's search names S entries, of
// which a global search finishes.
template <typename T>
__device__ __forceinline__ long long sampled_lb(const T* smp, int S,
                                                const T* a, long long n,
                                                T v) {
  const long long ns = (n + S - 1) / S;
  const long long J = lb_smem(smp, ns, v);
  if (J == ns) return n;
  const long long lo = J * S;
  const long long hi = lo + S - 1 < n - 1 ? lo + S - 1 : n - 1;
  return lo + lower_bound(a + lo, hi - lo, v);
}

// First run k in [lo, hi) whose ones count reaches v (hi if none).
__device__ __forceinline__ long long lb_runs(const int32_t* runs,
                                             long long lo, long long hi,
                                             long long v) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(runs + 2 * mid + 1) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Of the 8 prefix entries in v (nondecreasing), how many are below g;
// ``prev`` becomes the last of them (unchanged if none).
__device__ __forceinline__ int count_below(uint4 lo, uint4 hi, int32_t g,
                                           int32_t& prev) {
  const int32_t e[8] = {
      static_cast<int32_t>(lo.x), static_cast<int32_t>(lo.y),
      static_cast<int32_t>(lo.z), static_cast<int32_t>(lo.w),
      static_cast<int32_t>(hi.x), static_cast<int32_t>(hi.y),
      static_cast<int32_t>(hi.z), static_cast<int32_t>(hi.w)};
  int c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (e[k] < g) {
      ++c;
      prev = e[k];
    }
  }
  return c;
}

// The 8-wave group of gwc at ``at``: how many of its prefix entries
// (nondecreasing) are below g, which is the wave's index in the group;
// ``prev`` becomes the last of them (unchanged if none) and ``e`` the
// wave's wsp entry.  Both sectors are read at once.
__device__ __forceinline__ int wave_in_group(const int32_t* __restrict__ gwc,
                                             const int32_t* __restrict__ wsp,
                                             long long at, int32_t g,
                                             int32_t& prev, uint32_t& e) {
  const uint4* q = reinterpret_cast<const uint4*>(gwc + at);
  const uint4* w = reinterpret_cast<const uint4*>(wsp + at);
  const uint4 q0 = __ldg(q), q1 = __ldg(q + 1);
  const uint4 w0 = __ldg(w), w1 = __ldg(w + 1);
  const uint32_t ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const int c = count_below(q0, q1, g, prev);
  e = ws[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    if (c == k) e = ws[k];
  }
  return c;
}

// Bit offset in wave ``wave`` of its rem-th set bit, as _in_wave_descent
// finds it: the first word whose inclusive prefix reaches rem (the last
// word if none), then word_select32 of the rank left in it.  The wave's
// sector prefix e (its wsp entry: the ones of its first 1, 2 and 3
// 32-byte sectors, 10 bits each) names the sector holding that word, so
// one sector is read.
__device__ __forceinline__ int wave_select(const uint4* __restrict__ pool,
                                           uint32_t e, long long wave,
                                           int rem) {
  const int e1 = static_cast<int>(e & 1023u);
  const int e2 = static_cast<int>((e >> 10) & 1023u);
  const int e3 = static_cast<int>(e >> 20);
  const int k = (e1 < rem) + (e2 < rem) + (e3 < rem);
  int before = k == 0 ? 0 : k == 1 ? e1 : k == 2 ? e2 : e3;
  const uint4* sec = pool + wave * kWaveVec + 2 * k;
  const uint4 a = __ldg(sec);
  const uint4 b = __ldg(sec + 1);
  const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int w = 7;
  uint32_t word = x[7];
  bool found = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (!found) {
      const int after = before + __popc(x[j]);
      if (after >= rem || j == 7) {
        found = true;
        w = j;
        word = x[j];
      } else {
        before = after;
      }
    }
  }
  return (k * 8 + w) * 32 + word_select32(word, rem - before);
}

__device__ __forceinline__ Staged stage_select(const SelectArgs& a,
                                               uint4* smem, bool flat) {
  char* p = reinterpret_cast<char*>(smem);
  Staged t{nullptr, nullptr, nullptr, nullptr};
  if (a.stage_sel) {
    stage_bytes(p, a.sel, a.seg_rows * 16);
    t.sel = reinterpret_cast<const longlong2*>(p);
    p += round16(a.seg_rows * 16);
  }
  if (!flat) {
    stage_sample(reinterpret_cast<int64_t*>(p), a.cum0, a.seg_rows,
                 a.cum_stride);
    t.cum = reinterpret_cast<const int64_t*>(p);
    p += round16((a.seg_rows + a.cum_stride - 1) / a.cum_stride * 8);
  }
  const long long ng = a.n_waves / 8;
  if (flat) {
    stage_sample(reinterpret_cast<int32_t*>(p), a.gws, ng, a.cum_stride);
    t.gws = reinterpret_cast<const int32_t*>(p);
    p += round16((ng + a.cum_stride - 1) / a.cum_stride * 4);
  } else if (!flat && a.stage_gws) {
    stage_bytes(p, a.gws, ng * 4);
    t.gws = reinterpret_cast<const int32_t*>(p);
    p += round16(ng * 4);
  }
  if (a.stage_gcs) {
    stage_bytes(p, a.gcs, (a.n_runs / 8) * 4);
    t.gcs = reinterpret_cast<const int32_t*>(p);
  }
  __syncthreads();
  return t;
}

// The D-GAP run of a block (runs [lo, hi)) where its ones count first
// reaches rem (hi if none, clamped to the last run), as (end, ones).  With
// the run samples staged, the sample search names an 8-run window read
// in one round trip (4 x 16 B); else a binary search in global memory.
__device__ __forceinline__ int2 gap_run(const SelectArgs& a, const Staged& t,
                                        long long lo, long long hi,
                                        int64_t rem) {
  if (a.stage_gcs) {
    const long long jlo = lo >> 3;
    const long long jhi = hi >> 3;
    const long long J = jlo + lb_smem(t.gcs + jlo, jhi - jlo,
                                      static_cast<int32_t>(rem));
    const long long s0 = J * 8 > lo ? J * 8 : lo;
    const long long s1 = J < jhi ? J * 8 + 7 : hi;
    if (J * 8 + 8 <= a.n_runs) {         // the window [8J, 8J + 8)
      const uint4* q = reinterpret_cast<const uint4*>(a.runs) + J * 4;
      const uint4 v0 = __ldg(q), v1 = __ldg(q + 1), v2 = __ldg(q + 2),
                  v3 = __ldg(q + 3);
      const int32_t e[16] = {
          static_cast<int32_t>(v0.x), static_cast<int32_t>(v0.y),
          static_cast<int32_t>(v0.z), static_cast<int32_t>(v0.w),
          static_cast<int32_t>(v1.x), static_cast<int32_t>(v1.y),
          static_cast<int32_t>(v1.z), static_cast<int32_t>(v1.w),
          static_cast<int32_t>(v2.x), static_cast<int32_t>(v2.y),
          static_cast<int32_t>(v2.z), static_cast<int32_t>(v2.w),
          static_cast<int32_t>(v3.x), static_cast<int32_t>(v3.y),
          static_cast<int32_t>(v3.z), static_cast<int32_t>(v3.w)};
      int k = static_cast<int>(s1 - J * 8);   // the default: s1
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        if (J * 8 + j >= s0 && J * 8 + j < s1 && e[2 * j + 1] >= rem) k = j;
      }
      int2 out = make_int2(e[0], e[1]);
#pragma unroll
      for (int j = 1; j < 8; ++j) {
        if (k == j) out = make_int2(e[2 * j], e[2 * j + 1]);
      }
      return out;
    }
    lo = s0;
    hi = s1;
  }
  long long r = lb_runs(a.runs, lo, hi, rem);
  if (r > a.n_runs - 1) r = a.n_runs - 1;
  return __ldg(reinterpret_cast<const int2*>(a.runs) + r);
}

__global__ void __launch_bounds__(kStageThreads, 1)
rs_select_kernel(SelectArgs a) {
  extern __shared__ uint4 smem[];
  const Staged t = stage_select(a, smem, false);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                threadIdx.x;
  int64_t x = i < a.n ? __ldg(a.ranks + i) : 0;
  for (; i < a.n; i += stride) {
    const int64_t x_next = i + stride < a.n ? __ldg(a.ranks + i + stride)
                                            : 0;
    int64_t pos = -1;
    if (x >= 1 && x <= a.total) {
      const long long s = sampled_lb(t.cum, a.cum_stride, a.cum0,
                                     a.seg_rows, x);
      const int64_t rem = x - (a.cum_stride == 1 ? t.cum[s - 1]
                                                 : __ldg(a.cum0 + s - 1));
      const longlong2 rec = a.stage_sel ? t.sel[s] : __ldg(a.sel + s);
      const int32_t ra = static_cast<int32_t>(rec.y & 0xFFFFFFFFLL);
      const int32_t rb = static_cast<int32_t>(rec.y >> 32);
      pos = rec.x + rem - 1;                                  // FULL
      if (ra <= -2 && a.n_runs > 0) {                         // D-GAP
        const int2 e = gap_run(a, t, -2 - static_cast<long long>(ra), rb,
                               rem);
        pos += static_cast<int64_t>(e.x) - e.y + 1;
      } else if (ra >= 0 && a.n_waves > 0) {                  // BIT
        const long long w0 = static_cast<long long>(ra) * kBlockWaves;
        const int32_t g = static_cast<int32_t>(rem + rb);
        int32_t prev = rb;
        int J;
        if (a.stage_gws) {
          const int32_t* q = t.gws + static_cast<long long>(ra) * 8;
          J = 0;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (q[k] < g) {
              ++J;
              prev = q[k];
            }
          }
        } else {
          const uint4* q = reinterpret_cast<const uint4*>(
              a.gws + static_cast<long long>(ra) * 8);
          J = count_below(__ldg(q), __ldg(q + 1), g, prev);
        }
        long long wave;
        uint32_t e;
        if (J < 8) {
          wave = w0 + 8 * J + wave_in_group(a.gwc, a.wsp, w0 + 8 * J, g,
                                            prev, e);
        } else {                          // past the row (no valid rank)
          wave = w0 + kBlockWaves;
          if (wave > a.n_waves - 1) wave = a.n_waves - 1;
          prev = wave > 0 ? __ldg(a.gwc + wave - 1) : 0;
          e = static_cast<uint32_t>(__ldg(a.wsp + wave));
        }
        pos = rec.x + wave * (kWaveWords * 32) +
              wave_select(a.pool, e, wave, g - prev);
      }
    }
    a.out[i] = pos;
    x = x_next;
  }
}

__global__ void __launch_bounds__(kStageThreads, 1)
select_flat_kernel(SelectArgs a) {
  extern __shared__ uint4 smem[];
  const Staged t = stage_select(a, smem, true);
  const long long ng = a.n_waves / 8;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                threadIdx.x;
  int32_t x = i < a.n ? __ldg(a.ranks32 + i) : 0;
  for (; i < a.n; i += stride) {
    const int32_t x_next = i + stride < a.n
                               ? __ldg(a.ranks32 + i + stride) : 0;
    const long long J = sampled_lb(t.gws, a.cum_stride, a.gws, ng, x);
    int32_t prev = 0;
    long long wave;
    uint32_t e;
    if (J < ng) {
      if (J > 0) {
        prev = a.cum_stride == 1 ? t.gws[J - 1] : __ldg(a.gws + J - 1);
      }
      wave = 8 * J + wave_in_group(a.gwc, a.wsp, 8 * J, x, prev, e);
    } else {                              // past the pool's last one
      wave = a.n_waves - 1;
      prev = wave > 0 ? __ldg(a.gwc + wave - 1) : 0;
      e = static_cast<uint32_t>(__ldg(a.wsp + wave));
    }
    a.out[i] = wave * (kWaveWords * 32) + wave_select(a.pool, e, wave,
                                                      x - prev);
    x = x_next;
  }
}

// rs_rank's arguments.  nb_stride S >= 1: every S-th entry of nb is staged
// in shared memory (S = 1: the whole table); stage_rec / stage_ges: the
// records and the run-end samples staged whole (1) or read in global
// memory (0).
struct RankArgs {
  const int64_t* nb;
  long long n_seg;               // m
  const longlong2* rec;          // [m + 2]
  const int32_t* runs;           // int32[n_runs, 2]
  const int32_t* ges;            // int32[n_runs / 8]
  long long n_runs;
  const uint4* pool;
  const int2* wrk;               // int32[n_waves, 2]
  const int64_t* ids;
  long long n;
  int64_t* out;
  int nb_stride;
  int stage_rec, stage_ges;
};

struct RankStaged {
  const int64_t* nb;
  const longlong2* rec;
  const int32_t* ges;
};

__device__ __forceinline__ RankStaged stage_rank(const RankArgs& a,
                                                 uint4* smem) {
  char* p = reinterpret_cast<char*>(smem);
  RankStaged t{nullptr, nullptr, nullptr};
  stage_sample(reinterpret_cast<int64_t*>(p), a.nb, a.n_seg, a.nb_stride);
  t.nb = reinterpret_cast<const int64_t*>(p);
  p += round16((a.n_seg + a.nb_stride - 1) / a.nb_stride * 8);
  if (a.stage_rec) {
    stage_bytes(p, a.rec, (a.n_seg + 2) * 16);
    t.rec = reinterpret_cast<const longlong2*>(p);
    p += round16((a.n_seg + 2) * 16);
  }
  if (a.stage_ges) {
    stage_bytes(p, a.ges, (a.n_runs / 8) * 4);
    t.ges = reinterpret_cast<const int32_t*>(p);
  }
  __syncthreads();
  return t;
}

// Upper bound in shared memory (plain loads).
__device__ __forceinline__ long long ub_smem(const int64_t* a, long long n,
                                             int64_t v) {
  long long lo = 0;
  long long hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Upper bound of v in a[0, n) (global) through its staged sample of
// stride S >= 1, as sampled_lb.
__device__ __forceinline__ long long sampled_ub(const int64_t* smp, int S,
                                                const int64_t* a, long long n,
                                                int64_t v) {
  const long long ns = (n + S - 1) / S;
  const long long J = ub_smem(smp, ns, v);
  if (J == ns) return n;
  const long long lo = J * S;
  const long long hi = lo + S - 1 < n - 1 ? lo + S - 1 : n - 1;
  return lo + upper_bound(a + lo, hi - lo, v);
}

// The first run of a D-GAP block's runs [lo, hi) whose end reaches bit
// (the block's last run ends at 65535, so one does), as (end, ones); r
// becomes its index.  With the run-end samples staged, their search names
// an 8-run window read in one round trip (4 x 16 B); else a binary search
// of the block's runs in global memory.
__device__ __forceinline__ int2 rank_run(const RankArgs& a,
                                         const RankStaged& t, long long lo,
                                         long long hi, int bit,
                                         long long& r) {
  if (a.stage_ges) {
    const long long jlo = lo >> 3;
    const long long jhi = hi >> 3;
    const long long w = 8 * (jlo + lb_smem(t.ges + jlo, jhi - jlo,
                                           static_cast<int32_t>(bit)));
    int32_t e[16];
    if (w + 8 <= a.n_runs) {
      const uint4* q = reinterpret_cast<const uint4*>(a.runs) + w / 2;
      const uint4 v0 = __ldg(q), v1 = __ldg(q + 1), v2 = __ldg(q + 2),
                  v3 = __ldg(q + 3);
      const uint32_t u[16] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w,
                              v2.x, v2.y, v2.z, v2.w, v3.x, v3.y, v3.z, v3.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) e[j] = static_cast<int32_t>(u[j]);
    } else {                              // the table's last, short window
      const int2* q = reinterpret_cast<const int2*>(a.runs);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int2 v = w + j < a.n_runs ? __ldg(q + w + j) : make_int2(0, 0);
        e[2 * j] = v.x;
        e[2 * j + 1] = v.y;
      }
    }
    // the window's runs of this block before the one reached
    const long long s0 = w > lo ? w : lo;
    const long long s1 = w + 8 < hi ? w + 8 : hi;
    int k = static_cast<int>(s0 - w);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      k += (w + j >= s0 && w + j < s1 && e[2 * j] < bit) ? 1 : 0;
    }
    int2 out = make_int2(e[0], e[1]);
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      if (k == j) out = make_int2(e[2 * j], e[2 * j + 1]);
    }
    r = w + k;
    return out;
  }
  long long l = lo;
  long long h = hi - 1;
  while (l < h) {
    const long long mid = (l + h) >> 1;
    if (__ldg(a.runs + 2 * mid) < bit) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  r = l;
  return __ldg(reinterpret_cast<const int2*>(a.runs) + l);
}

__global__ void __launch_bounds__(kStageThreads, 1)
rs_rank_kernel(RankArgs a) {
  extern __shared__ uint4 smem[];
  const RankStaged t = stage_rank(a, smem);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                threadIdx.x;
  int64_t q = i < a.n ? __ldg(a.ids + i) : 0;
  for (; i < a.n; i += stride) {
    const int64_t q_next = i + stride < a.n ? __ldg(a.ids + i + stride) : 0;
    const int64_t blk = q >> 16;
    const int bit = static_cast<int>(q & 0xFFFF);
    const long long s = sampled_ub(t.nb, a.nb_stride, a.nb, a.n_seg, blk);
    const longlong2 rec = a.stage_rec ? t.rec[s] : __ldg(a.rec + s);
    const int64_t b0 = s == 0 ? 0
                       : a.nb_stride == 1 ? t.nb[s - 1]
                                          : __ldg(a.nb + s - 1);
    const int route = static_cast<int>(rec.y & 3);
    const int64_t pay = rec.y >> 2;
    int64_t ans = rec.x;
    if (s == 0 || (route == kRouteFull ? blk >= pay : blk != b0)) {
      // past the segment: the ones before the next one
      ans = a.stage_rec ? t.rec[s + 1].x : __ldg(a.rec + s + 1).x;
    } else if (route == kRouteFull) {
      ans += q - (b0 << 16) + 1;
    } else if (route == kRouteGap) {
      const long long lo = pay & 0x7FFFFFFF;
      long long r;
      const int2 e = rank_run(a, t, lo, lo + ((pay >> 31) & 0x1FFFF), bit,
                              r);
      // a run of ones when its parity from the block's first run says so
      const bool ones = (((pay >> 48) ^ (r - lo)) & 1) != 0;
      ans += ones ? e.y - (e.x - bit) : e.y;
    } else if (route == kRouteBit) {
      const long long wave = (pay & ((1LL << 30) - 1)) * kBlockWaves +
                             (bit >> 10);
      ans += pool_rank(a.pool, a.wrk, wave, bit & 1023) - (pay >> 30);
    }
    a.out[i] = ans;
    q = q_next;
  }
}

__global__ void __launch_bounds__(kThreads)
rank_flat_kernel(const uint4* __restrict__ pool,
                 const int2* __restrict__ wrk, int64_t n_waves,
                 const int64_t* __restrict__ rel, int64_t n,
                 int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t b = rel[i];
  const int64_t wave = b >> 10;
  if (b < 0 || wave >= n_waves) {                      // no read past it
    out[i] = -1;
    return;
  }
  out[i] = pool_rank(pool, wrk, wave, static_cast<int>(b & 1023));
}

int grid(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

bool bad_count(long long n) {
  return n <= 0 || (n + kThreads - 1) / kThreads > 0x7FFFFFFFLL;
}

bm::LaunchCache g_select, g_flat, g_rank;

// Launch a staging kernel as persistent CTAs of kStageThreads with ``smem``
// bytes of staged tables, as many CTAs as the queries need and the card
// holds at once.
template <typename K, typename A>
int launch_staged(K kernel, const A& a, long long smem, cudaStream_t st,
                  bm::LaunchCache& cache) {
  int blocks = 0;
  const int err = bm::persistent_grid(
      kernel, cache, kStageThreads, static_cast<int>(smem),
      (a.n + kStageThreads - 1) / kStageThreads, &blocks);
  if (err) return err;
  kernel<<<blocks, kStageThreads, static_cast<size_t>(smem), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out int64[n]: the position of each 1-based rank of ranks int64[n], -1
// outside [1, total], over cum0 int64[seg_rows], sel int64[seg_rows, 2],
// runs int32[n_runs, 2], gcs int32[n_runs / 8], pool, gwc int32[n_waves],
// gws int32[n_waves / 8] and wsp int32[n_waves]
// (ops/select.select_tables).  seg_rows = m + 1 >= 1; n_runs may be 0 (no
// D-GAP block), n_waves may be 0 (no BIT block; else a multiple of 64).
// Staging: every cum_stride-th entry of cum0 (>= 1), stage_sel /
// stage_gws / stage_gcs (0 or 1), ``smem`` the bytes they take (at most
// 227 KiB).  Returns the CUDA error of the launch (0 = launched).
extern "C" int bm_rs_select(const void* cum0, long long seg_rows,
                            const void* sel, const void* runs,
                            const void* gcs, long long n_runs,
                            const void* pool, const void* gwc,
                            const void* gws, const void* wsp,
                            long long n_waves,
                            const void* ranks, long long n, long long total,
                            void* out, int cum_stride, int stage_sel,
                            int stage_gws, int stage_gcs, long long smem,
                            void* stream) {
  if (bad_count(n) || seg_rows < 1 || n_runs < 0 || n_waves < 0 ||
      n_waves % kBlockWaves || cum_stride < 1 || smem <= 0 ||
      smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SelectArgs a{};
  a.cum0 = static_cast<const int64_t*>(cum0);
  a.seg_rows = seg_rows;
  a.sel = static_cast<const longlong2*>(sel);
  a.runs = static_cast<const int32_t*>(runs);
  a.gcs = static_cast<const int32_t*>(gcs);
  a.n_runs = n_runs;
  a.pool = static_cast<const uint4*>(pool);
  a.gwc = static_cast<const int32_t*>(gwc);
  a.gws = static_cast<const int32_t*>(gws);
  a.wsp = static_cast<const int32_t*>(wsp);
  a.n_waves = n_waves;
  a.ranks = static_cast<const int64_t*>(ranks);
  a.n = n;
  a.total = total;
  a.out = static_cast<int64_t*>(out);
  a.cum_stride = cum_stride;
  a.stage_sel = stage_sel;
  a.stage_gws = stage_gws;
  a.stage_gcs = stage_gcs;
  return launch_staged(rs_select_kernel, a, smem,
                       static_cast<cudaStream_t>(stream), g_select);
}

// out int64[n]: global bit positions (wave * 1024 + offset) of the int32
// global ranks ranks[n] over the whole pool, with gws int32[n_waves / 8]
// and wsp int32[n_waves];
// n_waves >= 64, a multiple of 64.  Every gws_stride-th entry of gws (>= 1)
// is staged in shared memory (``smem`` bytes, at most 227 KiB).
extern "C" int bm_select_flat(const void* pool, const void* gwc,
                              const void* gws, const void* wsp,
                              long long n_waves,
                              const void* ranks, long long n, void* out,
                              int gws_stride, long long smem, void* stream) {
  if (bad_count(n) || n_waves < kBlockWaves || n_waves % kBlockWaves ||
      gws_stride < 1 || smem <= 0 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SelectArgs a{};
  a.pool = static_cast<const uint4*>(pool);
  a.gwc = static_cast<const int32_t*>(gwc);
  a.gws = static_cast<const int32_t*>(gws);
  a.wsp = static_cast<const int32_t*>(wsp);
  a.n_waves = n_waves;
  a.ranks32 = static_cast<const int32_t*>(ranks);
  a.n = n;
  a.out = static_cast<int64_t*>(out);
  a.cum_stride = gws_stride;
  return launch_staged(select_flat_kernel, a, smem,
                       static_cast<cudaStream_t>(stream), g_flat);
}

// out int64[n]: ones among bits [0, id] of the vector for each id of ids
// int64[n], over nb int64[n_seg], rec int64[n_seg + 2, 2], runs int32[n_runs,
// 2], ges int32[n_runs / 8], pool and wrk (ops/select.rank_tables).
// n_seg may be 0 (every answer rec[1]), n_runs 0 (no D-GAP block).
// Staging: every nb_stride-th entry of nb (>= 1), stage_rec / stage_ges
// (0 or 1), ``smem`` the bytes they take (16 to 227 KiB).
extern "C" int bm_rs_rank(const void* nb, long long n_seg, const void* rec,
                          const void* runs, const void* ges,
                          long long n_runs, const void* pool,
                          const void* wrk, const void* ids, long long n,
                          void* out, int nb_stride, int stage_rec,
                          int stage_ges, long long smem, void* stream) {
  if (bad_count(n) || n_seg < 0 || n_runs < 0 || nb_stride < 1 ||
      smem < 16 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RankArgs a{};
  a.nb = static_cast<const int64_t*>(nb);
  a.n_seg = n_seg;
  a.rec = static_cast<const longlong2*>(rec);
  a.runs = static_cast<const int32_t*>(runs);
  a.ges = static_cast<const int32_t*>(ges);
  a.n_runs = n_runs;
  a.pool = static_cast<const uint4*>(pool);
  a.wrk = static_cast<const int2*>(wrk);
  a.ids = static_cast<const int64_t*>(ids);
  a.n = n;
  a.out = static_cast<int64_t*>(out);
  a.nb_stride = nb_stride;
  a.stage_rec = stage_rec;
  a.stage_ges = stage_ges;
  return launch_staged(rs_rank_kernel, a, smem,
                       static_cast<cudaStream_t>(stream), g_rank);
}

// out int64[n]: ones among bits [0, rel] of the whole pool for each rel of
// rel int64[n] in [0, n_waves * 1024) (-1 outside), over wrk int32[n_waves,
// 2]; n_waves >= 1.
extern "C" int bm_rank_flat(const void* pool, const void* wrk,
                            long long n_waves, const void* rel, long long n,
                            void* out, void* stream) {
  if (bad_count(n) || n_waves < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rank_flat_kernel<<<grid(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool), static_cast<const int2*>(wrk),
      n_waves, static_cast<const int64_t*>(rel), n,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
