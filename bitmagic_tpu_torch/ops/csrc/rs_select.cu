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
// The index's device tables (core/rs_index.py, ops/select.py SEG_COLS and
// select_tables):
//   seg     int64[m + 1, 11]  per segment (row 0 a sentinel) its end block,
//                             ones before / after it, first bit, class, GAP
//                             search keys and first run, pool slot, pool
//                             rank before the slot's row, bit offset
//   cum0    int64[m + 1]      0, then the inclusive ones prefix over segments
//   sel     int64[m + 1, 2]   per segment the position its answers count
//                             from and (a, b): BIT slot / rank before its
//                             row, D-GAP -2 - first run / run after its last
//   nb      int64[m]          the segments' first blocks
//   runs    int32[R, 2]       per D-GAP run its block-local end and its
//                             block's inclusive ones count up to it
//   key     int64[R]          the runs' rank search keys: run_block * 65536
//                             + end
//   pool    uint32[r, 2048], gwc int32[r * 64] (inclusive wave prefix)
//   gws     int32[r * 8]      gwc at the end of every 8 waves
//   gcs     int32[R / 8]      the runs' ones counts at every 8th run
//   wsp     int32[r * 64]     per wave the ones of its first 1, 2 and 3
//                             32-byte sectors, 10 bits each
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
// segment (row 0: before the first); outside it the answer is the ones up
// to its end.  FULL: ones before + offset + 1; GAP: a lower-bound search
// of the run key, then min(ones up to the run, p + bit) with p the ones
// before the run less its start (rs_index.py); BIT: the wave prefix less
// the row's base, plus the masked popcount of the id's 128 B wave.
// rank_flat is that BIT step over a whole pool (ShardedRSIndex).  The rank
// kernels are the first port's: a thread per query, tables in L2.
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
constexpr int kClsFull = 1;
constexpr int kClsBit = 2;
constexpr int kClsGap = 3;
// the columns of seg (ops/select.py SEG_COLS) that rs_rank reads
constexpr int kEnd = 0, kCb = 1, kCa = 2, kBase = 3, kCls = 4, kGkey = 5,
              kGoffs = 7, kSlot = 8, kCols = 11;

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

// Ones among bits [0, bit] of a 128 B wave (bit in [0, 1024)).
__device__ __forceinline__ int wave_rank(const uint4* __restrict__ wave,
                                         int bit) {
  const int wi = bit >> 5;
  const uint32_t part = (bit & 31) == 31 ? 0xFFFFFFFFu
                        : (2u << (bit & 31)) - 1u;
  int n = 0;
#pragma unroll
  for (int j = 0; j < kWaveVec; ++j) {
    if (4 * j > wi) break;
    const uint4 q = __ldg(wave + j);
    const uint32_t x[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int idx = 4 * j + k;
      n += idx < wi ? __popc(x[k]) : idx == wi ? __popc(x[k] & part) : 0;
    }
  }
  return n;
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

__global__ void __launch_bounds__(kThreads)
rs_rank_kernel(const int64_t* __restrict__ seg,
               const int64_t* __restrict__ nb, int64_t n_seg,
               const int32_t* __restrict__ runs,
               const int64_t* __restrict__ key_end, int64_t n_runs,
               const uint4* __restrict__ pool,
               const int32_t* __restrict__ gwc, int64_t n_waves,
               const int64_t* __restrict__ ids, int64_t n,
               int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t q = ids[i];
  const int64_t blk = q >> 16;
  const int nbit = static_cast<int>(q & 0xFFFF);
  const int64_t* s = seg + upper_bound(nb, n_seg, blk) * kCols;
  if (!(blk < __ldg(s + kEnd))) {                      // past its segment
    out[i] = __ldg(s + kCa);
    return;
  }
  const int64_t cls = __ldg(s + kCls);
  int64_t inblk = 0;
  if (cls == kClsFull) {
    inblk = q - __ldg(s + kBase) + 1;
  } else if (cls == kClsGap && n_runs > 0) {
    const int64_t r = lower_bound(key_end, n_runs, __ldg(s + kGkey) + nbit);
    const int64_t p = r > __ldg(s + kGoffs)
        ? static_cast<int64_t>(__ldg(runs + 2 * r - 1)) -
              __ldg(runs + 2 * r - 2)
        : 1;
    const int64_t ones = __ldg(runs + 2 * r + 1);
    inblk = ones < p + nbit ? ones : p + nbit;
  } else if (cls == kClsBit && n_waves > 0) {
    const int64_t w0 = __ldg(s + kSlot) * kBlockWaves;
    const int64_t wave = w0 + (nbit >> 10);
    const int32_t base = w0 > 0 ? __ldg(gwc + w0 - 1) : 0;
    const int32_t before = wave > w0 ? __ldg(gwc + wave - 1) : base;
    inblk = (before - base) + wave_rank(pool + wave * kWaveVec, nbit & 1023);
  }
  out[i] = __ldg(s + kCb) + inblk;
}

__global__ void __launch_bounds__(kThreads)
rank_flat_kernel(const uint4* __restrict__ pool,
                 const int32_t* __restrict__ gwc, int64_t n_waves,
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
  const int64_t prev = wave > 0 ? __ldg(gwc + wave - 1) : 0;
  out[i] = prev + wave_rank(pool + wave * kWaveVec,
                            static_cast<int>(b & 1023));
}

int grid(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

bool bad_count(long long n) {
  return n <= 0 || (n + kThreads - 1) / kThreads > 0x7FFFFFFFLL;
}

bm::LaunchCache g_select, g_flat;

// Launch a select kernel as persistent CTAs of kStageThreads with ``smem``
// bytes of staged tables, as many CTAs as the queries need and the card
// holds at once.
template <typename K>
int launch_select(K kernel, const SelectArgs& a, long long smem,
                  cudaStream_t st, bm::LaunchCache& cache) {
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
  return launch_select(rs_select_kernel, a, smem,
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
  return launch_select(select_flat_kernel, a, smem,
                       static_cast<cudaStream_t>(stream), g_flat);
}

// out int64[n]: ones among bits [0, id] of the vector for each id of ids
// int64[n].  seg holds n_seg + 1 rows (n_seg = 0: every answer 0).
extern "C" int bm_rs_rank(const void* seg, const void* nb, long long n_seg,
                          const void* runs, const void* key_end,
                          long long n_runs, const void* pool,
                          const void* gwc, long long n_waves,
                          const void* ids, long long n, void* out,
                          void* stream) {
  if (bad_count(n) || n_seg < 0 || n_runs < 0 || n_waves < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rs_rank_kernel<<<grid(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(seg), static_cast<const int64_t*>(nb),
      n_seg, static_cast<const int32_t*>(runs),
      static_cast<const int64_t*>(key_end), n_runs,
      static_cast<const uint4*>(pool), static_cast<const int32_t*>(gwc),
      n_waves, static_cast<const int64_t*>(ids), n,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out int64[n]: ones among bits [0, rel] of the whole pool for each rel of
// rel int64[n] in [0, n_waves * 1024) (-1 outside); n_waves >= 1.
extern "C" int bm_rank_flat(const void* pool, const void* gwc,
                            long long n_waves, const void* rel, long long n,
                            void* out, void* stream) {
  if (bad_count(n) || n_waves < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rank_flat_kernel<<<grid(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool), static_cast<const int32_t*>(gwc),
      n_waves, static_cast<const int64_t*>(rel), n,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
