// rs_select and rs_rank: the rank/select index's batches, one thread per
// query, in one launch each.
//
// They replace the JAX package's jitted select_flat
// (bitmagic_tpu/ops/select.py:77, with _in_wave_descent :54 and
// bitops.word_select32) and _rank_in_rows (bitmagic_tpu/core/rs_index.py:
// 191), and the host numpy of RSIndex.select_batch / rank_batch around
// them (rs_index.py:106-185: the segment search, the FULL offsets, the
// GAP rank_in_block / select_in_block).
//
// The index's device tables (core/rs_index.py, ops/select.py SEG_COLS):
//   seg     int64[m + 1, 11]  per segment (row 0 a sentinel) its end block,
//                             ones before / after it, first bit, class, GAP
//                             search keys and first run, pool slot, pool
//                             rank before the slot's row, bit offset
//   cum0    int64[m + 1]      0, then the inclusive ones prefix over segments
//   nb      int64[m]          the segments' first blocks
//   runs    int32[R, 2]       per D-GAP run its block-local end and its
//                             block's inclusive ones count up to it
//   key     int64[R]          the runs' search keys: run_block * 65536 +
//                             end (rank) or run_block * 65537 + ones (select)
//   pool    uint32[r, 2048], gwc int32[r * 64] (inclusive wave prefix)
//
// rs_select, per 1-based rank x in [1, total] (else -1): a lower-bound
// search of x in cum0 gives the segment; rem = x - ones before it.  FULL:
// first bit + rem - 1 (int64: FULL runs pass 2^31 bits).  GAP: a
// lower-bound search of the run key, then first bit + rem - 1 + end - ones
// + 1.  BIT: the pool rank g = rem + the rank before the slot's row is
// searched in that row's 64 entries of gwc only (gwc[row - 1] < g <=
// gwc[row + 63], so it is the wave the JAX function's global search
// finds), one 128 B wave read, then the word prefix and the in-word
// binary popcount descent in registers.  select_flat is the same wave
// step over the whole gwc, with select_flat's contract.
//
// rs_rank, per id: an upper-bound search of its block in nb gives the
// segment (row 0: before the first); outside it the answer is the ones up
// to its end.  FULL: ones before + offset + 1; GAP: a lower-bound search
// of the run key, then min(ones up to the run, p + bit) with p the ones
// before the run less its start (rs_index.py); BIT: the wave prefix less
// the row's base, plus the masked popcount of the id's 128 B wave.
// rank_flat is that BIT step over a whole pool (ShardedRSIndex).
//
// Lower and upper bounds reproduce torch.searchsorted left and right on
// ties (zero-count segments and empty waves repeat prefix values).
// Bound on this card: the bytes moved, 8 B of query in and 8 B of answer
// out each, plus one 128 B wave per BIT-class query; the tables (a few
// hundred KB) are L2-resident and read once.  The searches are dependent
// L2 loads: this first port does not stage the tables in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWaveWords = 32;
constexpr int kWaveVec = kWaveWords / 4;     // uint4 per 128 B wave
constexpr int kBlockWaves = 64;
constexpr int kClsFull = 1;
constexpr int kClsBit = 2;
constexpr int kClsGap = 3;
// columns of seg (ops/select.py SEG_COLS)
constexpr int kEnd = 0, kCb = 1, kCa = 2, kBase = 3, kCls = 4, kGkey = 5,
              kGkeys = 6, kGoffs = 7, kSlot = 8, kBefore = 9, kBitoff = 10,
              kCols = 11;

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

// Bit offset in the wave of its rem-th set bit (_in_wave_descent): the
// word is the first whose inclusive prefix reaches rem (the last word if
// none), then word_select32 of the rank left in it.
__device__ __forceinline__ int in_wave(const uint4* __restrict__ wave,
                                       int rem) {
  uint4 v[kWaveVec];
#pragma unroll
  for (int j = 0; j < kWaveVec; ++j) v[j] = __ldg(wave + j);
  int before = 0;
  int w = kWaveWords - 1;
  uint32_t word = v[kWaveVec - 1].w;
  bool found = false;
#pragma unroll
  for (int j = 0; j < kWaveWords; ++j) {
    const uint4& q = v[j >> 2];
    const uint32_t x = (j & 3) == 0 ? q.x : (j & 3) == 1 ? q.y
                       : (j & 3) == 2 ? q.z : q.w;
    if (!found) {
      const int after = before + __popc(x);
      if (after >= rem || j == kWaveWords - 1) {
        found = true;
        w = j;
        word = x;
      } else {
        before = after;
      }
    }
  }
  return w * 32 + word_select32(word, rem - before);
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

__global__ void __launch_bounds__(kThreads)
rs_select_kernel(const int64_t* __restrict__ seg, int64_t seg_rows,
                 const int64_t* __restrict__ cum0,
                 const int32_t* __restrict__ runs,
                 const int64_t* __restrict__ key_cum, int64_t n_runs,
                 const uint4* __restrict__ pool,
                 const int32_t* __restrict__ gwc, int64_t n_waves,
                 const int64_t* __restrict__ ranks, int64_t n, int64_t total,
                 int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t x = ranks[i];
  if (x < 1 || x > total) {
    out[i] = -1;
    return;
  }
  const int64_t* s = seg + lower_bound(cum0, seg_rows, x) * kCols;
  const int64_t rem = x - __ldg(s + kCb);
  const int64_t cls = __ldg(s + kCls);
  int64_t pos = __ldg(s + kBase) + rem - 1;             // FULL
  if (cls == kClsGap && n_runs > 0) {
    int64_t r = lower_bound(key_cum, n_runs, __ldg(s + kGkeys) + rem);
    if (r > n_runs - 1) r = n_runs - 1;
    pos += static_cast<int64_t>(__ldg(runs + 2 * r)) -
           __ldg(runs + 2 * r + 1) + 1;
  } else if (cls == kClsBit && n_waves > 0) {
    const int64_t w0 = __ldg(s + kSlot) * kBlockWaves;
    const int32_t g = static_cast<int32_t>(rem + __ldg(s + kBefore));
    int64_t wave = w0 + lower_bound(gwc + w0, kBlockWaves, g);
    if (wave > n_waves - 1) wave = n_waves - 1;
    const int32_t prev = wave > 0 ? __ldg(gwc + wave - 1) : 0;
    pos = __ldg(s + kBitoff) + wave * (kWaveWords * 32) +
          in_wave(pool + wave * kWaveVec, g - prev);
  }
  out[i] = pos;
}

__global__ void __launch_bounds__(kThreads)
select_flat_kernel(const uint4* __restrict__ pool,
                   const int32_t* __restrict__ gwc, int64_t n_waves,
                   const int32_t* __restrict__ ranks, int64_t n,
                   int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int32_t x = ranks[i];
  int64_t wave = lower_bound(gwc, n_waves, x);
  if (wave > n_waves - 1) wave = n_waves - 1;
  const int32_t prev = wave > 0 ? __ldg(gwc + wave - 1) : 0;
  out[i] = wave * (kWaveWords * 32) +
           in_wave(pool + wave * kWaveVec, x - prev);
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

}  // namespace

// out int64[n]: the position of each 1-based rank of ranks int64[n], -1
// outside [1, total].  seg_rows = m + 1 >= 2; n_runs may be 0 (no D-GAP
// block), n_waves may be 0 (no BIT block).  Returns the CUDA error of the
// launch (0 = launched).  With m = 0 (seg_rows 1) total is 0 and every
// answer -1.
extern "C" int bm_rs_select(const void* seg, long long seg_rows,
                            const void* cum0, const void* runs,
                            const void* key_cum, long long n_runs,
                            const void* pool, const void* gwc,
                            long long n_waves, const void* ranks,
                            long long n, long long total, void* out,
                            void* stream) {
  if (bad_count(n) || seg_rows < 1 || n_runs < 0 || n_waves < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rs_select_kernel<<<grid(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(seg), seg_rows,
      static_cast<const int64_t*>(cum0), static_cast<const int32_t*>(runs),
      static_cast<const int64_t*>(key_cum), n_runs,
      static_cast<const uint4*>(pool), static_cast<const int32_t*>(gwc),
      n_waves, static_cast<const int64_t*>(ranks), n, total,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out int64[n]: global bit positions (wave * 1024 + offset) of the int32
// global ranks ranks[n] over the whole pool; n_waves >= 1.
extern "C" int bm_select_flat(const void* pool, const void* gwc,
                              long long n_waves, const void* ranks,
                              long long n, void* out, void* stream) {
  if (bad_count(n) || n_waves < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  select_flat_kernel<<<grid(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool), static_cast<const int32_t*>(gwc),
      n_waves, static_cast<const int32_t*>(ranks), n,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
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
