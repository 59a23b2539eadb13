// sv_gather and sv_transpose: the bit-sliced SparseVector's multi-plane
// gather and its bulk-import bit-transpose.
//
// They replace the JAX package's two jitted device programs of
// bitmagic_tpu/sv/sparse_vector.py: _gather_decode_kernel (:70-94, behind
// SparseVector.gather :343-387) and _transpose_kernel (:53-67, behind
// _import_aligned :185).
//
// sv_gather reads a column's plane table (core/blocks.plane_table): P
// value planes and then the NULL plane of a nullable column, each a Plane
// row (its pool, GAP store mirror and the value bit it sets, -1 for the
// NULL plane), and the table's block directory: sorted breakpoints bps
// int64[B] where any plane's state changes, and dir int32[B + 1, P], row
// r holding every plane's code for the blocks with r breakpoints at or
// below them: a pool row (>= 0, BIT), -1 (FULL), -2 - g (D-GAP block g of
// the plane's store) or kDirZero.  An id's block costs one search of the
// breakpoints, shared by all planes; a BIT or D-GAP entry's interval is
// one block.  The value's 64-bit image u is written, 0 where the NULL
// plane's bit is 0.
//
// Bound on this card: the bytes it must move, the ids read and u written
// once (16 B an id) and the planes' BIT rows and D-GAP runs read once.
// Ids arrive unsorted, so one thread per id reading its words makes each
// warp load touch 32 lines: at 1M uniform ids over 21 planes the first
// port moved ~670 MB of 32-byte sectors through L2 for 40 MB of rows.
// The gather therefore groups the ids by directory row first (a
// counting sort on the card, no host sync) and answers each group with
// one CTA that stages its block's BIT rows in shared memory:
//   sv_gather_kernel_hist     per-row id counts (a shared-memory
//                             histogram per tile); the last CTA scans
//                             them into each row's first slot and chunks
//   sv_gather_kernel_scatter  each id as (position << 16 | bit) at its
//                             row's next slot: a tile sorted by row in
//                             shared memory, one global atomic per row
//                             and tile, row runs of slots written by
//                             neighbouring threads (past kStageHist rows
//                             a global atomic per id)
//   sv_gather_kernel_answer   one chunk (at most kChunkIds ids of one
//                             row) a step, persistent CTAs: the row's BIT
//                             rows arrive by cp.async.bulk (TMA), each
//                             completing on its own mbarrier so the first
//                             plane is answered while the rest still
//                             arrive, staged once for the whole chunk
//                             (a column of more than kStageRows BIT
//                             planes stages them in groups, again per
//                             4096 ids); every chunk stages (it won over
//                             words read from global memory at every id
//                             density measured; PERF.md)
// The breakpoints (up to kStageBps) and the row counts (up to kStageHist
// rows) are held in shared memory by the hist and scatter passes; a
// larger directory is searched and counted in global memory.  A batch
// too small or too sparse to group (the wrapper's cut-over) is one
// launch of sv_gather_kernel_direct: a thread per id, the breakpoints
// staged in shared memory when they fit, words read directly.
// FULL entries cost no load; a D-GAP entry is a binary search of the
// block's run ends (the first run ending at or after the bit; runs
// alternate from the block's first bit).
//
// sv_transpose: values (uint32 where every value fits 32 bits, else
// uint64) -> the plane word image uint32[n_slices, n_words], word w of
// plane s holding bit s of values 32w .. 32w + 31, LSB first; values past
// n read as 0.  Bound: the values read once and the image written once.
// A warp owns 32 words (1024 values).  Its lanes load the values with
// coalesced 16-byte loads into the warp's tile of shared memory, each
// lane's 32 values a row padded by 16 bytes (so neither the stores by
// consecutive 16-byte chunks nor the reads by row meet a bank twice in a
// quarter-warp); lane j then reads its row, the 32 values of word j, and
// transposes the 32 x 32 bit matrix in its registers (transpose32: five
// stages of masked swaps, about 10 instructions a value where the first
// port's ballots took about 5 a value and slice), and the warp stores
// each slice's 32 words as one 128-byte line.  8-byte values go as two
// halves: slices 0-31 from the low words, 32-63 from the high ones.
#include "bm_common.cuh"

namespace {

using bm::Plane;
using bm::kPlaneCols;

constexpr int kBlockWords = 2048;          // words per block row
constexpr int kRowBytes = kBlockWords * 4;
constexpr int kMaxPlanes = 65;             // 64 value planes + NULL
constexpr int kThreads = 512;              // gather CTAs
constexpr int kIdsPerThread = 8;
constexpr int kTile = kThreads * kIdsPerThread;   // ids per tile / chunk
constexpr int kDirectThreads = 256;
constexpr int kStageRows = 24;             // BIT rows a group: 192 KiB
constexpr int kChunkIds = 8192;            // most ids of an answer chunk
constexpr int kStageBps = 4096;            // breakpoints held in smem
constexpr int kStageHist = 4096;           // row counts held in smem
constexpr int32_t kDirZero = INT32_MIN;
constexpr int kTransposeThreads = 128;
constexpr int kTransposeWarps = kTransposeThreads / 32;
constexpr int kTilePad = 4;                // words after each lane's row
constexpr unsigned kAll = 0xFFFFFFFFu;

struct GatherArgs {
  const int64_t* ids;
  long long n;
  const int64_t* table;          // int64[P, 9] Plane rows
  int n_planes;
  const int64_t* bps;            // int64[B]
  long long n_bps;
  const int32_t* dir;            // int32[B + 1, P]
  unsigned long long* count;     // [B + 1] ids per row (zeroed)
  unsigned* done;                // CTAs of the hist pass that finished
  long long* off;                // [B + 1] first slot of each row in perm
  unsigned long long* cursor;    // [B + 1] next free slot of each row
  long long* cc;                 // [B + 2] chunks before each row
  long long* perm;               // [n] position << 16 | bit, by row
  uint64_t* out;
  int stage_bps;                 // breakpoints held in shared memory (0:
                                 // the directory's exceed kStageBps)
  int stage_hist;                // rows counted in shared memory (0: more
                                 // than kStageHist rows)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Directory row of block blk: the breakpoints at or below it.
__device__ __forceinline__ long long dir_row(const int64_t* bps,
                                             long long n, int64_t blk) {
  long long lo = 0;
  long long hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (bps[mid] <= blk) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Bit nbit of D-GAP block g of plane p's store.
__device__ __forceinline__ uint32_t gap_bit(const Plane& p, int g, int nbit) {
  const int r0 = __ldg(p.offs + g);
  int r = r0;
  int h = __ldg(p.offs + g + 1) - 1;     // the last run ends at 65535
  while (r < h) {
    const int mid = (r + h) >> 1;
    if (__ldg(p.ends + mid) < nbit) {
      r = mid + 1;
    } else {
      h = mid;
    }
  }
  return (static_cast<uint32_t>(__ldg(p.first + g)) ^
          static_cast<uint32_t>(r - r0)) & 1u;
}

// Bit nbit of plane p under directory code e (any code).
__device__ __forceinline__ uint32_t entry_bit(const Plane& p, int32_t e,
                                              int nbit) {
  if (e >= 0) {
    const uint32_t w = __ldg(p.pool + static_cast<int64_t>(e) * kBlockWords
                             + (nbit >> 5));
    return (w >> (nbit & 31)) & 1u;
  }
  if (e == -1) return 1u;
  if (e == kDirZero) return 0u;
  return gap_bit(p, -2 - e, nbit);
}

__device__ __forceinline__ void put_bit(const Plane& p, uint32_t bit,
                                        uint64_t& u, uint32_t& assigned) {
  if (p.bit >= 0) {
    u |= static_cast<uint64_t>(bit) << p.bit;
  } else {
    assigned = bit;
  }
}

// The plane table into shared memory (72 B a plane).
__device__ __forceinline__ void stage_table(Plane* sp, const int64_t* table,
                                            int n_planes) {
  int64_t* raw = reinterpret_cast<int64_t*>(sp);
  for (int j = threadIdx.x; j < n_planes * kPlaneCols; j += blockDim.x) {
    raw[j] = table[j];
  }
}

__global__ void __launch_bounds__(kDirectThreads)
sv_gather_kernel_direct(GatherArgs a) {
  __shared__ Plane sp[kMaxPlanes];
  extern __shared__ __align__(16) int64_t sbp[];   // stage_bps entries
  stage_table(sp, a.table, a.n_planes);
  for (long long j = threadIdx.x; j < a.stage_bps; j += blockDim.x) {
    sbp[j] = a.bps[j];
  }
  __syncthreads();
  const int64_t* bps = a.stage_bps ? sbp : a.bps;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; i < a.n; i += stride) {
    const int64_t id = a.ids[i];
    const int nbit = static_cast<int>(id & 0xFFFF);
    const int32_t* e = a.dir + dir_row(bps, a.n_bps, id >> 16) * a.n_planes;
    uint64_t u = 0;
    uint32_t assigned = 1u;
    for (int p = 0; p < a.n_planes; ++p) {
      put_bit(sp[p], entry_bit(sp[p], __ldg(e + p), nbit), u, assigned);
    }
    a.out[i] = assigned ? u : 0ull;
  }
}

// Shared memory of the hist and scatter passes: the staged breakpoints,
// then per row a count (and, in the scatter pass, its base slot).
struct TileSmem {
  int64_t* bps;
  unsigned* hist;
  unsigned long long* base;
};

__device__ __forceinline__ TileSmem tile_smem(const GatherArgs& a,
                                              int64_t* raw) {
  TileSmem t;
  t.bps = raw;
  t.base = reinterpret_cast<unsigned long long*>(raw + a.stage_bps);
  t.hist = reinterpret_cast<unsigned*>(t.base + a.stage_hist);
  for (long long j = threadIdx.x; j < a.stage_bps; j += blockDim.x) {
    raw[j] = a.bps[j];
  }
  for (long long j = threadIdx.x; j < a.stage_hist; j += blockDim.x) {
    t.hist[j] = 0u;
  }
  __syncthreads();
  if (!a.stage_bps) t.bps = const_cast<int64_t*>(a.bps);
  return t;
}

// Exclusive prefix over the CTA of one value per thread; the total to all.
__device__ __forceinline__ long long cta_scan(long long v, long long* tmp,
                                              long long& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kThreads / 32 ? tmp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kAll, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kThreads / 32) tmp[lane] = w;
  }
  __syncthreads();
  total = tmp[kThreads / 32 - 1];
  const long long before = (warp ? tmp[warp - 1] : 0) + x - v;
  __syncthreads();
  return before;
}

// Each row's first slot in perm (off and its cursor) and first chunk (cc)
// from the row counts: a thread per span of rows, the CTA's prefix over
// them.
__device__ __forceinline__ void row_offsets(const GatherArgs& a,
                                            long long* tmp) {
  const long long rows = a.n_bps + 1;
  const long long span = (rows + kThreads - 1) / kThreads;
  const long long r0 = threadIdx.x * span;
  const long long r1 = r0 + span < rows ? r0 + span : rows;
  long long ids = 0;
  long long chunks = 0;
  for (long long r = r0; r < r1; ++r) {
    const long long c = static_cast<long long>(__ldcg(a.count + r));
    ids += c;
    chunks += (c + kChunkIds - 1) / kChunkIds;
  }
  long long ids_total, chunks_total;
  long long at = cta_scan(ids, tmp, ids_total);
  long long ch = cta_scan(chunks, tmp, chunks_total);
  for (long long r = r0; r < r1; ++r) {
    const long long c = static_cast<long long>(__ldcg(a.count + r));
    a.cursor[r] = static_cast<unsigned long long>(at);
    a.off[r] = at;
    a.cc[r] = ch;
    at += c;
    ch += (c + kChunkIds - 1) / kChunkIds;
  }
  if (threadIdx.x == 0) a.cc[rows] = chunks_total;
}

// Two CTAs an SM (at most 64 registers): every tile of a 1M-id batch in
// one wave of CTAs.
__global__ void __launch_bounds__(kThreads, 2)
sv_gather_kernel_hist(GatherArgs a) {
  extern __shared__ __align__(16) int64_t raw[];
  __shared__ long long tmp[kThreads / 32];
  __shared__ bool last;
  const long long i0 = static_cast<long long>(blockIdx.x) * kTile;
  int64_t id[kIdsPerThread];             // in flight while staging
#pragma unroll
  for (int k = 0; k < kIdsPerThread; ++k) {
    const long long i = i0 + k * kThreads + threadIdx.x;
    id[k] = i < a.n ? __ldg(a.ids + i) : 0;
  }
  const TileSmem t = tile_smem(a, raw);
#pragma unroll
  for (int k = 0; k < kIdsPerThread; ++k) {
    if (i0 + k * kThreads + threadIdx.x < a.n) {
      const long long r = dir_row(t.bps, a.n_bps, id[k] >> 16);
      if (a.stage_hist) {
        atomicAdd(t.hist + r, 1u);
      } else {
        atomicAdd(a.count + r, 1ull);
      }
    }
  }
  __syncthreads();
  for (long long r = threadIdx.x; r < a.stage_hist; r += kThreads) {
    if (t.hist[r]) atomicAdd(a.count + r, t.hist[r]);
  }
  // the last CTA to finish scans the counts: each row's first slot (its
  // cursor) and first chunk
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  row_offsets(a, tmp);
}

__global__ void __launch_bounds__(kThreads, 2)
sv_gather_kernel_scatter(GatherArgs a) {
  extern __shared__ __align__(16) int64_t raw[];
  __shared__ long long tmp[kThreads / 32];
  const long long i0 = static_cast<long long>(blockIdx.x) * kTile;
  long long key[kIdsPerThread];          // the ids, in flight while staging
#pragma unroll
  for (int k = 0; k < kIdsPerThread; ++k) {
    const long long i = i0 + k * kThreads + threadIdx.x;
    key[k] = i < a.n ? __ldg(a.ids + i) : 0;
  }
  const TileSmem t = tile_smem(a, raw);
  if (!a.stage_hist) {                   // a slot per id from global atomics
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k) {
      const long long i = i0 + k * kThreads + threadIdx.x;
      if (i < a.n) {
        const long long r = dir_row(t.bps, a.n_bps, key[k] >> 16);
        a.perm[atomicAdd(a.cursor + r, 1ull)] = (i << 16) | (key[k] & 0xFFFF);
      }
    }
    return;
  }
  // the tile sorted by row in shared memory, then written row run by row
  // run: neighbouring threads store neighbouring slots of perm
  const int G = a.stage_hist;
  unsigned* lofs = t.hist + G;           // each row's first slot in the tile
  long long* keys = reinterpret_cast<long long*>(
      reinterpret_cast<uintptr_t>(lofs + G + 3) & ~static_cast<uintptr_t>(7));
  int* rows = reinterpret_cast<int*>(keys + kTile);
  int row[kIdsPerThread];
  unsigned slot[kIdsPerThread];
#pragma unroll
  for (int k = 0; k < kIdsPerThread; ++k) {
    const long long i = i0 + k * kThreads + threadIdx.x;
    row[k] = -1;
    if (i < a.n) {
      row[k] = static_cast<int>(dir_row(t.bps, a.n_bps, key[k] >> 16));
      key[k] = (i << 16) | (key[k] & 0xFFFF);
      slot[k] = atomicAdd(t.hist + row[k], 1u);
    }
  }
  __syncthreads();
  const int span = (G + kThreads - 1) / kThreads;
  const int r0 = threadIdx.x * span;
  const int r1 = r0 + span < G ? r0 + span : G;
  long long mine = 0;
  for (int r = r0; r < r1; ++r) mine += t.hist[r];
  long long total;
  long long at = cta_scan(mine, tmp, total);
  for (int r = r0; r < r1; ++r) {
    const unsigned c = t.hist[r];
    lofs[r] = static_cast<unsigned>(at);
    if (c) {
      t.base[r] = atomicAdd(a.cursor + r, static_cast<unsigned long long>(c));
    }
    at += c;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kIdsPerThread; ++k) {
    if (row[k] >= 0) {
      const unsigned j = lofs[row[k]] + slot[k];
      keys[j] = key[k];
      rows[j] = row[k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < total; j += kThreads) {
    const int r = rows[j];
    a.perm[t.base[r] + (j - lofs[r])] = keys[j];
  }
}

// One chunk's plan: its row's BIT planes (plane, pool row) and D-GAP
// planes, the FULL value planes' bits, and whether the NULL plane
// leaves the images unassigned.
struct Plan {
  int n_bit, n_gap;
  uint64_t full;
  uint32_t assigned;
  int bit_plane[kMaxPlanes];
  int32_t bit_row[kMaxPlanes];
  int gap_plane[kMaxPlanes];
  int32_t gap_blk[kMaxPlanes];
};

// Warp 0 reads directory row r into the plan.
__device__ __forceinline__ void make_plan(Plan& pl, const Plane* sp,
                                          const int32_t* e, int n_planes) {
  const int lane = threadIdx.x & 31;
  int nb = 0, ng = 0;
  uint64_t full = 0;
  uint32_t assigned = 1u;
  for (int p0 = 0; p0 < n_planes; p0 += 32) {
    const int p = p0 + lane;
    const int32_t c = p < n_planes ? __ldg(e + p) : kDirZero;
    const bool is_bit = c >= 0;
    const bool is_gap = c <= -2 && c != kDirZero;
    const unsigned mb = __ballot_sync(kAll, is_bit);
    const unsigned mg = __ballot_sync(kAll, is_gap);
    const unsigned lt = (1u << lane) - 1u;
    if (is_bit) {
      pl.bit_plane[nb + __popc(mb & lt)] = p;
      pl.bit_row[nb + __popc(mb & lt)] = c;
    }
    if (is_gap) {
      pl.gap_plane[ng + __popc(mg & lt)] = p;
      pl.gap_blk[ng + __popc(mg & lt)] = -2 - c;
    }
    nb += __popc(mb);
    ng += __popc(mg);
    uint64_t f = p < n_planes && c == -1 && sp[p].bit >= 0
        ? 1ull << sp[p].bit : 0ull;
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) f |= __shfl_xor_sync(kAll, f, d);
    full |= f;
    if (__ballot_sync(kAll, p < n_planes && sp[p].bit < 0 &&
                            c == kDirZero)) {
      assigned = 0u;
    }
  }
  if (lane == 0) {
    pl.n_bit = nb;
    pl.n_gap = ng;
    pl.full = full;
    pl.assigned = assigned;
  }
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

__global__ void __launch_bounds__(kThreads, 1)
sv_gather_kernel_answer(GatherArgs a) {
  extern __shared__ __align__(128) uint32_t rows_s[];   // kStageRows rows
  __shared__ __align__(8) uint64_t bars[kStageRows];
  __shared__ Plane sp[kMaxPlanes];
  __shared__ Plan pl;
  stage_table(sp, a.table, a.n_planes);
  if (threadIdx.x == 0) {
    for (int j = 0; j < kStageRows; ++j) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(bars + j)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  uint32_t parity = 0u;                  // bit j: barrier j's next phase
  const long long rows = a.n_bps + 1;
  const long long n_chunks = a.cc[rows];
  for (long long v = blockIdx.x; v < n_chunks; v += gridDim.x) {
    // the chunk's row: the last with cc[r] <= v
    long long lo = 0;
    long long hi = rows;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (a.cc[mid + 1] <= v) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const long long r = lo;
    const long long k = v - a.cc[r];
    const long long nch = a.cc[r + 1] - a.cc[r];
    const long long cnt = static_cast<long long>(a.count[r]);
    const long long c0 = a.off[r] + cnt * k / nch;
    const long long c1 = a.off[r] + cnt * (k + 1) / nch;
    long long key[kIdsPerThread];        // the first sub-tile's, in flight
#pragma unroll                           // while the plan is made
    for (int q = 0; q < kIdsPerThread; ++q) {
      const long long i = c0 + q * kThreads + threadIdx.x;
      key[q] = i < c1 ? __ldg(a.perm + i) : -1;
    }
    __syncthreads();                     // the last chunk's reads are done
    if (threadIdx.x < 32) make_plan(pl, sp, a.dir + r * a.n_planes,
                                    a.n_planes);
    __syncthreads();
    // one group: the rows are staged once and serve every sub-tile
    const bool once = pl.n_bit <= kStageRows;
    if (pl.assigned && once && threadIdx.x == 0) {
      for (int j = 0; j < pl.n_bit; ++j) {
        bulk_load(smem_addr(rows_s + j * kBlockWords),
                  sp[pl.bit_plane[j]].pool +
                      static_cast<int64_t>(pl.bit_row[j]) * kBlockWords,
                  smem_addr(bars + j));
      }
    }
    for (long long s0 = c0; s0 < c1; s0 += kTile) {
      long long pos[kIdsPerThread];
      int nbit[kIdsPerThread];
      uint64_t u[kIdsPerThread];
      uint32_t assigned[kIdsPerThread];
#pragma unroll
      for (int q = 0; q < kIdsPerThread; ++q) {
        const long long i = s0 + q * kThreads + threadIdx.x;
        if (s0 != c0) key[q] = i < c1 ? __ldg(a.perm + i) : -1;
        pos[q] = key[q] >> 16;           // -1 past the chunk
        nbit[q] = static_cast<int>(key[q] & 0xFFFF);
        u[q] = pl.full;
        assigned[q] = pl.assigned;
      }
      const bool first = s0 == c0;
      for (int g0 = 0; pl.assigned && g0 < pl.n_bit; g0 += kStageRows) {
        const int kg = pl.n_bit - g0 < kStageRows ? pl.n_bit - g0
                                                  : kStageRows;
        if (!once) {
          __syncthreads();               // the last group's reads are done
          if (threadIdx.x == 0) {
            for (int j = 0; j < kg; ++j) {
              bulk_load(smem_addr(rows_s + j * kBlockWords),
                        sp[pl.bit_plane[g0 + j]].pool +
                            static_cast<int64_t>(pl.bit_row[g0 + j]) *
                                kBlockWords,
                        smem_addr(bars + j));
            }
          }
        }
        for (int j = 0; j < kg; ++j) {
          const Plane& p = sp[pl.bit_plane[g0 + j]];
          if (!once || first) {
            bar_wait(smem_addr(bars + j), (parity >> j) & 1u);
            parity ^= 1u << j;
          }
          const uint32_t* w = rows_s + j * kBlockWords;
#pragma unroll
          for (int q = 0; q < kIdsPerThread; ++q) {
            if (pos[q] >= 0) {
              put_bit(p, (w[nbit[q] >> 5] >> (nbit[q] & 31)) & 1u, u[q],
                      assigned[q]);
            }
          }
        }
      }
      for (int j = 0; pl.assigned && j < pl.n_gap; ++j) {
        const Plane& p = sp[pl.gap_plane[j]];
#pragma unroll
        for (int q = 0; q < kIdsPerThread; ++q) {
          if (pos[q] >= 0) {
            put_bit(p, gap_bit(p, pl.gap_blk[j], nbit[q]), u[q],
                    assigned[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kIdsPerThread; ++q) {
        if (pos[q] >= 0) a.out[pos[q]] = assigned[q] ? u[q] : 0ull;
      }
    }
  }
}

// One stage of the 32 x 32 bit transpose: for each k with bit J clear,
// the high J bits of every 2J-bit group of a[k] swap with the low J bits
// of the same group of a[k + J].
template <int J, uint32_t M>
__device__ __forceinline__ void transpose_stage(uint32_t (&a)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if ((k & J) == 0) {
      const uint32_t t = ((a[k] >> J) ^ a[k + J]) & M;
      a[k] ^= t << J;
      a[k + J] ^= t;
    }
  }
}

// a[j] bit s -> a[s] bit j.
__device__ __forceinline__ void transpose32(uint32_t (&a)[32]) {
  transpose_stage<16, 0x0000FFFFu>(a);
  transpose_stage<8, 0x00FF00FFu>(a);
  transpose_stage<4, 0x0F0F0F0Fu>(a);
  transpose_stage<2, 0x33333333u>(a);
  transpose_stage<1, 0x55555555u>(a);
}

// Slices s0 .. min(n_slices, s0 + 32) - 1 of word w from a[s - s0].
__device__ __forceinline__ void store_slices(const uint32_t (&a)[32], int s0,
                                             int n_slices, int64_t n_words,
                                             int64_t w,
                                             uint32_t* __restrict__ out) {
  if (w >= n_words) return;
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    if (s0 + s < n_slices) out[(s0 + s) * n_words + w] = a[s];
  }
}

// T: uint32_t or unsigned long long.  ``aligned``: vals is 16-byte
// aligned (else every value is loaded alone).
template <typename T>
__global__ void __launch_bounds__(kTransposeThreads)
sv_transpose_kernel(const T* __restrict__ vals, int64_t n, int n_slices,
                    int64_t n_words, int aligned, uint32_t* __restrict__ out) {
  constexpr int kPer = 16 / sizeof(T);           // values a 16-byte chunk
  constexpr int kRow = 32 * sizeof(T) / 4;       // words of a lane's values
  constexpr int kChunks = 32 * kRow / 4;         // chunks of a warp's tile
  constexpr int kStride = kRow + kTilePad;
  extern __shared__ __align__(16) uint32_t tiles[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* tile = tiles + warp * 32 * kStride;
  const int64_t w0 = (static_cast<int64_t>(blockIdx.x) * kTransposeWarps +
                      warp) * 32;
  if (w0 >= n_words) return;             // the whole warp leaves
  const int64_t v0 = w0 * 32;
  uint4 c[kChunks / 32];                 // every load in flight first
#pragma unroll
  for (int k = 0; k < kChunks / 32; ++k) {
    const int64_t v = v0 + static_cast<int64_t>(lane + 32 * k) * kPer;
    if (aligned && v + kPer <= n) {
      c[k] = __ldg(reinterpret_cast<const uint4*>(vals + v));
    } else {
      union {
        uint4 vec;
        T e[kPer];
      } u;
#pragma unroll
      for (int i = 0; i < kPer; ++i) u.e[i] = v + i < n ? vals[v + i] : T(0);
      c[k] = u.vec;
    }
  }
#pragma unroll
  for (int k = 0; k < kChunks / 32; ++k) {
    const int q = lane + 32 * k;         // chunk q: row q / (kRow / 4)
    const int r = q / (kRow / 4);
    *reinterpret_cast<uint4*>(tile + r * kStride + 4 * (q % (kRow / 4))) =
        c[k];
  }
  __syncwarp();
  const uint32_t* row = tile + lane * kStride;
  const int64_t w = w0 + lane;
  uint32_t a[32];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 x = *reinterpret_cast<const uint4*>(row + 4 * j);
      a[4 * j] = x.x;
      a[4 * j + 1] = x.y;
      a[4 * j + 2] = x.z;
      a[4 * j + 3] = x.w;
    }
    transpose32(a);
    store_slices(a, 0, n_slices, n_words, w, out);
  } else {
    for (int half = 0; half < 2 && 32 * half < n_slices; ++half) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {     // two values a chunk: lo, hi
        const uint4 x = *reinterpret_cast<const uint4*>(row + 4 * j);
        a[2 * j] = half ? x.y : x.x;
        a[2 * j + 1] = half ? x.w : x.z;
      }
      transpose32(a);
      store_slices(a, 32 * half, n_slices, n_words, w, out);
    }
  }
}

bm::LaunchCache g_direct, g_hist, g_scatter, g_answer;

}  // namespace

// out uint64[n]: the value image of ids int64[n] over the plane table
// ``table`` int64[n_planes, 9] (Plane rows) and its block directory (bps
// int64[n_bps], dir int32[n_bps + 1, n_planes]).  grouped = 0: one launch
// of sv_gather_kernel_direct; else the three grouped passes over
// ``scratch`` (int64[4 * (n_bps + 1) + 2]: a ticket and counts, zeroed
// here, then cursors, offsets and the chunk prefix) and ``perm``
// (int64[n]).  Returns the CUDA error of the launches (0 = launched).
// n >= 1, 0 <= n_planes <= 65.
extern "C" int bm_sv_gather(const void* ids, long long n, const void* table,
                            int n_planes, const void* bps, long long n_bps,
                            const void* dir, int grouped, void* scratch,
                            void* perm, void* out, void* stream) {
  if (n <= 0 || n_planes < 0 || n_planes > kMaxPlanes || n_bps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = n_bps + 1;
  GatherArgs a{};
  a.ids = static_cast<const int64_t*>(ids);
  a.n = n;
  a.table = static_cast<const int64_t*>(table);
  a.n_planes = n_planes;
  a.bps = static_cast<const int64_t*>(bps);
  a.n_bps = n_bps;
  a.dir = static_cast<const int32_t*>(dir);
  a.out = static_cast<uint64_t*>(out);
  a.stage_bps = n_bps <= kStageBps ? static_cast<int>(n_bps) : 0;
  int dev = 0;
  cudaGetDevice(&dev);
  int err;
  if (!grouped) {
    const int smem = a.stage_bps * 8;
    if ((err = bm::allow_smem(sv_gather_kernel_direct, smem, g_direct,
                              dev))) {
      return err;
    }
    const long long want = (n + kDirectThreads - 1) / kDirectThreads;
    const long long cap = 64LL * bm::sm_count(g_direct, dev);
    sv_gather_kernel_direct<<<static_cast<int>(want < cap ? want : cap),
                              kDirectThreads, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  a.stage_hist = rows <= kStageHist ? static_cast<int>(rows) : 0;
  int64_t* s = static_cast<int64_t*>(scratch);
  a.done = reinterpret_cast<unsigned*>(s);
  a.count = reinterpret_cast<unsigned long long*>(s + 1);
  a.cursor = reinterpret_cast<unsigned long long*>(s + 1 + rows);
  a.off = reinterpret_cast<long long*>(s + 1 + 2 * rows);
  a.cc = reinterpret_cast<long long*>(s + 1 + 3 * rows);
  a.perm = static_cast<long long*>(perm);
  if ((err = static_cast<int>(cudaMemsetAsync(s, 0, (rows + 1) * 8,
                                              st)))) {
    return err;
  }
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int tile_smem = a.stage_bps * 8 + a.stage_hist * 12;
  // the scatter's tile sort: each row's first slot, the keys and rows
  const int sort_smem = a.stage_hist ? tile_smem + a.stage_hist * 4 + 8 +
                                       kTile * 12 : tile_smem;
  if ((err = bm::allow_smem(sv_gather_kernel_hist, tile_smem, g_hist,
                            dev)) ||
      (err = bm::allow_smem(sv_gather_kernel_scatter, sort_smem, g_scatter,
                            dev))) {
    return err;
  }
  sv_gather_kernel_hist<<<static_cast<int>(tiles), kThreads, tile_smem,
                          st>>>(a);
  sv_gather_kernel_scatter<<<static_cast<int>(tiles), kThreads, sort_smem,
                             st>>>(a);
  const int rows_smem = kStageRows * kRowBytes;
  int blocks = 0;
  if ((err = bm::persistent_grid(sv_gather_kernel_answer, g_answer, kThreads,
                                 rows_smem, (n + kChunkIds - 1) / kChunkIds +
                                 rows, &blocks))) {
    return err;
  }
  sv_gather_kernel_answer<<<blocks, kThreads, rows_smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out uint32[n_slices, ceil(n / 32)]: the plane word image of vals[n],
// 4 bytes a value when value_bytes is 4 (n_slices <= 32), else 8.
// n >= 1, 1 <= n_slices <= 64.
extern "C" int bm_sv_transpose(const void* vals, long long n,
                               int value_bytes, int n_slices, void* out,
                               void* stream) {
  if (n <= 0 || n_slices <= 0 || n_slices > 64 ||
      (value_bytes == 4 && n_slices > 32) ||
      (value_bytes != 4 && value_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_words = (n + 31) / 32;
  const long long words_per_cta = 32LL * kTransposeWarps;
  const long long blocks = (n_words + words_per_cta - 1) / words_per_cta;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int aligned = reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  // a warp's tile: 32 rows of its values' words and the padding
  const int smem = kTransposeWarps * 32 * (8 * value_bytes + kTilePad) * 4;
  if (value_bytes == 4) {
    sv_transpose_kernel<uint32_t><<<static_cast<unsigned>(blocks),
                                    kTransposeThreads, smem, st>>>(
        static_cast<const uint32_t*>(vals), n, n_slices, n_words, aligned,
        static_cast<uint32_t*>(out));
  } else {
    sv_transpose_kernel<unsigned long long><<<static_cast<unsigned>(blocks),
                                              kTransposeThreads, smem, st>>>(
        static_cast<const unsigned long long*>(vals), n, n_slices, n_words,
        aligned, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
