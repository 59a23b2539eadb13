// B5: batched pipeline counts (the scanner's and the aggregator's counts
// pipeline).
//
// Replaces pipeline_counts (bitmagic_tpu/ops/pallas_kernels.py:428-457,
// call _pipeline_counts_call :385-404, body _pipeline_counts_body
// :357-382).  For V selector rows over a plane stack [S, nb, 2048]:
//   count[v] = popcount over all words of AND_s term(v, s),
//   term = plane s (select 1), ~plane s (select -1), all ones (select 0).
// The wrapper passes only the planes some value selects (plane_idx, n_sel
// of them); the selectors refer to positions in that list.  Nothing is
// padded, so an all-zero row counts every bit of the stack; counts are
// summed in int64.
//
// Two paths in one source, picked by the number of staged planes:
//
// Register path (n_sel <= 72; the scanner's stacks: config 4b has 21).
// Bound: logic operations (one LOP3 per selected plane word and value).
// Each thread keeps its W words of every staged plane in registers
// (p[SMAX][W], SMAX the compile-time ceiling of n_sel in steps of 8, fully
// unrolled so no register array is indexed at run time; planes past n_sel
// read as all ones).  The selectors arrive as bit masks (a `sel` and a
// `neg` word per 32 planes and value); a CTA expands each chunk of 128
// values once into shared memory as one word x = 0 or ~0 per (value,
// plane), so the fold is one LOP3 per word, acc &= p ^ x, with x read four
// planes at a time by a broadcast 16-byte shared load.  Values go in pairs
// (two independent accumulator chains); a pair with a skipped plane takes
// a uniform branch per plane, a pair without skips none.  A pair's two
// popcounts share one warp reduction (packed as 16-bit halves) and one
// shared store, summed over the warps once per chunk.
//
// Shared path (n_sel > 72; config 3 stages ~145 of 200 planes).  Bound:
// bytes, the staged planes read once.  A CTA of 128 threads owns a tile of
// T consecutive words (T = 128 while the staged planes fit 72 KiB, so that
// three or more CTAs per SM keep copies in flight, else T = 64: up to 400
// planes in 100 KiB) and fills it for all
// staged planes with 16-byte cp.async copies, all in flight at once, then
// waits for all of them before any thread reads the tile (nothing is in
// flight at exit).  The selectors arrive as CSR codes (position << 1 |
// neg); each warp takes a pair of values over the whole tile (T / 32 words
// per lane, 16- or 8-byte shared loads), so a value's chain of dependent
// code and tile reads is walked by one warp, not by all four.
#include "bm_common.cuh"

namespace {

constexpr int kPipeThreads = 128;
constexpr int kPipeWarps = kPipeThreads / 32;
constexpr int kValueChunk = 128;          // values staged per pass (even)
constexpr int kMaxRegPlanes = 72;
constexpr int kTileBudget = 72 * 1024;    // shared path: three CTAs per SM
constexpr int kMaxPlanes = 400;           // shared path: 100 KiB at 64 words

template <int W>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ uint32_t popc_words(const uint32_t (&a)[W]) {
  uint32_t n = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) n += __popc(a[w]);
  return n;
}

// One pair's popcounts (at most 128 per thread, 4096 per warp) summed over
// the warp as two 16-bit halves; lane 0 stores the warp's sum for the
// pair.
__device__ __forceinline__ void reduce_pair(uint32_t n0, uint32_t n1,
                                            uint32_t* slot) {
  const uint32_t s = __reduce_add_sync(0xFFFFFFFFu, n0 | (n1 << 16));
  if ((threadIdx.x & 31) == 0) *slot = s;
}

// cnt[row][pair], summed over `rows` rows -> one 64-bit atomicAdd per
// value and CTA.
__device__ __forceinline__ void flush_counts(const uint32_t* cnt, int rows,
                                             int nv,
                                             unsigned long long* out) {
  for (int v = threadIdx.x; v < nv; v += kPipeThreads) {
    uint32_t s = 0u;
    for (int w = 0; w < rows; ++w) {
      const uint32_t c = cnt[w * (kValueChunk / 2) + v / 2];
      s += (v & 1) ? (c >> 16) : (c & 0xFFFFu);
    }
    if (s != 0u) atomicAdd(out + v, static_cast<unsigned long long>(s));
  }
}

// ---------------------------------------------------------------------------
// register path
// ---------------------------------------------------------------------------
template <int SMAX, int W, bool SKIPS>
__device__ __forceinline__ void fold_pair(
    const uint32_t (&p)[SMAX][W], const uint32_t* x0, const uint32_t* x1,
    const uint32_t* sel0, const uint32_t* sel1, uint32_t (&a0)[W],
    uint32_t (&a1)[W]) {
  constexpr int NW = (SMAX + 31) / 32;
  uint32_t m0[NW], m1[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    m0[w] = SKIPS ? sel0[w] : 0u;
    m1[w] = SKIPS ? sel1[w] : 0u;
  }
#pragma unroll
  for (int s = 0; s < SMAX; s += 4) {
    const uint4 u0 = *reinterpret_cast<const uint4*>(x0 + s);
    const uint4 u1 = *reinterpret_cast<const uint4*>(x1 + s);
    const uint32_t xa[4] = {u0.x, u0.y, u0.z, u0.w};
    const uint32_t xb[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      constexpr uint32_t one = 1u;
      const int q = s + d;
      if (!SKIPS || (m0[q >> 5] & (one << (q & 31)))) {
#pragma unroll
        for (int w = 0; w < W; ++w) a0[w] &= p[q][w] ^ xa[d];
      }
      if (!SKIPS || (m1[q >> 5] & (one << (q & 31)))) {
#pragma unroll
        for (int w = 0; w < W; ++w) a1[w] &= p[q][w] ^ xb[d];
      }
    }
  }
}

template <int SMAX, int W>
__global__ void __launch_bounds__(kPipeThreads)
pipeline_regs_kernel(const uint32_t* __restrict__ planes,
                     long long plane_words,
                     const int32_t* __restrict__ plane_idx, int n_sel,
                     const uint32_t* __restrict__ masks, int nw,
                     int n_values, unsigned long long* __restrict__ out) {
  constexpr int NW = (SMAX + 31) / 32;
  __shared__ __align__(16) uint32_t xs[kValueChunk * SMAX];
  __shared__ uint32_t sel_s[kValueChunk * NW];
  __shared__ int skips[kValueChunk];
  __shared__ uint32_t cnt[kPipeWarps * (kValueChunk / 2)];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const long long base =
      static_cast<long long>(blockIdx.x) * (kPipeThreads * W) + t * W;

  // this thread's W words of every staged plane, all loads in flight
  uint32_t p[SMAX][W];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    if (s < n_sel) {
      load_words<W>(planes + static_cast<long long>(__ldg(plane_idx + s)) *
                                 plane_words + base, p[s]);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) p[s][w] = 0xFFFFFFFFu;
    }
  }

  for (int v0 = 0; v0 < n_values; v0 += kValueChunk) {
    const int nv = min(kValueChunk, n_values - v0);
    __syncthreads();                    // the previous chunk is consumed
    // expand the chunk's masks: x words, sel words, a skip flag per value
    // (a padded value has x = 0, no skip; its count is dropped)
    for (int e = t; e < kValueChunk * SMAX; e += kPipeThreads) {
      const int v = e / SMAX;
      const int s = e - v * SMAX;
      uint32_t x = 0u;
      if (v < nv && s < n_sel) {
        const uint32_t neg = __ldg(
            masks + (static_cast<size_t>(v0 + v) * 2 + 1) * nw + (s >> 5));
        x = 0u - ((neg >> (s & 31)) & 1u);
      }
      xs[e] = x;
    }
    for (int v = t; v < kValueChunk; v += kPipeThreads) {
      int skip = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint32_t sw = 0u;
        if (v < nv && w < nw) {
          sw = __ldg(masks + static_cast<size_t>(v0 + v) * 2 * nw + w);
        }
        sel_s[v * NW + w] = sw;
        const int lo = 32 * w;
        const int hi = min(lo + 32, n_sel);
        const uint32_t full = hi <= lo ? 0u
            : (hi - lo == 32 ? 0xFFFFFFFFu : (1u << (hi - lo)) - 1u);
        skip |= (v < nv) && sw != full;
      }
      skips[v] = skip;
    }
    __syncthreads();
    const int n_pairs = (nv + 1) / 2;
    for (int q = 0; q < n_pairs; ++q) {
      const int v = 2 * q;
      uint32_t a0[W], a1[W];
#pragma unroll
      for (int w = 0; w < W; ++w) a0[w] = a1[w] = 0xFFFFFFFFu;
      const uint32_t* x0 = xs + v * SMAX;
      const uint32_t* x1 = x0 + SMAX;
      if (skips[v] | skips[v + 1]) {    // uniform over the CTA
        fold_pair<SMAX, W, true>(p, x0, x1, sel_s + v * NW,
                                 sel_s + (v + 1) * NW, a0, a1);
      } else {
        fold_pair<SMAX, W, false>(p, x0, x1, nullptr, nullptr, a0, a1);
      }
      reduce_pair(popc_words<W>(a0), popc_words<W>(a1),
                  cnt + warp * (kValueChunk / 2) + q);
    }
    __syncthreads();
    flush_counts(cnt, kPipeWarps, nv, out + v0);
  }
}

// ---------------------------------------------------------------------------
// shared path
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// One value's fold over the tile: its codes name staged planes; each lane
// folds T / 32 consecutive words per plane (8- or 16-byte shared loads, a
// warp covers T * 4 contiguous bytes).
template <int T>
__device__ __forceinline__ uint32_t fold_codes(const uint32_t* tile, int b,
                                               int e,
                                               const int32_t* codes,
                                               int lane) {
  constexpr int L = T / 32;             // words per lane and plane
  uint32_t acc[L];
#pragma unroll
  for (int w = 0; w < L; ++w) acc[w] = 0xFFFFFFFFu;
#pragma unroll 4
  for (int j = b; j < e; ++j) {
    const int c = __ldg(codes + j);
    const uint32_t x = 0u - static_cast<uint32_t>(c & 1);
    const uint32_t* row = tile + (c >> 1) * T;
    if constexpr (L == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + lane * 2);
      acc[0] &= v.x ^ x;
      acc[1] &= v.y ^ x;
    } else {
#pragma unroll
      for (int h = 0; h < L / 4; ++h) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(row + h * 128 + lane * 4);
        acc[4 * h] &= v.x ^ x;
        acc[4 * h + 1] &= v.y ^ x;
        acc[4 * h + 2] &= v.z ^ x;
        acc[4 * h + 3] &= v.w ^ x;
      }
    }
  }
  return popc_words<L>(acc);
}

template <int T>
__global__ void __launch_bounds__(kPipeThreads)
pipeline_smem_kernel(const uint32_t* __restrict__ planes,
                     long long plane_words,
                     const int32_t* __restrict__ plane_idx, int n_sel,
                     const int32_t* __restrict__ offs,
                     const int32_t* __restrict__ codes, int n_values,
                     unsigned long long* __restrict__ out) {
  constexpr int kPieces = T / 4;        // 16-byte copies per plane
  extern __shared__ __align__(16) uint4 smem_raw[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem_raw);   // [n_sel][T]
  __shared__ uint32_t cnt[kValueChunk / 2];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const long long base = static_cast<long long>(blockIdx.x) * T;

  // every staged plane's tile in flight at once, then one wait
  for (int e = t; e < n_sel * kPieces; e += kPipeThreads) {
    const int j = e / kPieces;
    const int c = e - j * kPieces;
    cp_async16(tile + j * T + c * 4,
               planes + static_cast<long long>(__ldg(plane_idx + j)) *
                            plane_words + base + c * 4);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // a warp takes a pair of values over the whole tile
  for (int v0 = 0; v0 < n_values; v0 += kValueChunk) {
    const int nv = min(kValueChunk, n_values - v0);
    const int n_pairs = (nv + 1) / 2;
    for (int q = warp; q < n_pairs; q += kPipeWarps) {
      const int v = v0 + 2 * q;
      const uint32_t n0 = fold_codes<T>(tile, __ldg(offs + v),
                                        __ldg(offs + v + 1), codes, lane);
      const uint32_t n1 = 2 * q + 1 < nv
          ? fold_codes<T>(tile, __ldg(offs + v + 1), __ldg(offs + v + 2),
                          codes, lane)
          : 0u;
      reduce_pair(n0, n1, cnt + q);
    }
    __syncthreads();
    flush_counts(cnt, 1, nv, out + v0);
    __syncthreads();                    // counters read before reuse
  }
}

template <int SMAX, int W>
int launch_regs(const void* planes, long long plane_words,
                const void* plane_idx, int n_sel, const void* masks, int nw,
                int n_values, void* out, cudaStream_t stream) {
  const long long tiles = plane_words / (kPipeThreads * W);
  pipeline_regs_kernel<SMAX, W>
      <<<static_cast<unsigned>(tiles), kPipeThreads, 0, stream>>>(
          static_cast<const uint32_t*>(planes), plane_words,
          static_cast<const int32_t*>(plane_idx), n_sel,
          static_cast<const uint32_t*>(masks), nw, n_values,
          static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int launch_smem(const void* planes, long long plane_words,
                const void* plane_idx, int n_sel, const void* offs,
                const void* codes, int n_values, void* out,
                cudaStream_t stream) {
  auto kernel = pipeline_smem_kernel<T>;
  const int smem = n_sel * T * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(plane_words / T), kPipeThreads, smem,
           stream>>>(
      static_cast<const uint32_t*>(planes), plane_words,
      static_cast<const int32_t*>(plane_idx), n_sel,
      static_cast<const int32_t*>(offs), static_cast<const int32_t*>(codes),
      n_values, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes: uint32[S, plane_words] (plane_words = nb * 2048 >= 2048, 16-byte
// aligned); plane_idx: int32[n_sel], the staged planes (n_sel <= 400).
// n_sel <= 72: masks uint32[n_values, 2, nw] (nw = ceil(n_sel / 32); row 0
// the selected positions, row 1 the AND-NOT ones), offs and codes unused.
// n_sel > 72: offs int32[n_values + 1], codes int32[offs[n_values]] with
// code (position << 1) | neg, masks unused.  out: int64[n_values], zeroed
// by the caller.  Returns the CUDA error of the launch (0 = launched).
extern "C" int bm_pipeline_counts(const void* planes, long long plane_words,
                                  const void* plane_idx, int n_sel,
                                  const void* masks, int nw,
                                  const void* offs, const void* codes,
                                  int n_values, void* out, void* stream) {
  if (n_sel < 0 || n_values <= 0 || plane_words <= 0 ||
      plane_words % bm::kBlockWords != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_sel <= kMaxRegPlanes) {
    if (nw != (n_sel + 31) / 32 || (nw > 0 && masks == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
#define BM_REGS(SMAX, W)                                                    \
  if (n_sel <= SMAX) {                                                      \
    return launch_regs<SMAX, W>(planes, plane_words, plane_idx, n_sel,      \
                                masks, nw, n_values, out, s);               \
  }
    BM_REGS(8, 4)
    BM_REGS(16, 4)
    BM_REGS(24, 4)
    BM_REGS(32, 2)
    BM_REGS(40, 2)
    BM_REGS(48, 2)
    BM_REGS(56, 1)
    BM_REGS(64, 1)
    BM_REGS(72, 1)
#undef BM_REGS
  }
  if (offs == nullptr || codes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the 128-word tile while the staged planes fit the budget of three CTAs
  // per SM (up to 144 planes), else the 64-word tile
  const long long row_bytes = static_cast<long long>(n_sel) * 4;
  if (row_bytes * 128 <= kTileBudget) {
    return launch_smem<128>(planes, plane_words, plane_idx, n_sel, offs,
                            codes, n_values, out, s);
  }
  if (n_sel <= kMaxPlanes) {
    return launch_smem<64>(planes, plane_words, plane_idx, n_sel, offs,
                           codes, n_values, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
