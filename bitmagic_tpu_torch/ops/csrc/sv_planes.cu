// sv_gather and sv_transpose: the bit-sliced SparseVector's multi-plane
// gather and its bulk-import bit-transpose.
//
// They replace the JAX package's two jitted device programs of
// bitmagic_tpu/sv/sparse_vector.py: _gather_decode_kernel (:70-94, behind
// SparseVector.gather :343-387) and _transpose_kernel (:53-67, behind
// _import_aligned :185).
//
// sv_gather: one thread per queried id, in one launch.  The column's planes
// arrive as a plane table (core/blocks.plane_table), P value planes and
// then the NULL plane of a nullable column:
//   planes  Plane[P]          per plane its slices of nb / ent / runs, its
//                             pool, its GAP store's device mirror and the
//                             value bit it sets (-1: the NULL plane)
//   nb      int64[E]          each plane's sorted block ids, concatenated
//   ent     int32[E]          per block: its pool row (>= 0, a BIT block),
//                             -1 (FULL) or -2 - g (D-GAP block g of the
//                             plane's store)
//   runs    int64[R, 2]       each plane's [start, end) FULL block runs
// An id's block is looked up in each plane by a binary search of the
// plane's nb (and of its runs where the block is absent); its bit is one
// word read for BIT, 1 for FULL, or for GAP a binary search of the block's
// D-GAP ends (the test GapStore.test_bits makes: the first run ending at or
// after the bit; runs alternate from the block's first bit).  The value's
// 64-bit image u is written, 0 where the NULL plane's bit is 0.  The plane
// table (72 B a plane) is staged in shared memory.  Bound on this card:
// the bytes it must move, the ids read and u written once (16 B an id) and
// the planes' BIT rows and D-GAP runs read once; the searches' loads hit
// L1 / L2 (a plane's nb is 8 B a block).
//
// sv_transpose: values (uint32 where every value fits 32 bits, else
// uint64) -> the plane word image uint32[n_slices, n_words], word w of
// plane s holding bit s of values 32w .. 32w + 31, LSB first; values past
// n read as 0.  A warp owns 32 words (1024 values): each lane loads 32
// values of it (one coalesced load per word), then for each slice 32
// ballots give the slice's 32 words, lane j keeping word j, and the warp
// stores them in one coalesced 128-byte write.  Bound: the values read
// once and the image written once.
#include "bm_common.cuh"

namespace {

using bm::Plane;
using bm::kPlaneCols;

constexpr int kBlockWords = 2048;          // words per block row
constexpr int kGatherThreads = 256;
constexpr int kMaxPlanes = 65;             // 64 value planes + NULL
constexpr int kTransposeThreads = 256;
constexpr int kTransposeWarps = kTransposeThreads / 32;
constexpr unsigned kAll = 0xFFFFFFFFu;


// Bit ``nbit`` of block ``blk`` in plane ``p``.
__device__ __forceinline__ uint32_t plane_bit(const Plane& p,
                                              const int64_t* __restrict__ nb,
                                              const int32_t* __restrict__ ent,
                                              const int64_t* __restrict__ runs,
                                              int64_t blk, int nbit) {
  const int64_t* b = nb + p.nb_off;
  int64_t lo = 0;
  int64_t hi = p.nb_len;
  while (lo < hi) {                      // first entry >= blk
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(b + mid) < blk) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo < p.nb_len && __ldg(b + lo) == blk) {
    const int32_t e = __ldg(ent + p.nb_off + lo);
    if (e >= 0) {                        // BIT: one word of its row
      const uint32_t w = __ldg(p.pool + static_cast<int64_t>(e) * kBlockWords
                               + (nbit >> 5));
      return (w >> (nbit & 31)) & 1u;
    }
    if (e == -1) return 1u;              // FULL
    const int g = -2 - e;                // D-GAP: the run holding nbit
    const int r0 = __ldg(p.offs + g);
    int r = r0;
    int h = __ldg(p.offs + g + 1) - 1;   // the last run ends at 65535
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
  // absent from nb: inside a FULL run, or zero
  const int64_t* rs = runs + 2 * p.run_off;
  lo = 0;
  hi = p.run_len;
  while (lo < hi) {                      // first run starting after blk
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(rs + 2 * mid) <= blk) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo > 0 && blk < __ldg(rs + 2 * (lo - 1) + 1) ? 1u : 0u;
}

__global__ void __launch_bounds__(kGatherThreads)
sv_gather_kernel(const int64_t* __restrict__ ids, int64_t n,
                 const int64_t* __restrict__ table, int n_planes,
                 const int64_t* __restrict__ nb,
                 const int32_t* __restrict__ ent,
                 const int64_t* __restrict__ runs,
                 uint64_t* __restrict__ out) {
  __shared__ Plane sp[kMaxPlanes];
  int64_t* raw = reinterpret_cast<int64_t*>(sp);
  for (int j = threadIdx.x; j < n_planes * kPlaneCols; j += blockDim.x) {
    raw[j] = table[j];
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x; i < n; i += stride) {
    const int64_t id = ids[i];
    const int64_t blk = id >> 16;
    const int nbit = static_cast<int>(id & 0xFFFF);
    uint64_t u = 0;
    uint32_t assigned = 1u;
    for (int p = 0; p < n_planes; ++p) {
      const uint32_t bit = plane_bit(sp[p], nb, ent, runs, blk, nbit);
      if (sp[p].bit >= 0) {
        u |= static_cast<uint64_t>(bit) << sp[p].bit;
      } else {
        assigned = bit;
      }
    }
    out[i] = assigned ? u : 0ull;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTransposeThreads)
sv_transpose_kernel(const T* __restrict__ vals, int64_t n, int n_slices,
                    int64_t n_words, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t w0 = (static_cast<int64_t>(blockIdx.x) * kTransposeWarps +
                      (threadIdx.x >> 5)) * 32;
  if (w0 >= n_words) return;             // the whole warp leaves
  T x[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {         // value 32 (w0 + j) + lane
    const int64_t v = (w0 + j) * 32 + lane;
    x[j] = v < n ? vals[v] : T(0);
  }
  const int64_t w = w0 + lane;
  for (int s = 0; s < n_slices; ++s) {
    uint32_t word = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t b = __ballot_sync(kAll, (x[j] >> s) & 1u);
      if (lane == j) word = b;
    }
    if (w < n_words) out[static_cast<int64_t>(s) * n_words + w] = word;
  }
}

}  // namespace

// out uint64[n]: the value image of ids int64[n] over the plane table
// ``table`` int64[n_planes, 9] (Plane rows), nb int64, ent int32, runs
// int64[R, 2].  Returns the CUDA error of the launch (0 = launched).
// n >= 1, 0 <= n_planes <= 65 (no plane: every image is 0).
extern "C" int bm_sv_gather(const void* ids, long long n, const void* table,
                            int n_planes, const void* nb, const void* ent,
                            const void* runs, void* out, void* stream) {
  if (n <= 0 || n_planes < 0 || n_planes > kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long want = (n + kGatherThreads - 1) / kGatherThreads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  sv_gather_kernel<<<blocks, kGatherThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ids), n,
      static_cast<const int64_t*>(table), n_planes,
      static_cast<const int64_t*>(nb), static_cast<const int32_t*>(ent),
      static_cast<const int64_t*>(runs), static_cast<uint64_t*>(out));
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
  if (value_bytes == 4) {
    sv_transpose_kernel<uint32_t><<<static_cast<unsigned>(blocks),
                                    kTransposeThreads, 0, st>>>(
        static_cast<const uint32_t*>(vals), n, n_slices, n_words,
        static_cast<uint32_t*>(out));
  } else {
    sv_transpose_kernel<unsigned long long><<<static_cast<unsigned>(blocks),
                                              kTransposeThreads, 0, st>>>(
        static_cast<const unsigned long long*>(vals), n, n_slices, n_words,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
