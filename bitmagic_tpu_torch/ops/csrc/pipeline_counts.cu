// B5: batched pipeline counts (the scanner's and the aggregator's counts
// pipeline).
//
// Replaces pipeline_counts (bitmagic_tpu/ops/pallas_kernels.py:428-457,
// call _pipeline_counts_call :385-404, body _pipeline_counts_body
// :357-382).  For V selector rows over a plane stack [S, nb, 2048]:
//   count[v] = popcount over all words of AND_s term(v, s),
//   term = plane s (select 1), ~plane s (select -1), all ones (select 0).
// The selectors arrive compacted (CSR): for value v the codes
// codes[offs[v] .. offs[v+1]) list its non-zero selects as (s << 1) | neg,
// so a skipped plane costs nothing and an all-zero row counts every bit.
//
// Bound: at the scanner's shapes the logic ops, not the bytes: each value
// folds every selected plane word once (one LOP3 per word) and popcounts
// its accumulator, while the stack is read from device memory once per
// batch.  Design: a CTA of 128 threads owns a tile of 128 * W consecutive
// words (W = 4, 2 or 1 words per thread, the largest whose S planes fit the
// shared-memory budget) and stages that tile of all S planes in shared
// memory once; each thread then only ever reads back its own W words, so
// no barrier guards the tile.  It loops over every value: the fold keeps
// W words in registers, the popcount is reduced per warp with
// __reduce_add_sync into a per-CTA counter in shared memory, and each
// value's counter leaves with one 64-bit atomicAdd per CTA.  The blocks
// and the values need no padding.
#include "bm_common.cuh"

namespace {

constexpr int kPipeThreads = 128;
constexpr int kValueChunk = 256;          // per-CTA counters per pass
constexpr int kSmemBudget = 96 * 1024;    // two CTAs per SM
constexpr int kSmemMax = 200 * 1024;      // one CTA per SM

template <int W>
struct Words;
template <>
struct Words<4> {
  using T = uint4;
  __device__ static void to(const T& v, uint32_t (&w)[4]) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
};
template <>
struct Words<2> {
  using T = uint2;
  __device__ static void to(const T& v, uint32_t (&w)[2]) {
    w[0] = v.x; w[1] = v.y;
  }
};
template <>
struct Words<1> {
  using T = uint32_t;
  __device__ static void to(const T& v, uint32_t (&w)[1]) { w[0] = v; }
};

template <int W>
__global__ void __launch_bounds__(kPipeThreads)
pipeline_counts_kernel(const uint32_t* __restrict__ planes, int n_planes,
                       long long plane_words,
                       const int32_t* __restrict__ offs,
                       const int32_t* __restrict__ codes, int n_values,
                       unsigned long long* __restrict__ out) {
  using V = typename Words<W>::T;
  extern __shared__ uint4 smem_raw[];
  V* tile = reinterpret_cast<V*>(smem_raw);      // [n_planes][kPipeThreads]
  __shared__ uint32_t cnt[kValueChunk];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const long long base =
      static_cast<long long>(blockIdx.x) * (kPipeThreads * W) + t * W;

  // stage this tile of every plane: plane s at tile[s * 128 + t]
#pragma unroll 8
  for (int s = 0; s < n_planes; ++s) {
    tile[s * kPipeThreads + t] = __ldg(reinterpret_cast<const V*>(
        planes + static_cast<long long>(s) * plane_words + base));
  }

  for (int v0 = 0; v0 < n_values; v0 += kValueChunk) {
    const int nv = min(kValueChunk, n_values - v0);
    for (int j = t; j < nv; j += kPipeThreads) cnt[j] = 0u;
    __syncthreads();
    for (int v = 0; v < nv; ++v) {
      const int b = __ldg(offs + v0 + v);
      const int e = __ldg(offs + v0 + v + 1);
      uint32_t acc[W];
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = 0xFFFFFFFFu;
#pragma unroll 4
      for (int j = b; j < e; ++j) {
        const int c = __ldg(codes + j);
        const uint32_t inv = 0u - static_cast<uint32_t>(c & 1);
        uint32_t p[W];
        Words<W>::to(tile[(c >> 1) * kPipeThreads + t], p);
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] &= p[w] ^ inv;
      }
      uint32_t n = 0u;
#pragma unroll
      for (int w = 0; w < W; ++w) n += __popc(acc[w]);
      n = __reduce_add_sync(0xFFFFFFFFu, n);
      if (lane == 0) atomicAdd(&cnt[v], n);
    }
    __syncthreads();
    for (int j = t; j < nv; j += kPipeThreads) {
      if (cnt[j]) {
        atomicAdd(out + v0 + j, static_cast<unsigned long long>(cnt[j]));
      }
    }
    __syncthreads();                    // counters read before re-zeroing
  }
}

template <int W>
int launch(const void* planes, int n_planes, long long plane_words,
           const void* offs, const void* codes, int n_values, void* out,
           int smem, cudaStream_t stream) {
  auto kernel = pipeline_counts_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = plane_words / (kPipeThreads * W);
  kernel<<<static_cast<unsigned>(tiles), kPipeThreads, smem, stream>>>(
      static_cast<const uint32_t*>(planes), n_planes, plane_words,
      static_cast<const int32_t*>(offs), static_cast<const int32_t*>(codes),
      n_values, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes: uint32[n_planes, plane_words] (plane_words = nb * 2048 >= 2048,
// 16-byte aligned); offs: int32[n_values + 1]; codes: int32[offs[n_values]];
// out: int64[n_values], zeroed by the caller.  The largest W whose staged
// tile fits the budget is taken; more than kSmemMax / 512 planes is refused.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int bm_pipeline_counts(const void* planes, int n_planes,
                                  long long plane_words, const void* offs,
                                  const void* codes, int n_values, void* out,
                                  void* stream) {
  if (n_planes < 0 || n_values <= 0 || plane_words <= 0 ||
      plane_words % bm::kBlockWords != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_word = static_cast<long long>(n_planes) * kPipeThreads *
                             static_cast<long long>(sizeof(uint32_t));
  if (per_word * 4 <= kSmemBudget) {
    return launch<4>(planes, n_planes, plane_words, offs, codes, n_values,
                     out, static_cast<int>(per_word * 4), s);
  }
  if (per_word * 2 <= kSmemBudget) {
    return launch<2>(planes, n_planes, plane_words, offs, codes, n_values,
                     out, static_cast<int>(per_word * 2), s);
  }
  if (per_word <= kSmemMax) {
    return launch<1>(planes, n_planes, plane_words, offs, codes, n_values,
                     out, static_cast<int>(per_word), s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
