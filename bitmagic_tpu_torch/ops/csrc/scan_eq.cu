// B6: bit-sliced equality scan of one value over an aligned plane stack.
//
// Replaces scan_eq_pallas (bitmagic_tpu/ops/pallas_kernels.py:310-329, body
// _scan_eq_body :297-306).  For planes [n_planes, nb, 2048] and a uint32
// value, the hit mask of block i is
//   AND_s (bit s of value ? plane[s][i] : ~plane[s][i])
// (bits of the value at s >= 32 read as 0, as the uint32 shift in the
// Pallas body gives).
//
// Bound: bytes (every plane row is read once, the mask written once; one
// LOP3 per word and plane).  Design: one CTA of 256 threads per block
// column, two 16-byte words per thread and plane; the polarity of each
// plane is a uniform XOR mask, and the plane loop is unrolled so that
// several planes' loads are in flight at once.
#include "bm_common.cuh"

namespace {

__global__ void __launch_bounds__(bm::kThreads)
scan_eq_kernel(const uint4* __restrict__ planes, int n_planes,
               long long plane_vecs, uint32_t value,
               uint4* __restrict__ out) {
  const size_t row = static_cast<size_t>(blockIdx.x) * bm::kBlockVec;
  uint4 acc[bm::kVecPerThread];
#pragma unroll
  for (int v = 0; v < bm::kVecPerThread; ++v) {
    acc[v] = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
  }
#pragma unroll 4
  for (int s = 0; s < n_planes; ++s) {
    const uint32_t inv =
        (s < 32 && ((value >> s) & 1u)) ? 0u : 0xFFFFFFFFu;
    const uint4* p = planes + static_cast<size_t>(s) * plane_vecs + row;
#pragma unroll
    for (int v = 0; v < bm::kVecPerThread; ++v) {
      const uint4 x = __ldg(p + threadIdx.x + v * bm::kThreads);
      acc[v].x &= x.x ^ inv;
      acc[v].y &= x.y ^ inv;
      acc[v].z &= x.z ^ inv;
      acc[v].w &= x.w ^ inv;
    }
  }
#pragma unroll
  for (int v = 0; v < bm::kVecPerThread; ++v) {
    out[row + threadIdx.x + v * bm::kThreads] = acc[v];
  }
}

}  // namespace

// planes: uint32[>= n_planes, n_blocks, 2048]; out: uint32[n_blocks, 2048].
// n_blocks >= 1.  Returns the CUDA error of the launch (0 = launched).
extern "C" int bm_scan_eq(const void* planes, int n_planes, int n_blocks,
                          unsigned int value, void* out, void* stream) {
  if (n_blocks <= 0 || n_planes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  scan_eq_kernel<<<n_blocks, bm::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(planes), n_planes,
      static_cast<long long>(n_blocks) * bm::kBlockVec, value,
      static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
