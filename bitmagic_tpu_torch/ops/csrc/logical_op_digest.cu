// K1: gather-fused a OP b (op in and/or/xor/sub) plus its wave digest.
//
// Replaces logical_op_digest_pallas (bitmagic_tpu/ops/pallas_kernels.py:
// 74-94, body _logical_digest_body :46-70) and, on the card, the XLA
// fusion _binary_kernel (bitmagic_tpu/core/bitvector.py:43-48) that
// BitVector._binary runs.  Writes the result rows int32[k, 2048] and the
// digest int32[k, 64] (1 where the 32-word wave of the result is nonzero).
// Bound: reading both operands and writing the result (8 KiB + 8 KiB in,
// 8 KiB + 256 B out per row).  Design: one CTA per result row, operand
// sources resolved once per CTA; each thread moves 16 bytes at a time, so
// eight neighbouring lanes hold one 32-word wave.  The TPU kernel's digest
// is an MXU selector matmul (:59-69); here it is one __ballot_sync per
// warp step: lanes 0, 8, 16 and 24 each write the digest entry of their
// wave from their 8-lane group of the vote.
#include "bm_common.cuh"

namespace {

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) {
  if (OP == 0) return a & b;
  if (OP == 1) return a | b;
  if (OP == 2) return a ^ b;
  return a & ~b;
}

template <int OP>
__global__ void __launch_bounds__(bm::kThreads)
binary_digest_kernel(bm::Operand a, bm::Operand b, uint4* __restrict__ out,
                     int32_t* __restrict__ digest) {
  const int i = blockIdx.x;
  const bm::RowSrc sa = bm::resolve(a, i);
  const bm::RowSrc sb = bm::resolve(b, i);
  uint4* orow = out + static_cast<size_t>(i) * bm::kBlockVec;
  int32_t* drow = digest + static_cast<size_t>(i) * bm::kBlockWaves;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < bm::kVecPerThread; ++v) {
    const int idx = threadIdx.x + v * bm::kThreads;
    const uint4 x = bm::load(sa, idx);
    const uint4 y = bm::load(sb, idx);
    uint4 r;
    r.x = apply<OP>(x.x, y.x);
    r.y = apply<OP>(x.y, y.y);
    r.z = apply<OP>(x.z, y.z);
    r.w = apply<OP>(x.w, y.w);
    orow[idx] = r;
    // vector idx holds words 4*idx..4*idx+3, i.e. wave idx / 8
    const unsigned nz =
        __ballot_sync(0xFFFFFFFFu, (r.x | r.y | r.z | r.w) != 0u);
    if ((lane & 7) == 0) {
      drow[idx >> 3] = ((nz >> lane) & 0xFFu) != 0u ? 1 : 0;
    }
  }
}

template <int OP>
int launch(const bm::Operand& a, const bm::Operand& b, int k, void* out,
           void* digest, cudaStream_t stream) {
  binary_digest_kernel<OP><<<k, bm::kThreads, 0, stream>>>(
      a, b, static_cast<uint4*>(out), static_cast<int32_t*>(digest));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op: 0 and, 1 or, 2 xor, 3 sub (blockops.OP_CODES).
// Returns the CUDA error of the launch (0 = launched).  k >= 1.
extern "C" int bm_logical_op_digest(
    int op,
    const void* a_pool, int a_pool_rows, const void* a_slot,
    const void* a_full, const void* a_aux, int a_aux_rows,
    const void* a_aux_slot,
    const void* b_pool, int b_pool_rows, const void* b_slot,
    const void* b_full, const void* b_aux, int b_aux_rows,
    const void* b_aux_slot,
    int k, void* out, void* digest, void* stream) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bm::Operand a{static_cast<const uint4*>(a_pool), a_pool_rows,
                      static_cast<const int32_t*>(a_slot),
                      static_cast<const uint8_t*>(a_full),
                      static_cast<const uint4*>(a_aux), a_aux_rows,
                      static_cast<const int32_t*>(a_aux_slot)};
  const bm::Operand b{static_cast<const uint4*>(b_pool), b_pool_rows,
                      static_cast<const int32_t*>(b_slot),
                      static_cast<const uint8_t*>(b_full),
                      static_cast<const uint4*>(b_aux), b_aux_rows,
                      static_cast<const int32_t*>(b_aux_slot)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: return launch<0>(a, b, k, out, digest, s);
    case 1: return launch<1>(a, b, k, out, digest, s);
    case 2: return launch<2>(a, b, k, out, digest, s);
    case 3: return launch<3>(a, b, k, out, digest, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
