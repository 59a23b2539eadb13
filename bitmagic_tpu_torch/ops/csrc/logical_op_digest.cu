// K1: gather-fused a OP b (op in and/or/xor/sub) plus its wave digest.
//
// Replaces logical_op_digest_pallas (bitmagic_tpu/ops/pallas_kernels.py:
// 74-94, body _logical_digest_body :46-70) and, on the card, the XLA
// fusion _binary_kernel (bitmagic_tpu/core/bitvector.py:43-48) that
// BitVector._binary runs.  Writes the result rows int32[k, 2048] and the
// digest int32[k, 64] (1 where the 32-word wave of the result is nonzero).
//
// Bound on this card: the bytes.  Each row read once from each side that
// lives in memory (a FULL or absent side is a fill word, not read), the
// result row and its digest written once: 24.25 KiB a row in the aligned
// form, 0.0114 ms at 1536 rows.  At that size a launch's fixed cost and
// its last CTAs are a large share of the time, and with L2 full of dirty
// lines (as a caller that wrote before meets it) the write-back of the
// lines the call evicts competes with its reads.  Design:
//  - A CTA owns half a row (256 vectors a side), so 1536 rows are 3072
//    small CTAs that fill the card in one go and leave a short tail; each
//    of its warps owns adjacent 32-vector chunks (512 B a side, 4 waves).
//  - Each lane issues all its 16-byte loads (a's, then b's) before its
//    first store.  Below kWideRows rows a CTA is two warps of four chunks
//    (eight loads a lane, 4 KiB in flight a warp); from kWideRows on, four
//    warps of two chunks.  The first was 2 % faster at 1536 rows with L2
//    dirty; the second was faster in 100 of 100 paired turns at 16384
//    rows, by 0.6 % (more than the spread of turns; the first shape alone
//    was 0.3 % slower there than a CTA a row), and in 83 of 100 at 4096
//    (PERF.md, K1's redesign).  The loads are ordinary ld.global:
//    L1::no_allocate and L2 evict-first loads were faster with L2 dirty
//    at 1536 rows and 2-4 % slower at 16384.
//  - The aligned form reads no descriptor; the gather form's six
//    descriptor words (aux slot, FULL flag, pool slot of each side) come
//    in one round trip by lanes 0-5 and are shuffled out
//    (bm::desc_word / bm::warp_sources).
//  - The digest: one ballot per chunk, and lanes 0 .. chunks - 1 write
//    the warp's entries as one store of 16 bytes a chunk (no shared
//    memory, no barrier).
// A persistent grid (contiguous or strided shares, descriptors read one
// unit ahead) and a ring of cp.async.bulk stages (1-4 stages, bulk or
// register stores) were measured slower, at 16384 rows by 3-13 %
// (PERF.md, K1's redesign).
#include "bm_common.cuh"

namespace {

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kChunk = 32;                   // vectors: 512 B, 4 waves
constexpr int kRowCtas = 2;                  // a CTA: half a row
constexpr int kCtaChunks = bm::kBlockVec / kRowCtas / kChunk;   // 8
constexpr int kWideRows = 4096;   // from here on, four warps a CTA

template <int OP>
__device__ __forceinline__ uint4 apply(uint4 a, uint4 b) {
  if (OP == 0) return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
  if (OP == 1) return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  if (OP == 2) return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}

// This lane's vectors j = 0 .. C - 1 of one side: vector at + 32 j of
// its row.
template <int C>
__device__ __forceinline__ void load_side(uint4 (&v)[C], const bm::RowSrc& s,
                                          int at) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
    v[j] = s.ptr != nullptr ? s.ptr[at + j * kChunk]
                            : make_uint4(s.fill, s.fill, s.fill, s.fill);
  }
}

// W warps a CTA, each owning C = 8 / W adjacent chunks of the CTA's half
// row.
template <int OP, int W>
__global__ void __launch_bounds__(32 * W)
binary_digest_kernel(bm::Operand a, bm::Operand b, uint4* __restrict__ out,
                     int4* __restrict__ digest) {
  constexpr int C = kCtaChunks / W;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x / kRowCtas;
  // the warp's first chunk in its row
  const int chunk = (blockIdx.x % kRowCtas) * kCtaChunks +
                    (threadIdx.x >> 5) * C;
  const int at = chunk * kChunk + lane;
  bm::RowSrc sa, sb;
  if (a.slot == nullptr && b.slot == nullptr) {       // the aligned form
    sa = bm::RowSrc{a.pool + static_cast<size_t>(row) * bm::kBlockVec, 0u};
    sb = bm::RowSrc{b.pool + static_cast<size_t>(row) * bm::kBlockVec, 0u};
  } else {
    bm::warp_sources(a, b, bm::desc_word(a, b, row, lane), sa, sb);
  }
  uint4 x[C], y[C];
  load_side(x, sa, at);
  load_side(y, sb, at);
  uint4* orow = out + static_cast<size_t>(row) * bm::kBlockVec;
  unsigned mine = 0u;      // lane j < C: the vote of chunk j
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const uint4 r = apply<OP>(x[j], y[j]);
    orow[at + j * kChunk] = r;
    const unsigned nz = __ballot_sync(kAll, (r.x | r.y | r.z | r.w) != 0u);
    if (lane == j) mine = nz;
  }
  // chunk j's waves are lanes 8q .. 8q + 7 of its vote
  if (lane < C) {
    digest[static_cast<size_t>(row) * (bm::kBlockVec / kChunk) + chunk +
           lane] = make_int4((mine & 0xFFu) != 0u, (mine & 0xFF00u) != 0u,
                             (mine & 0xFF0000u) != 0u,
                             (mine & 0xFF000000u) != 0u);
  }
}

template <int OP>
int launch(const bm::Operand& a, const bm::Operand& b, int k, void* out,
           void* digest, cudaStream_t stream) {
  auto* o = static_cast<uint4*>(out);
  auto* d = static_cast<int4*>(digest);
  if (k < kWideRows) {
    binary_digest_kernel<OP, 2><<<kRowCtas * k, 64, 0, stream>>>(a, b, o, d);
  } else {
    binary_digest_kernel<OP, 4><<<kRowCtas * k, 128, 0, stream>>>(a, b, o,
                                                                  d);
  }
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
