// B4: K-way AND-SUB sweep with early exit (the aggregator's device pass),
// one request or a batch of requests per launch.
//
// Replaces agg_and_sub_pallas (bitmagic_tpu/ops/pallas_kernels.py:270-289,
// call :241-267, body _agg_sweep_body :171-238) and, on the card, the XLA
// fusions _agg_kernel / _agg_any_kernel (bitmagic_tpu/agg/aggregator.py:80,
// :108) and the vmapped _pipeline_results_kernel (:875), which is the
// batched form below.
//
// Per request r and result column i (one 8 KiB block row):
//   AND/SUB mode: acc = ~0; acc &= row_k (k < n_and); acc &= ~row_k (k >= n_and)
//   OR mode:      acc =  0; acc |= row_k for every k
// so n_and = 0 in AND/SUB mode is the complement of the OR of the SUB rows
// (the all-ones start of _pipeline_results_kernel), and a request with no
// operands gives all ones.  Each operand comes as the gather descriptor of
// bm_common.cuh (pool, slot, full, aux, aux_slot) in a device table; request
// r reads ops[begin_r .. begin_r + n_ops_r).  One kernel so serves the
// per-vector descriptors of the aggregator's combine_* calls, the arena form
// (one pool, a slot matrix; an AND operand's slot -1 is passed as `full`, a
// SUB operand's stays zero: the identity rule of pallas_kernels.py:221-228)
// and the pipeline's dense stack.  An absent or FULL row is never read.
//
// Bound: the operand rows read until a column's accumulator is zero, and
// the result rows written.  On the card a sweep at config 3 (128 columns,
// ~17 operands each) moves ~20 MB, so its time is a fixed cost of launch
// and first round trip plus the rows read at the card's rate; every row
// read past a column's death costs as much as the latency it might hide.
// Design:
//  - A column is cut into slices, one CTA per (request, column, slice), one
//    16-byte vector per thread and operand.  Each slice keeps its own early
//    exit, and a slice dies no later than its column (4096 bits against
//    65536): fewer rows are read than with a column-wide exit.  One request
//    takes 16 slices of 512 B (32 threads; config 3's 128 columns give 2048
//    CTAs instead of 128); a batch takes 8 of 1 KiB (64 threads), since its
//    many requests fill the card anyway and its rows rarely die, where
//    fewer, larger CTAs measured faster.
//  - In a batch the request index varies fastest over the grid, so the CTAs
//    of one column run together for every request, and a row that several
//    requests select is read again from L2 rather than from memory.
//  - A CTA resolves the descriptors of up to 32 (64) operands at once, one
//    thread each, into shared memory (bm::resolve issues a descriptor's
//    index reads together), so a chunk costs two round trips.
//  - kGroup = 4 operands are loaded (four 16-byte loads per thread in
//    flight), folded, and voted on (__syncthreads_or); the next group is
//    issued after the vote.  Issuing the next group before the vote measured
//    slower at configs 3 and 4b: a row read past a slice's death costs more
//    than the round trip it hides.  So no load is in flight at a CTA's exit
//    (the Pallas body leaves copy k+1 unawaited, :210-233).
//  - Rows-off counts (per-column popcount, _agg_any_kernel): each warp adds
//    its slice's popcount atomically into counts, which the caller zeroes.
// A 0-row pool is legal: every slot must then be -1.  Either output may be
// omitted.
#include <cstddef>

#include "bm_common.cuh"

static_assert(sizeof(bm::Operand) == 56, "descriptor table: 7 x 8 bytes");
static_assert(offsetof(bm::Operand, pool_rows) == 8, "descriptor layout");
static_assert(offsetof(bm::Operand, slot) == 16, "descriptor layout");
static_assert(offsetof(bm::Operand, full) == 24, "descriptor layout");
static_assert(offsetof(bm::Operand, aux) == 32, "descriptor layout");
static_assert(offsetof(bm::Operand, aux_rows) == 40, "descriptor layout");
static_assert(offsetof(bm::Operand, aux_slot) == 48, "descriptor layout");

namespace {

constexpr int kSlicesSingle = 16;                     // 512 B slices
constexpr int kSlicesBatch = 8;                       // 1 KiB slices
constexpr int kGroup = 4;                             // operands per vote

// One request of the batched form: its operands are
// ops[begin .. begin + n_ops), the first n_and of them ANDed.
struct Request {
  int begin;
  int n_ops;
  int n_and;
  int pad;
};
static_assert(sizeof(Request) == 16, "request table: 4 x int32");

// One CTA per (request, column, slice): one 16-byte vector per thread and
// operand, so a CTA has as many threads as its slice has vectors.  The
// grid is linear, the request index fastest: b = (i * SLICES + slice) *
// n_req + request.
template <int SLICES>
__global__ void __launch_bounds__(bm::kBlockVec / SLICES)
agg_sweep_kernel(const bm::Operand* __restrict__ ops,
                 const Request* __restrict__ reqs, int n_req, int n_ops,
                 int n_and, int or_mode, int k, uint4* __restrict__ out,
                 int32_t* __restrict__ counts) {
  constexpr int kSliceVec = bm::kBlockVec / SLICES;    // = threads
  constexpr int kChunk = kSliceVec;                    // operands resolved
  const int req = static_cast<int>(blockIdx.x % n_req);
  const int cs = static_cast<int>(blockIdx.x / n_req);
  const int i = cs / SLICES;
  const int slice = cs % SLICES;
  const int t = threadIdx.x;
  int begin = 0;
  if (reqs != nullptr) {
    const Request q = reqs[req];
    begin = q.begin;
    n_ops = q.n_ops;
    n_and = q.n_and;
  }
  __shared__ bm::RowSrc src[kChunk];
  const uint32_t init = or_mode ? 0u : 0xFFFFFFFFu;
  uint4 acc = make_uint4(init, init, init, init);
  bool live = true;
  for (int k0 = 0; k0 < n_ops && live; k0 += kChunk) {
    const int n = min(kChunk, n_ops - k0);
    __syncthreads();                    // the previous chunk's src is read
    if (t < n) {
      bm::RowSrc r = bm::resolve(ops[begin + k0 + t], i);
      if (r.ptr != nullptr) r.ptr += slice * kSliceVec;
      src[t] = r;
    }
    __syncthreads();
    for (int j = 0; j < n; j += kGroup) {
      uint4 x[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        x[g] = j + g < n ? bm::load(src[j + g], t)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (j + g >= n) break;
        if (or_mode) {
          acc.x |= x[g].x; acc.y |= x[g].y; acc.z |= x[g].z; acc.w |= x[g].w;
        } else if (k0 + j + g < n_and) {
          acc.x &= x[g].x; acc.y &= x[g].y; acc.z &= x[g].z; acc.w &= x[g].w;
        } else {
          acc.x &= ~x[g].x; acc.y &= ~x[g].y; acc.z &= ~x[g].z;
          acc.w &= ~x[g].w;
        }
      }
      // AND/SUB: go on while some word is nonzero; OR: while some word is
      // not yet all ones
      const int mine = or_mode
          ? (acc.x & acc.y & acc.z & acc.w) != 0xFFFFFFFFu
          : (acc.x | acc.y | acc.z | acc.w) != 0u;
      live = __syncthreads_or(mine) != 0;
      if (!live) break;
    }
  }
  const size_t col = static_cast<size_t>(req) * k + i;
  if (out != nullptr) {
    out[col * bm::kBlockVec + slice * kSliceVec + t] = acc;
  }
  if (counts != nullptr) {
    const uint32_t c = __reduce_add_sync(0xFFFFFFFFu, bm::popc4(acc));
    if ((t & 31) == 0 && c != 0u) {
      atomicAdd(counts + col, static_cast<int32_t>(c));
    }
  }
}

template <int SLICES>
int launch(const void* ops, const void* reqs, int n_req, int n_ops,
           int n_and, int or_mode, int k, void* out, void* counts,
           cudaStream_t stream) {
  if (static_cast<long long>(n_req) * k * SLICES > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(n_req) * k * SLICES;
  agg_sweep_kernel<SLICES><<<grid, bm::kBlockVec / SLICES, 0, stream>>>(
      static_cast<const bm::Operand*>(ops),
      static_cast<const Request*>(reqs), n_req, n_ops, n_and, or_mode, k,
      static_cast<uint4*>(out), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ops: device table of bm::Operand descriptors, all aligned on k columns
// (k >= 1).  reqs: null for one request of n_ops operands (n_ops >= 1, 0 <=
// n_and <= n_ops, or_mode 0 or 1), else a device table of n_req Requests
// (n_ops and n_and then come from the table; or_mode must be 0).
// out: int32[n_req, k, 2048] or null; counts: int32[n_req, k], zeroed by
// the caller, or null.  n_req * k * 16 (one request) or n_req * k * 8 (a
// batch) must not pass 2^31 - 1.  Returns the CUDA error of the launch (0 =
// launched).
extern "C" int bm_agg_and_sub(const void* ops, const void* reqs, int n_req,
                              int n_ops, int n_and, int or_mode, int k,
                              void* out, void* counts, void* stream) {
  if (k <= 0 || (out == nullptr && counts == nullptr) || n_req <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reqs == nullptr ? (n_req != 1 || n_ops <= 0 || n_and < 0 ||
                         n_and > n_ops)
                      : or_mode != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return reqs == nullptr
      ? launch<kSlicesSingle>(ops, reqs, 1, n_ops, n_and, or_mode, k, out,
                              counts, s)
      : launch<kSlicesBatch>(ops, reqs, n_req, 0, 0, 0, k, out, counts, s);
}
