// B3 on Hopper: one round of merge-path merging of adjacent sorted runs.
//
// Replaces kmer_hasher_tpu/ops/merge_sort.py::_merge_round_kernel (inner
// `kernel`, with its helpers _roll_flat_left, _reverse_tile and
// _bitonic_merge_tile, and the splits that merge_path_splits computed
// outside it). Given flat arrays of 2P consecutive sorted runs, bounded by
// bounds[0..2P], it writes for every pair p the merge of run 2p (A) and run
// 2p+1 (B) over the pair's own span [bounds[2p], bounds[2p+2]):
//
//   ascending by (key, payload); key a signed 64-bit integer, payload an
//   unsigned 32-bit integer; on a full tie A's element comes first.
//
// Run lengths are whatever the bounds say: unequal, shorter than a tile,
// zero. With the implicit payload (pay == nullptr) an element's payload is
// its row number in the flat input, so the output payload names the row
// every merged element came from and no payload lane is read at all.
// Bitwise what the plain PyTorch version (ops/cuda_merge.py::plain) gives.
//
// What bounds it: device memory. Per element a round reads 8 + 4 bytes and
// writes 8 + 4 (8 and 8 + 4 with the implicit payload); the arithmetic is
// about log2(run length) + log2(tile) + 2 comparisons per element.
//
// The TPU kernel had no per-lane control flow and no cheap gather, so it
// moved 1024-element granules, aligned them with decomposed rolls, padded
// short windows with all-ones and merged 2T elements with a bitonic network
// of XOR-partner rolls. None of that comes across. Here one block owns one
// output tile of kTile elements of one pair. It finds its own two diagonal
// split points by binary search in device memory, copies exactly its A and
// B windows (kTile elements together) into shared memory with coalesced
// loads, each thread finds its own sub-diagonal there and merges kItems
// elements serially into registers, and the tile goes back through shared
// memory so that neighbouring threads write neighbouring addresses. Bounds
// are checked against the window lengths, never against a sentinel: an
// all-ones key is a real value here. The block-level and the thread-level
// search use one predicate (leq, taken from A's side), so a tile boundary
// inside a long run of equal keys neither loses nor doubles an element.
// All pairs of a round go in one launch: the grid is pairs x tiles,
// flattened into x.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

// (ka, pa) <= (kb, pb): signed key, unsigned payload.
__device__ __forceinline__ bool leq(long long ka, unsigned int pa,
                                    long long kb, unsigned int pb) {
  return ka < kb || (ka == kb && pa <= pb);
}

// How many of the first `diag` merged elements come from A: the least i in
// [max(0, diag - nb), min(diag, na)] with not leq(A[i], B[diag - 1 - i]).
// `pa0` / `pb0` are the payloads of A[0] / B[0] under the implicit payload.
template <bool kImplicit>
__device__ __forceinline__ long long diagonal(
    const long long* __restrict__ ak, const unsigned int* __restrict__ ap,
    long long na, const long long* __restrict__ bk,
    const unsigned int* __restrict__ bp, long long nb, long long diag,
    unsigned int pa0, unsigned int pb0) {
  long long lo = diag > nb ? diag - nb : 0;
  long long hi = diag < na ? diag : na;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    const long long j = diag - 1 - mid;
    const unsigned int pa =
        kImplicit ? pa0 + static_cast<unsigned int>(mid) : ap[mid];
    const unsigned int pb =
        kImplicit ? pb0 + static_cast<unsigned int>(j) : bp[j];
    if (leq(ak[mid], pa, bk[j], pb)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <bool kImplicit>
__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const long long* __restrict__ keys,
                  const unsigned int* __restrict__ pay,
                  const long long* __restrict__ bounds,
                  long long tiles_per_pair,
                  long long* __restrict__ out_keys,
                  unsigned int* __restrict__ out_pay) {
  __shared__ long long s_key[kTile];
  __shared__ unsigned int s_pay[kTile];
  __shared__ long long s_split[2];

  const long long block = blockIdx.x;
  const long long pair = block / tiles_per_pair;
  const long long tile = block - pair * tiles_per_pair;
  const long long a0 = bounds[2 * pair];
  const long long b0 = bounds[2 * pair + 1];
  const long long na = b0 - a0;
  const long long nb = bounds[2 * pair + 2] - b0;
  const long long d0 = tile * kTile;
  if (d0 >= na + nb) return;  // the whole block: nothing is synchronised yet
  const long long d1 = d0 + kTile < na + nb ? d0 + kTile : na + nb;

  const long long* ak = keys + a0;
  const long long* bk = keys + b0;
  const unsigned int* ap = kImplicit ? nullptr : pay + a0;
  const unsigned int* bp = kImplicit ? nullptr : pay + b0;
  const unsigned int pa0 = static_cast<unsigned int>(a0);
  const unsigned int pb0 = static_cast<unsigned int>(b0);

  if (threadIdx.x < 2) {
    s_split[threadIdx.x] = diagonal<kImplicit>(
        ak, ap, na, bk, bp, nb, threadIdx.x == 0 ? d0 : d1, pa0, pb0);
  }
  __syncthreads();
  const long long ia = s_split[0];           // A window: [ia, ia + wa)
  const long long ib = d0 - ia;              // B window: [ib, ib + wb)
  const int wa = static_cast<int>(s_split[1] - ia);
  const int wb = static_cast<int>(d1 - d0) - wa;

  // stage the two windows side by side: A at [0, wa), B at [wa, wa + wb)
  for (int t = threadIdx.x; t < wa + wb; t += kThreads) {
    const long long g = t < wa ? a0 + ia + t : b0 + ib + (t - wa);
    s_key[t] = keys[g];
    s_pay[t] = kImplicit ? static_cast<unsigned int>(g) : pay[g];
  }
  __syncthreads();

  // this thread's sub-diagonal inside the tile, by the same predicate
  const int total = wa + wb;
  const int diag = min(static_cast<int>(threadIdx.x) * kItems, total);
  int lo = diag > wb ? diag - wb : 0;
  int hi = diag < wa ? diag : wa;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int j = wa + diag - 1 - mid;
    if (leq(s_key[mid], s_pay[mid], s_key[j], s_pay[j])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo;              // next of A, in [0, wa]
  int j = wa + diag - lo;  // next of B, in [wa, total]

  long long r_key[kItems];
  unsigned int r_pay[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const bool has_a = i < wa;
    const bool has_b = j < total;
    // a slot read past its window is never taken: the index stays in range
    const int ia_s = has_a ? i : 0;
    const int jb_s = has_b ? j : 0;
    const long long ka = s_key[ia_s];
    const unsigned int pa = s_pay[ia_s];
    const long long kb = s_key[jb_s];
    const unsigned int pb = s_pay[jb_s];
    const bool take_a = has_a && (!has_b || leq(ka, pa, kb, pb));
    r_key[it] = take_a ? ka : kb;
    r_pay[it] = take_a ? pa : pb;
    i += take_a ? 1 : 0;
    j += (!take_a && has_b) ? 1 : 0;
  }
  __syncthreads();  // every thread has read its inputs: reuse the tile
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (diag + it < total) {
      s_key[diag + it] = r_key[it];
      s_pay[diag + it] = r_pay[it];
    }
  }
  __syncthreads();
  const long long out0 = a0 + d0;
  for (int t = threadIdx.x; t < total; t += kThreads) {
    out_keys[out0 + t] = s_key[t];
    out_pay[out0 + t] = s_pay[t];
  }
}

}  // namespace

// Launches B3 on `stream` of `device`: one round over `n_pairs` pairs of
// runs. Pointers are device pointers: keys (int64), pay (uint32, or null
// for the implicit row-number payload), bounds (2 * n_pairs + 1 int64,
// ascending), out_keys / out_pay (as long as the inputs; written over
// [bounds[0], bounds[2 * n_pairs])). `max_pair_len` is the longest pair's
// element count and sizes the grid. Returns the CUDA error of the launch,
// 0 on success.
extern "C" int kmh_merge_path(const void* keys, const void* pay,
                              const void* bounds, long long n_pairs,
                              long long max_pair_len, void* out_keys,
                              void* out_pay, int device, void* stream) {
  if (n_pairs <= 0 || max_pair_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles_per_pair = (max_pair_len + kTile - 1) / kTile;
  const long long blocks = n_pairs * tiles_per_pair;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pay == nullptr) {
    merge_path_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const long long*>(keys), nullptr,
        static_cast<const long long*>(bounds), tiles_per_pair,
        static_cast<long long*>(out_keys),
        static_cast<unsigned int*>(out_pay));
  } else {
    merge_path_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const long long*>(keys),
        static_cast<const unsigned int*>(pay),
        static_cast<const long long*>(bounds), tiles_per_pair,
        static_cast<long long*>(out_keys),
        static_cast<unsigned int*>(out_pay));
  }
  return static_cast<int>(cudaGetLastError());
}
