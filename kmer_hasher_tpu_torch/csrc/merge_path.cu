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
// The TPU kernel had no per-lane control flow and no cheap gather, so it
// moved 1024-element granules, aligned them with decomposed rolls, padded
// short windows with all-ones and merged 2T elements with a bitonic network
// of XOR-partner rolls. None of that comes across.
//
// What bounds it: device memory. Per element a round reads 8 + 4 bytes and
// writes 8 + 4 (8 and 8 + 4 with the implicit payload); the arithmetic is
// about log2(tile) + 2 comparisons per element and one search of log2(run
// length) steps a tile. A block that searched its own diagonals in device
// memory would wait on up to 25 dependent loads before its bytes moved;
// 8-byte keys at a stride of 8 elements a lane would meet 16-way bank
// conflicts; small tiles would make the searches weigh more. So:
//
// - Two kernels a round, both launched by kmh_merge_path. The partition
//   pass gives every tile boundary of every pair its split once, one
//   thread a boundary, all boundaries at once: a round waits for one
//   binary search, not for one a block. The splits go to scratch that
//   follows the bounds in the same buffer.
// - The merge kernel: one block a tile of kTile = 4,096 output elements
//   of one pair. It reads its two splits, stages exactly its A and B windows
//   into shared memory with 8- and 4-byte cp.async copies (no register in
//   between, all in flight at once), each thread finds its own
//   sub-diagonal there and merges kItems = 16 elements serially, holding the
//   next A and B element in registers (one shared load a step), and the
//   tile goes back through shared memory so that neighbouring threads write
//   neighbouring addresses.
// - Shared memory holds element i at i + i / 16: a thread's 16 elements
//   start 17 slots after its neighbour's, so the write-back and the start of
//   the merge are free of bank conflicts.
//
// Bounds are checked against the window lengths, never against a sentinel:
// an all-ones key is a real value here. The partition pass, the thread
// search and the serial merge use one predicate (leq), so a tile boundary
// inside a long run of equal keys neither loses nor doubles an element.
// All pairs of a round go in one launch of each kernel: the grid is pairs
// x tiles, flattened into x.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kSlots = kTile + kTile / 16;  // element i at slot i + i / 16
constexpr int kSmem = kSlots * (8 + 4);
constexpr int kSearchThreads = 128;  // threads of a partition block

__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// (ka, pa) <= (kb, pb): signed key, unsigned payload, A's element on the
// left. With the implicit payload every row of A lies before every row of
// B, so A's payload is the smaller and the keys alone decide.
template <bool kImplicit>
__device__ __forceinline__ bool leq(long long ka, unsigned int pa,
                                    long long kb, unsigned int pb) {
  if (kImplicit) return ka <= kb;
  return ka < kb || (ka == kb && pa <= pb);
}

__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// One thread per tile boundary t of pair p (t in [0, tiles_per_pair]): how
// many of the first min(t * kTile, |A| + |B|) merged elements come from A,
// the least i in [max(0, d - |B|), min(d, |A|)] with not leq(A[i],
// B[d - 1 - i]), by binary search. Neighbouring threads search
// neighbouring diagonals, so the first steps of a warp's searches read the
// same elements; payloads are read only where the keys tie.
template <bool kImplicit>
__global__ void __launch_bounds__(kSearchThreads)
partition_kernel(const long long* __restrict__ keys,
                 const unsigned int* __restrict__ pay,
                 const long long* __restrict__ bounds, long long n_pairs,
                 long long tiles_per_pair, long long* __restrict__ splits) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kSearchThreads + threadIdx.x;
  if (w >= n_pairs * (tiles_per_pair + 1)) return;
  const long long pair = w / (tiles_per_pair + 1);
  const long long t = w - pair * (tiles_per_pair + 1);
  const long long a0 = bounds[2 * pair];
  const long long b0 = bounds[2 * pair + 1];
  const long long na = b0 - a0;
  const long long nb = bounds[2 * pair + 2] - b0;
  const long long d = t * kTile < na + nb ? t * kTile : na + nb;
  long long lo = d > nb ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long i = lo + ((hi - lo) >> 1);
    const long long j = d - 1 - i;
    const long long ka = keys[a0 + i];
    const long long kb = keys[b0 + j];
    const bool below =
        ka < kb || (ka == kb && (kImplicit || leq<kImplicit>(
                                     ka, pay[a0 + i], kb, pay[b0 + j])));
    if (below) {
      lo = i + 1;
    } else {
      hi = i;
    }
  }
  splits[w] = lo;
}

template <bool kImplicit>
__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const long long* __restrict__ keys,
                  const unsigned int* __restrict__ pay,
                  const long long* __restrict__ bounds,
                  long long tiles_per_pair,
                  const long long* __restrict__ splits,
                  long long* __restrict__ out_keys,
                  unsigned int* __restrict__ out_pay) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_key = reinterpret_cast<long long*>(smem);
  unsigned int* s_pay = reinterpret_cast<unsigned int*>(s_key + kSlots);

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

  const long long* split = splits + pair * (tiles_per_pair + 1) + tile;
  const long long ia = split[0];             // A window: [ia, ia + wa)
  const long long ib = d0 - ia;              // B window: [ib, ib + wb)
  const int wa = static_cast<int>(split[1] - ia);
  const int total = static_cast<int>(d1 - d0);
  const int wb = total - wa;
  // the implicit payload of window element t: its row in the flat input
  const unsigned int ra = static_cast<unsigned int>(a0 + ia);
  const unsigned int rb = static_cast<unsigned int>(b0 + ib) - wa;

  // stage the two windows side by side: A at [0, wa), B at [wa, total)
  for (int t = threadIdx.x; t < total; t += kThreads) {
    const long long g = t < wa ? a0 + ia + t : b0 + ib + (t - wa);
    cp_async_8(s_key + slot(t), keys + g);
    if (!kImplicit) cp_async_4(s_pay + slot(t), pay + g);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  auto pay_at = [&](int t) -> unsigned int {
    if (kImplicit) return t < wa ? ra + t : rb + t;
    return s_pay[slot(t)];
  };

  // this thread's sub-diagonal inside the tile, by the same predicate
  const int diag = min(static_cast<int>(threadIdx.x) * kItems, total);
  int lo = diag > wb ? diag - wb : 0;
  int hi = diag < wa ? diag : wa;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int j = wa + diag - 1 - mid;
    if (leq<kImplicit>(s_key[slot(mid)], pay_at(mid), s_key[slot(j)],
                       pay_at(j))) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo;              // next of A, in [0, wa]
  int j = wa + diag - lo;  // next of B, in [wa, total]

  // the next element of each side in registers; a slot read past its
  // window is never taken, so its index only has to stay in range
  long long ka = s_key[slot(i < wa ? i : 0)];
  unsigned int pa = pay_at(i < wa ? i : 0);
  long long kb = s_key[slot(j < total ? j : 0)];
  unsigned int pb = pay_at(j < total ? j : 0);
  long long r_key[kItems];
  unsigned int r_pay[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const bool take_a =
        i < wa && (j >= total || leq<kImplicit>(ka, pa, kb, pb));
    r_key[it] = take_a ? ka : kb;
    r_pay[it] = take_a ? pa : pb;
    const int next = take_a ? ++i : ++j;
    const int at = next < (take_a ? wa : total) ? next : 0;
    const long long kn = s_key[slot(at)];
    const unsigned int pn = pay_at(at);
    ka = take_a ? kn : ka;
    pa = take_a ? pn : pa;
    kb = take_a ? kb : kn;
    pb = take_a ? pb : pn;
  }
  __syncthreads();  // every thread has read its inputs: reuse the tile
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (diag + it < total) {
      s_key[slot(diag + it)] = r_key[it];
      s_pay[slot(diag + it)] = r_pay[it];
    }
  }
  __syncthreads();
  const long long out0 = a0 + d0;
  for (int t = threadIdx.x; t < total; t += kThreads) {
    out_keys[out0 + t] = s_key[slot(t)];
    out_pay[out0 + t] = s_pay[slot(t)];
  }
}

constexpr int kMaxDevices = 64;

// Raises merge_path_kernel<kImplicit>'s dynamic shared-memory limit to
// kSmem on `device` at its first launch there, and only then: two first
// launches that race both set the same limit.
template <bool kImplicit>
cudaError_t allow_smem(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_relaxed)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      merge_path_kernel<kImplicit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess) done[device].store(true, std::memory_order_relaxed);
  return err;
}

template <bool kImplicit>
cudaError_t launch(const void* keys, const void* pay, const void* bounds,
                   long long n_pairs, long long tiles_per_pair,
                   long long* splits, void* out_keys, void* out_pay,
                   int device, cudaStream_t s) {
  const long long search_blocks =
      (n_pairs * (tiles_per_pair + 1) + kSearchThreads - 1) / kSearchThreads;
  cudaError_t err = allow_smem<kImplicit>(device);
  if (err != cudaSuccess) return err;
  partition_kernel<kImplicit>
      <<<static_cast<unsigned int>(search_blocks), kSearchThreads, 0, s>>>(
          static_cast<const long long*>(keys),
          static_cast<const unsigned int*>(pay),
          static_cast<const long long*>(bounds), n_pairs, tiles_per_pair,
          splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_path_kernel<kImplicit>
      <<<static_cast<unsigned int>(n_pairs * tiles_per_pair), kThreads, kSmem,
         s>>>(static_cast<const long long*>(keys),
              static_cast<const unsigned int*>(pay),
              static_cast<const long long*>(bounds), tiles_per_pair, splits,
              static_cast<long long*>(out_keys),
              static_cast<unsigned int*>(out_pay));
  return cudaGetLastError();
}

long long tiles_for(long long max_pair_len) {
  return (max_pair_len + kTile - 1) / kTile;
}

}  // namespace

// How many int64 of scratch kmh_merge_path needs after the bounds: one
// split per tile boundary of every pair.
extern "C" long long kmh_merge_path_scratch(long long n_pairs,
                                            long long max_pair_len) {
  if (n_pairs <= 0 || max_pair_len <= 0) return 0;
  return n_pairs * (tiles_for(max_pair_len) + 1);
}

// Launches B3 on `stream` of `device`: one round over `n_pairs` pairs of
// runs, the partition pass and then the merge. Pointers are device
// pointers: keys (int64), pay (uint32, or null for the implicit row-number
// payload), bounds (2 * n_pairs + 1 int64, ascending, followed by
// kmh_merge_path_scratch(n_pairs, max_pair_len) int64 that the partition
// pass writes and the merge reads), out_keys / out_pay (as long as the
// inputs; written over [bounds[0], bounds[2 * n_pairs])). `max_pair_len` is
// the longest pair's element count and sizes the grids. Returns the CUDA
// error of the launches, 0 on success.
extern "C" int kmh_merge_path(const void* keys, const void* pay,
                              const void* bounds, long long n_pairs,
                              long long max_pair_len, void* out_keys,
                              void* out_pay, int device, void* stream) {
  if (n_pairs <= 0 || max_pair_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles_per_pair = tiles_for(max_pair_len);
  const long long search_blocks =
      (n_pairs * (tiles_per_pair + 1) + kSearchThreads - 1) / kSearchThreads;
  if (n_pairs * tiles_per_pair > 2147483647LL ||
      search_blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* splits =
      const_cast<long long*>(static_cast<const long long*>(bounds)) +
      2 * n_pairs + 1;
  err = pay == nullptr
            ? launch<true>(keys, pay, bounds, n_pairs, tiles_per_pair, splits,
                           out_keys, out_pay, device, s)
            : launch<false>(keys, pay, bounds, n_pairs, tiles_per_pair,
                            splits, out_keys, out_pay, device, s);
  return static_cast<int>(err);
}
