// Q1 and Q2 on Hopper: the bounds and the hit expansion of seq_kmer_pos.
//
// They replace no TPU kernel. The JAX package leaves both steps to XLA
// (searchsorted, cumsum and gathers in kmer_hasher_tpu/index/query.py), and
// the port first did the same with about 30 small PyTorch operations a
// query. A query of the pool the port serves is 10 kb to 1 Mb long, so the
// card's work is 0.05–0.5 ms a query and the host's dispatch of those
// launches outweighed it (the card idle four fifths of the time). These two
// kernels take the place of all but B1 and one prefix sum.
//
// Q1, ranges_kernel: for each window w of the query, from B1's (key, valid)
//   lb[w] = the first row of s_key[0, n_valid) whose key is >= sortable(key)
//   c[w]  = valid[w] && w != drop ? (rows equal to that key) : 0
// bitwise what index/query.py::_query_ranges gives (two searchsorted
// calls, the trailing-exact-k mask, a where). `drop` is the window that the
// trailing-exact-k quirk drops, or -1; the host finds it from its own copy
// of the query.
//   What bounds it: the dependent loads of a binary search, one thread a
//   window. A query's keys fall at random over the 320 MB of s_key, so
//   each search is about 26 loads of one 32-byte sector, the top levels
//   shared through L1/L2 and the last 6–10 in device memory. The bytes that
//   must move are 9 a window in, 16 out, and the sectors of the search's
//   last levels. Its design: one full search for lb only; ub gallops
//   forward from lb (at k=21 nearly every key occurs once, so it is one
//   load, in lb's sector or the next). So the second 26-step search of the
//   plain version goes.
//
// Q2, hits_kernel: the rows [start, start + n) of the hit table,
//   out[g - start] = (w + k, s_pos[lb[w] + g - cum_c[w - 1]])
// where w, the owner of global row g, is the first window with cum_c[w] >
// g: bitwise index/query.py::_hit_chunk. What bounds it: per row, the
// 8-byte store, the 8-byte lb[w] and one scattered 4-byte s_pos load (a
// sector of device memory), and the owner search. Its design: a block owns
// kTile consecutive rows, finds the owners of its first and last row by two
// searches over cum_c (8 bytes a window; a 1 Mb query's 8 MB stay in L2),
// stages cum_c over those owners in shared memory when they are at most
// kCache windows (the case of any query with hits: a row a window or more),
// and searches there; otherwise it searches that range in device memory.
// Rows are interleaved over the threads, so a warp stores 256 contiguous
// bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRangesBlock = 256;
constexpr int kHitsBlock = 256;
constexpr int kRowsPerThread = 8;
constexpr int kTile = kHitsBlock * kRowsPerThread;  // rows of one block
constexpr int kCache = 4096;  // owner windows a block stages, at most
constexpr unsigned long long kSign = 1ULL << 63;

// The first index of a[0, n) whose value is >= q (n if none).
__device__ __forceinline__ long long lower_bound(
    const long long* __restrict__ a, long long n, long long q) {
  long long lo = 0;
  while (n > 0) {
    const long long half = n >> 1;
    if (__ldg(a + lo + half) < q) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The first index of a[lb, n) whose value is > q, given a[lb] == q:
// galloping from lb, then a binary search inside the last step.
__device__ __forceinline__ long long upper_from(
    const long long* __restrict__ a, long long n, long long lb, long long q) {
  long long lo = lb + 1, hi = lb + 1, step = 1;
  while (hi < n && __ldg(a + hi) <= q) {  // a[lo - 1] <= q throughout
    lo = hi + 1;
    step <<= 1;
    hi = lb + step < n ? lb + step : n;
  }
  while (lo < hi) {  // hi == n or a[hi] > q
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The first index of a[lo, hi) whose value is > g (hi if none).
__device__ __forceinline__ long long owner(const long long* __restrict__ a,
                                           long long lo, long long hi,
                                           long long g) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) > g) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kRangesBlock)
ranges_kernel(const unsigned long long* __restrict__ key,
              const uint8_t* __restrict__ valid, long long windows,
              const long long* __restrict__ s_key, long long n_valid,
              long long drop, long long* __restrict__ lb_out,
              long long* __restrict__ c_out) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kRangesBlock + threadIdx.x;
  if (w >= windows) return;
  const long long q = static_cast<long long>(key[w] ^ kSign);
  const long long lb = lower_bound(s_key, n_valid, q);
  long long c = 0;
  if (valid[w] && w != drop && lb < n_valid && __ldg(s_key + lb) == q) {
    c = upper_from(s_key, n_valid, lb, q) - lb;
  }
  lb_out[w] = lb;
  c_out[w] = c;
}

__global__ void __launch_bounds__(kHitsBlock)
hits_kernel(const int* __restrict__ s_pos, const long long* __restrict__ lb,
            const long long* __restrict__ cum_c, long long windows, int k,
            long long start, long long n, int2* __restrict__ out) {
  // cache[i] = cum_c[wa - 1 + i], with cum_c[-1] = 0
  __shared__ long long cache[kCache + 1];
  __shared__ long long ends[2];  // the owners of the first and last row
  const long long r0 = start + static_cast<long long>(blockIdx.x) * kTile;
  const long long r1 = r0 + kTile < start + n ? r0 + kTile : start + n;
  if (threadIdx.x == 0) ends[0] = owner(cum_c, 0, windows, r0);
  if (threadIdx.x == 32) ends[1] = owner(cum_c, 0, windows, r1 - 1);
  __syncthreads();
  const long long wa = ends[0], wb = ends[1];
  const long long span = wb - wa + 1;
  const bool staged = wb < windows && span <= kCache;
  if (staged) {
    for (long long i = threadIdx.x; i <= span; i += kHitsBlock) {
      const long long w = wa - 1 + i;
      cache[i] = w < 0 ? 0 : __ldg(cum_c + w);
    }
  }
  __syncthreads();
#pragma unroll 2
  for (int e = 0; e < kRowsPerThread; ++e) {
    const long long g = r0 + e * kHitsBlock + threadIdx.x;
    if (g >= r1) break;
    long long w, before;
    if (staged) {
      // cache[0] <= r0 <= g < cache[span]: the owner is in [1, span]
      int lo = 1, hi = static_cast<int>(span);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cache[mid] > g) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      w = wa - 1 + lo;
      before = cache[lo - 1];
    } else {
      w = owner(cum_c, wa, wb < windows ? wb + 1 : windows, g);
      if (w >= windows) {  // a row past the total: never asked for
        out[g - start] = make_int2(0, 0);
        continue;
      }
      before = w == 0 ? 0 : __ldg(cum_c + w - 1);
    }
    out[g - start] = make_int2(static_cast<int>(w + k),
                               __ldg(s_pos + __ldg(lb + w) + (g - before)));
  }
}

}  // namespace

// Launches Q1 on `stream` of `device`. Device pointers: key (windows
// int64, B1's raw keys), valid (windows bool), s_key (n_valid or more
// sortable int64 keys, sorted over the first n_valid), lb and c (windows
// int64 each, written). `drop` is a window index, or -1. Returns the CUDA
// error of the launch, 0 on success.
extern "C" int kmh_query_ranges(const void* key, const void* valid,
                                long long windows, const void* s_key,
                                long long n_valid, long long drop, void* lb,
                                void* c, int device, void* stream) {
  if (windows <= 0 || n_valid < 0 ||
      (windows + kRangesBlock - 1) / kRangesBlock > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (windows + kRangesBlock - 1) / kRangesBlock;
  ranges_kernel<<<static_cast<unsigned int>(blocks), kRangesBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(key),
      static_cast<const uint8_t*>(valid), windows,
      static_cast<const long long*>(s_key), n_valid, drop,
      static_cast<long long*>(lb), static_cast<long long*>(c));
  return static_cast<int>(cudaGetLastError());
}

// Launches Q2 on `stream` of `device`: rows [start, start + n) of the hit
// table into out ([n, 2] int32, 8-byte aligned). Device pointers: s_pos
// (int32 1-based starts), lb and cum_c (windows int64 each; cum_c the
// inclusive prefix sum of the counts). Needs start + n <= cum_c[windows -
// 1], which the caller read back. Returns the CUDA error of the launch.
extern "C" int kmh_query_hits(const void* s_pos, const void* lb,
                              const void* cum_c, long long windows, int k,
                              long long start, long long n, void* out,
                              int device, void* stream) {
  if (windows <= 0 || start < 0 || n <= 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0 ||
      (n + kTile - 1) / kTile > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kTile - 1) / kTile;
  hits_kernel<<<static_cast<unsigned int>(blocks), kHitsBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(s_pos), static_cast<const long long*>(lb),
      static_cast<const long long*>(cum_c), windows, k, start, n,
      static_cast<int2*>(out));
  return static_cast<int>(cudaGetLastError());
}
