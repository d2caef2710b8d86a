// B1 on Hopper: per-position forward k-mer and window validity.
//
// Replaces kmer_hasher_tpu/ops/pallas_encode.py::_kernel (launched by
// _encode_raw; entries pallas_encode and pallas_encode_batch). For every
// start position i of a byte stream viewed as rows of `row_len` bytes:
//
//   key[i]   = the k bases starting at i, 2 bits each, code (c >> 1) & 3,
//              first base highest; bases past the end of the row read as 0
//   valid[i] = no byte n/N among those k, and col(i) + k <= lengths[row(i)]
//
// which is bitwise what the plain PyTorch version (ops/encode.py) gives.
//
// What bounds it: device memory. Per position it reads 1 byte and writes
// 9 (an int64 key and a bool). The TPU kernel computed every window by
// log2(k) shift-OR doubling over [264, 128] tiles with an 8-row halo,
// because its vector unit has no cheap per-lane loop. The first version
// here gave one thread a window start and ran a k-step byte loop behind a
// 64-bit division for the row: 1.6724 ms of device time at 2^26 bytes, k =
// 32, 12% of its bound, of which the loop took 1.28 ms and the division
// 0.06 (variants without each, NVIDIA H100 80GB HBM3, 700.00 W). This
// design encodes every base once per block instead of once per window:
//  - A block owns a tile of kTile window starts. Each thread loads one
//    16-byte chunk of the tile and its 31-byte halo, from the 16-byte
//    boundary at or below the tile's first byte (byte loads only where a
//    chunk crosses an end of the stream, so any byte offset of the input
//    works), and packs it into shared memory as 32 bits of 2-bit codes and
//    16 N flags, the first base highest: a few integer operations per 4
//    bases, one barrier.
//  - A window's 32 bases are then two funnel shifts of three neighbouring
//    chunks' codes, its key a right shift by 64 - 2k; its N test the same on
//    the flags. A window that runs past its row's end (left = row_end - i <
//    k) clears the low 2 * (k - left) bits of the key and the low k - left
//    bits of its N window.
//  - No division per position: each thread finds the row of its first
//    window once and steps it by the remainder of its stride, computed
//    once. One length for every row (a 1-D stream) is a kernel argument.
//  - A thread writes two neighbouring windows, so a warp stores 512
//    contiguous bytes of keys and 64 of validity.
// Measured: 0.2344 ms at 2^26 bytes, k = 32 (0.2345 at k = 21), 85% of the
// 0.2003 ms bound (NVIDIA H100 80GB HBM3, 700.00 W). The stores alone take
// 0.1834 ms; the rest is, untested, each block's load and packing before
// its first store. Tiles of 8,192, blocks of 128 or 512 threads, streaming stores and
// occupancy forced to 6 or 8 blocks an SM were no faster.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 4096;  // window starts of one block
constexpr int kMaxK = 32;
// 16-byte chunks of the stream a block packs: from the 16-byte boundary at
// or below the tile's first byte, the tile, its 31-byte halo, and the
// chunks that the last windows' three-chunk reads reach
constexpr int kChunks = kTile / 16 + 4;
constexpr int kStride = 2 * kBlock;  // window starts a block's pass covers

// The 2-bit codes of 4 bases (byte 0 first) as one byte, first base in its
// highest two bits.
__device__ __forceinline__ unsigned pack4(unsigned x) {
  unsigned c = __byte_perm((x >> 1) & 0x03030303u, 0, 0x0123);
  c = (c | (c >> 6)) & 0x000F000Fu;
  return (c | (c >> 12)) & 0xFFu;
}

// The N flags of 4 bases (byte 0 first) as 4 bits, first base highest.
__device__ __forceinline__ unsigned n4(unsigned x) {
  const unsigned eq = __vcmpeq4(x | 0x20202020u, 0x6E6E6E6Eu);
  return ((eq & 0x01020408u) * 0x01010101u) >> 24;
}

// 16 bases: (codes, 32 bits; N flags, 16 bits), the first base highest.
__device__ __forceinline__ uint2 pack16(uint4 v) {
  return make_uint2(
      pack4(v.x) << 24 | pack4(v.y) << 16 | pack4(v.z) << 8 | pack4(v.w),
      n4(v.x) << 12 | n4(v.y) << 8 | n4(v.z) << 4 | n4(v.w));
}

// (row, col) moved on by d < 2^31 positions in rows of `len`.
__device__ __forceinline__ void advance(long long& row, long long& col,
                                        unsigned d, long long len) {
  if (d < len) {
    col += d;
  } else {  // len <= d < 2^31: a 32-bit division
    const unsigned l = static_cast<unsigned>(len);
    row += d / l;
    col += d % l;
  }
  if (col >= len) {
    col -= len;
    ++row;
  }
}

// The window of 32 bases from base s of chunk a on (chunks a, b, c in
// order): (codes, the first base highest; N flags, the same).
__device__ __forceinline__ void window32(uint2 a, uint2 b, uint2 c, int s,
                                         unsigned long long& codes,
                                         unsigned& nflags) {
  codes = static_cast<unsigned long long>(__funnelshift_l(b.x, a.x, 2 * s))
              << 32 |
          __funnelshift_l(c.x, b.x, 2 * s);
  nflags = __funnelshift_l(c.y << 16, a.y << 16 | b.y, s);
}

__global__ void __launch_bounds__(kBlock)
encode_kernel(const uint8_t* __restrict__ seq, long long n, long long row_len,
              const int* __restrict__ lengths, long long length, int k,
              unsigned long long* __restrict__ key,
              uint8_t* __restrict__ valid) {
  __shared__ uint2 chunk[kChunks];  // pack16 of each chunk
  __shared__ long long first[2];    // row and column of the tile's start

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  // chunk c holds bytes base - head + 16c .. + 15 of the stream
  const uintptr_t addr = reinterpret_cast<uintptr_t>(seq);
  const int head = static_cast<int>(addr & 15);
  const uint4* aligned = reinterpret_cast<const uint4*>(addr - head);
  for (int c = threadIdx.x; c < kChunks; c += blockDim.x) {
    const long long g = base - head + 16LL * c;
    uint4 v;
    if (g >= 0 && g + 16 <= n) {
      v = __ldg(aligned + base / 16 + c);
    } else {  // a chunk across an end of the stream: bytes outside are 0
      unsigned w[4] = {0, 0, 0, 0};
      for (int i = 0; i < 16; ++i) {
        if (g + i >= 0 && g + i < n) {
          w[i >> 2] |= static_cast<unsigned>(seq[g + i]) << (8 * (i & 3));
        }
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    chunk[c] = pack16(v);
  }
  if (threadIdx.x == 0) {
    first[0] = base / row_len;
    first[1] = base - first[0] * row_len;
  }
  __syncthreads();

  const long long len = row_len;
  long long row = first[0], col = first[1];
  advance(row, col, 2 * threadIdx.x, len);
  long long step_row = 0, step_col = 0;  // a pass of the block: kStride
  advance(step_row, step_col, kStride, len);
  const int key_shift = 64 - 2 * k;
  const int n_shift = 32 - k;
#pragma unroll 2
  for (int o = 2 * threadIdx.x; o < kTile; o += kStride) {
    const long long p = base + o;
    if (p >= n) break;
    const int u = o + head;  // the window's first base in chunk order
    const int c0 = u >> 4;
    const uint2 q0 = chunk[c0], q1 = chunk[c0 + 1], q2 = chunk[c0 + 2],
                q3 = chunk[c0 + 3];
    unsigned long long kk[2];
    bool ok[2];
    long long r = row, c = col;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = (u + e) & 15;
      const bool next = e == 1 && s == 0;  // the second window's chunk
      unsigned long long win;
      unsigned nv;
      window32(next ? q1 : q0, next ? q2 : q1, next ? q3 : q2, s, win, nv);
      unsigned long long kv = win >> key_shift;
      nv >>= n_shift;
      const long long left = len - c;  // bases of the row from here on
      if (left < k) {
        const int d = k - static_cast<int>(left);
        kv &= ~0ULL << (2 * d);
        nv >>= d;
      }
      const long long lim =
          lengths == nullptr ? length
                             : (p + e < n ? __ldg(lengths + r) : 0LL);
      kk[e] = kv;
      ok[e] = nv == 0 && c + k <= lim;
      if (++c == len) {
        c = 0;
        ++r;
      }
    }
    if (p + 1 < n) {
      reinterpret_cast<ulonglong2*>(key)[p >> 1] = make_ulonglong2(kk[0], kk[1]);
      reinterpret_cast<unsigned short*>(valid)[p >> 1] =
          static_cast<unsigned short>(ok[0] | (ok[1] << 8));
    } else {
      key[p] = kk[0];
      valid[p] = ok[0];
    }
    row += step_row;
    col += step_col;
    if (col >= len) {
      col -= len;
      ++row;
    }
  }
}

}  // namespace

// Launches B1 on `stream` of `device`. Pointers are device pointers: seq (n
// bytes, any alignment), key (n int64, 16-byte aligned), valid (n bool,
// 2-byte aligned), and lengths (n / row_len int32, one a row) or null, when
// every row's length is `length`. Returns the CUDA error of the launch, 0
// on success.
extern "C" int kmh_encode(const void* seq, long long n, long long row_len,
                          const void* lengths, long long length, int k,
                          void* key, void* valid, int device, void* stream) {
  if (n <= 0 || row_len <= 0 || n % row_len != 0 || k < 1 || k > kMaxK ||
      reinterpret_cast<uintptr_t>(key) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(valid) % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kTile - 1) / kTile;
  encode_kernel<<<static_cast<unsigned int>(blocks), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), n, row_len,
      static_cast<const int*>(lengths), length, k,
      static_cast<unsigned long long*>(key), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kmh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
