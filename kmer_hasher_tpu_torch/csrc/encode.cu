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
// 9 (an int64 key and a bool); the arithmetic is a few integer ops per
// base. The TPU kernel computed every window by log2(k) shift-OR doubling
// over [264, 128] tiles with an 8-row halo, because its vector unit has
// no cheap per-lane loop. Here one thread owns one window start: a block
// stages its 256 bytes plus a (k-1)-byte halo in shared memory once,
// coalesced, and each thread folds at most 32 bytes from shared memory
// into a 64-bit register. Every input byte leaves device memory about
// once and every output is written once, coalesced.
//
// Measured on an H100 80GB HBM3 at 700 W (2^26 bytes, k=32): about
// 1.75 ms, 11% of the card's 3.35 TB/s: this first version is not yet
// memory-bound. The likely cost, untested, is per-thread work (the 64-bit
// division for the row, the k-step byte loop).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxK = 32;

__global__ void __launch_bounds__(kBlock)
encode_kernel(const uint8_t* __restrict__ seq, long long n, long long row_len,
              const int* __restrict__ lengths, int k,
              long long* __restrict__ key, bool* __restrict__ valid) {
  __shared__ uint8_t tile[kBlock + kMaxK - 1];
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  for (int t = threadIdx.x; t < kBlock + k - 1; t += kBlock) {
    const long long g = base + t;
    tile[t] = g < n ? seq[g] : static_cast<uint8_t>(0);
  }
  __syncthreads();

  const long long i = base + threadIdx.x;
  if (i >= n) return;
  const long long row = i / row_len;
  const long long col = i - row * row_len;
  const long long left = row_len - col;  // bases of the row from i on
  const int avail = left < k ? static_cast<int>(left) : k;

  unsigned long long v = 0;
  bool has_n = false;
  for (int j = 0; j < k; ++j) {
    unsigned int c = 0;
    if (j < avail) {
      const unsigned int b = tile[threadIdx.x + j];
      c = (b >> 1) & 3u;
      has_n = has_n || ((b | 0x20u) == static_cast<unsigned int>('n'));
    }
    v = (v << 2) | c;
  }
  key[i] = static_cast<long long>(v);
  valid[i] = !has_n && col + k <= static_cast<long long>(lengths[row]);
}

}  // namespace

// Launches B1 on `stream` of `device`. Pointers are device pointers:
// seq (n bytes), lengths (n / row_len int32), key (n int64), valid (n
// bool). Returns the CUDA error of the launch, 0 on success.
extern "C" int kmh_encode(const void* seq, long long n, long long row_len,
                          const void* lengths, int k, void* key, void* valid,
                          int device, void* stream) {
  if (n <= 0 || row_len <= 0 || n % row_len != 0 || k < 1 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kBlock - 1) / kBlock;
  encode_kernel<<<static_cast<unsigned int>(blocks), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), n, row_len,
      static_cast<const int*>(lengths), k, static_cast<long long*>(key),
      static_cast<bool*>(valid));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kmh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
