// P1 on Hopper: the copy-bandwidth probe, out = x over 32-bit elements.
//
// Replaces the kernel of e1_copy_bandwidth in
// tools/chip_probes/sort_probes.py (kern at :41, pallas_call at :47), which
// copied [2^13, 128] blocks through the TPU's fast memory one grid step at
// a time. What it asks of the card is the ceiling a hand-written kernel
// reaches when it does nothing but move bytes; every "bound" of the other
// kernels assumes that ceiling is the data sheet's 3.35 TB/s.
//
// What bounds it: device memory, 8 bytes per element (4 read, 4 written),
// no arithmetic. The design is the simplest copy there is: one 16-byte unit
// a thread, no loop, a block of 1,024 threads for each 16 KB of x, so the
// grid holds n / 4,096 blocks and the block scheduler keeps every SM full
// to the end. Of the designs measured on an H100 beside CUDA's own
// device-to-device copy (grid-stride loops over one to eight waves of resident blocks with
// 1 to 8 loads in flight a thread, block tiles, contiguous runs a block,
// streaming and L2-prefetch hints, software pipelining, one tile a block)
// only one unit a thread with no loop matched it, 1,024-thread blocks a
// little ahead of 256; the earlier grid-stride loop of 16 blocks an SM was
// slower. Nothing is staged in shared memory: there is no reuse. When either pointer is not 16-byte aligned (a view
// that starts inside a tensor) the same kernel runs on 4-byte units. The
// last n % 4 elements of the 16-byte path are copied by the first block's
// first threads, in the same launch. The launcher asks the device nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;

// n 32-bit elements; T the unit a thread copies (uint4 or u32)
template <typename T>
__global__ void __launch_bounds__(kBlock)
copy_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
            long long n) {
  constexpr int kWords = sizeof(T) / 4;
  const long long units = n / kWords;
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (i < units) {
    reinterpret_cast<T*>(dst)[i] = reinterpret_cast<const T*>(src)[i];
  }
  if (kWords > 1 && blockIdx.x == 0 && threadIdx.x < n - units * kWords) {
    const long long j = units * kWords + threadIdx.x;
    dst[j] = src[j];
  }
}

template <typename T>
cudaError_t launch(const uint32_t* src, uint32_t* dst, long long n,
                   cudaStream_t stream) {
  const long long units = n / (sizeof(T) / 4);
  long long blocks = (units + kBlock - 1) / kBlock;
  if (blocks < 1) blocks = 1;  // the n % 4 tail alone
  copy_kernel<T><<<static_cast<unsigned int>(blocks), kBlock, 0, stream>>>(
      src, dst, n);
  return cudaGetLastError();
}

}  // namespace

// Copies n 32-bit elements from src to dst (device pointers, 4-byte aligned,
// not overlapping) on `stream` of `device`. Returns the CUDA error of the
// launch, 0 on success.
extern "C" int kmh_probe_copy(const void* src, void* dst, long long n,
                              int device, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* a = static_cast<const uint32_t*>(src);
  auto* b = static_cast<uint32_t*>(dst);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  return static_cast<int>(aligned ? launch<uint4>(a, b, n, s)
                                  : launch<uint32_t>(a, b, n, s));
}
