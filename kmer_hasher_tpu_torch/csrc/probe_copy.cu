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
// no arithmetic. The design: 16-byte loads and stores, neighbouring threads
// on neighbouring addresses, a grid-stride loop in which each thread has
// four independent loads in flight before its first store, and a grid of a
// few blocks per SM so that no launch is longer than it need be. Nothing is
// staged in shared memory: there is no reuse. When either pointer is not
// 16-byte aligned (a view that starts inside a tensor) the same loop runs on
// 4-byte elements; the last n % 4 elements always do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 16;

template <typename T>
__global__ void __launch_bounds__(kBlock)
copy_kernel(const T* __restrict__ src, T* __restrict__ dst, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < n; i += stride) dst[i] = src[i];
}

template <typename T>
cudaError_t launch(const T* src, T* dst, long long n, int sms,
                   cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  long long blocks = (n + kBlock - 1) / kBlock;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(src);
  uint32_t* b = static_cast<uint32_t*>(dst);
  const bool aligned = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  const long long vec = aligned ? n / 4 : 0;
  err = launch(reinterpret_cast<const uint4*>(a), reinterpret_cast<uint4*>(b),
               vec, sms, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch(a + 4 * vec, b + 4 * vec, n - 4 * vec, sms, s));
}
