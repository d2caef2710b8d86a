// P8 on Hopper: a gather from a 4 KB table held in shared memory.
//
//   out[i] = tab[idx[i]]      tab: 1,024 u32, idx: int32 in [0, 1024)
//
// Replaces the kernel of r4_vmem_gather in
// tools/chip_probes/sort_probes_r3.py (kern at :232, pallas_call at :241):
// there the table sat in VMEM and each grid step took a block of 1,024
// indices through jnp.take; the probe asked whether a vector gather from
// fast memory compiles and what it costs per element, which decides whether
// a radix pass can look its bucket offsets up in place.
//
// What bounds it: device memory, 8 bytes per element (4 of index read, 4 of
// value written); the table is read once. The design: a block copies the
// table to shared memory once (256 threads, one 16-byte load each) and then
// walks over chunks of the index with a grid stride, so the table is not
// fetched again for every 4 KB of indices. A thread reads four indices with
// one 16-byte load (neighbouring threads on neighbouring addresses), makes
// four 4-byte reads of shared memory and writes one 16-byte store. Random
// indices collide on the 32 banks (about 3.5 deep on average for 32 lanes),
// which is the probe's question: what the collisions cost beside device
// memory.
//
// An index outside [0, 1024) reads nothing: its element comes out 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTable = 1 << 10;
constexpr int kPerThread = 4;    // 16-byte index loads in flight per thread
constexpr int kMaxBlocks = 132 * 8;

__device__ __forceinline__ uint32_t pick(const uint32_t* tab, int i) {
  return (i >= 0 && i < kTable) ? tab[i] : 0u;
}

__global__ void __launch_bounds__(kBlock)
smem_gather_kernel(const uint4* __restrict__ tab, const int4* __restrict__ idx,
                   long long n4, uint4* __restrict__ out) {
  __shared__ uint4 tab4[kTable / 4];
  tab4[threadIdx.x] = tab[threadIdx.x];  // kTable / 4 == kBlock
  __syncthreads();
  const uint32_t* t = reinterpret_cast<const uint32_t*>(tab4);
  const long long span = static_cast<long long>(kBlock) * kPerThread;
  for (long long base = blockIdx.x * span; base < n4;
       base += gridDim.x * span) {
    int4 v[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const long long i = base + j * kBlock + threadIdx.x;
      v[j] = i < n4 ? idx[i] : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const long long i = base + j * kBlock + threadIdx.x;
      if (i < n4) {
        out[i] = make_uint4(pick(t, v[j].x), pick(t, v[j].y), pick(t, v[j].z),
                            pick(t, v[j].w));
      }
    }
  }
}

}  // namespace

static_assert(kTable / 4 == kBlock, "one 16-byte table load per thread");

// Launches P8 on `stream` of `device`: tab (`table` = 1,024 32-bit
// elements), idx (n int32, n a multiple of 4), out (n 32-bit elements), all
// 16-byte aligned. Returns the CUDA error of the launch, 0 on success.
extern "C" int kmh_probe_smem_gather(const void* tab, int table,
                                     const void* idx, long long n, void* out,
                                     int device, void* stream) {
  if (table != kTable || n < 0 || n % 4 != 0 ||
      reinterpret_cast<uintptr_t>(tab) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(idx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long n4 = n / 4;
  const long long span = static_cast<long long>(kBlock) * kPerThread;
  long long blocks = (n4 + span - 1) / span;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  smem_gather_kernel<<<static_cast<unsigned int>(blocks), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tab), static_cast<const int4*>(idx), n4,
      static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
