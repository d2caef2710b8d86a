// P2 on Hopper: copies from offsets that only the device knows.
//
//   out[t * CH + j] = x[offs[t] + j],   t < tiles, j < CH = 2^13
//
// Replaces the kernel of e2_dynamic_dma in tools/chip_probes/sort_probes.py
// (kern at :69, pallas_call at :82): there one DMA per grid step read CH
// elements at an offset prefetched as a scalar, and the probe asked which
// offset granules the TPU's DMA engine takes. Here the question is what a
// window that starts at an arbitrary element costs against one that starts
// on a 16-byte boundary: the merge-path kernel stages such windows.
//
// What bounds it: device memory, 8 bytes per element plus 4 per tile; with
// 64 tiles the launch itself. The design: one block per tile. The block
// reads offs[t] from device memory (the host never does), stages the window
// in shared memory and writes the tile with 16-byte stores, which are always
// aligned (a tile starts at a multiple of 32 KB). The loads take their width
// from the source address: 16 bytes when x + off is 16-byte aligned
// (granules 1,024 and 8, and one offset in four at granule 1), else 4 bytes,
// which any element offset satisfies. Both forms read neighbouring
// addresses from neighbouring threads, so a misaligned window costs extra
// load instructions and at most one extra 32-byte sector per warp request,
// not extra passes.
//
// Offsets must lie in [0, n - CH]; the kernel reads no element outside x
// whatever they are (such elements come out 0).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 1 << 13;  // CH, elements per tile: 32 KB of shared

__global__ void __launch_bounds__(kBlock)
dyn_copy_kernel(const uint32_t* __restrict__ x, long long n,
                const int* __restrict__ offs, uint32_t* __restrict__ out) {
  __shared__ uint4 tile4[kChunk / 4];
  uint32_t* tile = reinterpret_cast<uint32_t*>(tile4);
  const long long off = offs[blockIdx.x];
  const uint32_t* src = x + off;
  const bool inside = off >= 0 && off + kChunk <= n;
  if (inside && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    for (int j = threadIdx.x; j < kChunk / 4; j += kBlock) tile4[j] = src4[j];
  } else if (inside) {
    for (int j = threadIdx.x; j < kChunk; j += kBlock) tile[j] = src[j];
  } else {
    for (int j = threadIdx.x; j < kChunk; j += kBlock) {
      const long long g = off + j;
      tile[j] = (g >= 0 && g < n) ? x[g] : 0u;
    }
  }
  __syncthreads();
  uint4* dst4 = reinterpret_cast<uint4*>(
      out + static_cast<long long>(blockIdx.x) * kChunk);
  for (int j = threadIdx.x; j < kChunk / 4; j += kBlock) dst4[j] = tile4[j];
}

}  // namespace

// Launches P2 on `stream` of `device`: x (n 32-bit elements), offs (tiles
// int32 element offsets), out (tiles * chunk elements, 16-byte aligned);
// `chunk` must be 2^13. Returns the CUDA error of the launch, 0 on success.
extern "C" int kmh_probe_dyn_copy(const void* x, long long n, const void* offs,
                                  int tiles, int chunk, void* out, int device,
                                  void* stream) {
  if (n < 0 || tiles < 0 || chunk != kChunk ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dyn_copy_kernel<<<static_cast<unsigned int>(tiles), kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), n, static_cast<const int*>(offs),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
