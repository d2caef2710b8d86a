// P7 on Hopper: P2's copies again, through the card's asynchronous copy.
//
//   out[t * CH + j] = x[offs[t] + j],   t < tiles, j < CH = 2^13
//
// Replaces the kernel of r3_dyn_dma_1d in
// tools/chip_probes/sort_probes_r3.py (kern at :190, pallas_call at :201):
// the same function as e2_dynamic_dma of sort_probes.py, asked a second time
// because the TPU's toolchain had moved. Here it is asked a second time
// because the card has a second way to do it: probe_dyn_copy.cu (P2) stages
// each window with plain loads through registers; this kernel stages it with
// cp.async, global to shared memory without a register in between, and the
// probe prints both times from one call.
//
// What bounds it: device memory, 8 bytes per element plus 4 per tile; with 64
// tiles the launch. The design: one block per tile, as P2. The block reads
// offs[t] itself and takes the copy's width from the source address: 16
// bytes (cp.async.cg, past L1) where x + off is 16-byte aligned, else 4
// bytes (cp.async.ca; an element offset is always 4-byte aligned). Every
// thread issues all its copies, then cp.async.wait_all and a barrier, then
// the tile leaves shared memory with 16-byte stores, which are always
// aligned. cp.async rather than cp.async.bulk (TMA): the bulk copy needs a
// 16-byte aligned source, so the windows this probe is about, those that
// start at an arbitrary element, would still need a second path, and one
// instruction family serving both widths keeps the comparison with P2 clean.
//
// Offsets must lie in [0, n - CH]; the kernel reads no element outside x
// whatever they are (such elements come out 0, through guarded plain loads).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 1 << 13;  // CH, elements per tile: 32 KB of shared

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__global__ void __launch_bounds__(kBlock)
async_copy_kernel(const uint32_t* __restrict__ x, long long n,
                  const int* __restrict__ offs, uint32_t* __restrict__ out) {
  __shared__ uint4 tile4[kChunk / 4];
  uint32_t* tile = reinterpret_cast<uint32_t*>(tile4);
  const long long off = offs[blockIdx.x];
  const uint32_t* src = x + off;
  const bool inside = off >= 0 && off + kChunk <= n;
  if (inside && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    for (int j = threadIdx.x; j < kChunk / 4; j += kBlock)
      cp_async_16(tile4 + j, src4 + j);
  } else if (inside) {
    for (int j = threadIdx.x; j < kChunk; j += kBlock)
      cp_async_4(tile + j, src + j);
  } else {
    for (int j = threadIdx.x; j < kChunk; j += kBlock) {
      const long long g = off + j;
      tile[j] = (g >= 0 && g < n) ? x[g] : 0u;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  uint4* dst4 = reinterpret_cast<uint4*>(
      out + static_cast<long long>(blockIdx.x) * kChunk);
  for (int j = threadIdx.x; j < kChunk / 4; j += kBlock) dst4[j] = tile4[j];
}

}  // namespace

// Launches P7 on `stream` of `device`: x (n 32-bit elements), offs (tiles
// int32 element offsets), out (tiles * chunk elements, 16-byte aligned);
// `chunk` must be 2^13. Returns the CUDA error of the launch, 0 on success.
extern "C" int kmh_probe_async_copy(const void* x, long long n,
                                    const void* offs, int tiles, int chunk,
                                    void* out, int device, void* stream) {
  if (n < 0 || tiles < 0 || chunk != kChunk ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  async_copy_kernel<<<static_cast<unsigned int>(tiles), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), n, static_cast<const int*>(offs),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
