// P5 on Hopper: row windows copied between offsets that only the device
// knows, in the order of the steps.
//
//   for t = 0 .. T-1, in order:
//     out[offs[T-1-t] : +R, :] = x[offs[t] : +R, :]      rows of 128 u32
//
// on an output that starts as zeros. Replaces the kernel of r2_dyn_dma_2d in
// tools/chip_probes/sort_probes_r3.py (kern at :86, pallas_call at :103):
// there each grid step issued one DMA from a row offset prefetched as a
// scalar into scratch memory and a second one out to another row offset, and
// the steps ran one after the other, so where two write windows meet the
// later step's rows stand. The probe asked whether such copies compile and
// what they reach; a radix pass that stages buckets needs them.
//
// What bounds it: device memory, 1,024 bytes per row moved (512 read, 512
// written) plus the offsets. What is hard here is the order: blocks run at
// once, so "the later step wins" has to be decided, not waited for. It is
// decided once, in a pass before the copy: every step writes its number into
// owner[row] for the rows of its write window with atomicMax (owner starts at
// -1), which leaves each row with the last step that writes it at 12 bytes a
// row (probe_owner.cuh, shared with P9). The copy then moves, with 16-byte
// loads and stores (a row is 512
// bytes, so every window is aligned), only the rows its step owns. No row of
// the output is then written twice, and the result is the sequential one
// whatever the schedule.
//
// Offsets must lie in [0, rows - R]. A step whose read or write window does
// not lie inside is skipped as a whole: it reads nothing, writes nothing and
// takes no row from an earlier step.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_owner.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kRowVec = 32;        // uint4 per row of 128 u32
constexpr int kRowsPerBlock = 128;  // rows of one window a block copies

__global__ void __launch_bounds__(kBlock)
dyn_copy_2d_kernel(const uint4* __restrict__ x, long long rows,
                   const int* __restrict__ offs, int steps, int r,
                   const int* __restrict__ owner, uint4* __restrict__ out) {
  __shared__ unsigned char mine[kRowsPerBlock];
  const int t = blockIdx.x;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int nr = min(kRowsPerBlock, r - r0);
  const long long src = offs[t];
  const long long dst = offs[steps - 1 - t];
  if (!kmh_probe::inside(src, r, rows) || !kmh_probe::inside(dst, r, rows)) {
    return;  // the whole block
  }
  const long long lo = dst + r0;  // this block's first row of out
  for (int i = threadIdx.x; i < nr; i += kBlock) mine[i] = owner[lo + i] == t;
  __syncthreads();
  const uint4* s4 = x + (src + r0) * kRowVec;
  uint4* d4 = out + lo * kRowVec;
#pragma unroll 4
  for (int j = threadIdx.x; j < nr * kRowVec; j += kBlock) {
    if (mine[j / kRowVec]) d4[j] = s4[j];
  }
}

}  // namespace

// Launches P5 on `stream` of `device`: x and out ([rows, 128] 32-bit
// elements, 16-byte aligned, out zero-filled by the caller), offs (`steps`
// int32 row offsets), r rows per copy, owner (`rows` int32, filled with -1 by
// the caller). Returns the CUDA error of the launch, 0 on success.
extern "C" int kmh_probe_dyn_copy_2d(const void* x, long long rows,
                                     const void* offs, int steps, int r,
                                     void* owner, void* out, int device,
                                     void* stream) {
  if (rows < 0 || steps < 0 || r < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (r + kRowsPerBlock - 1) / kRowsPerBlock;
  if (chunks > 65535 || !kmh_probe::owner_grid_fits(steps, r)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (steps == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = kmh_probe::launch_owner(rows, static_cast<const int*>(offs), steps, r,
                                static_cast<int*>(owner), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(steps),
                  static_cast<unsigned int>(chunks));
  dyn_copy_2d_kernel<<<grid, kBlock, 0, s>>>(
      static_cast<const uint4*>(x), rows, static_cast<const int*>(offs), steps,
      r, static_cast<const int*>(owner), static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
