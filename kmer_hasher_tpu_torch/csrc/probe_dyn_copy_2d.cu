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
// row (probe_owner.cuh, shared with P9). The copy then runs over the rows of
// the output, not over the steps: a warp owns 32 neighbouring rows, reads
// their owners with one load and, per row, copies source row
// offs[t] + j - offs[T-1-t] of its owner t, or writes zeros where no step
// owns the row. A row is 512 bytes, 16 a lane, and a lane has 8 rows' loads
// in flight before it stores them. So every row of the output is written
// exactly once, the output needs no zero fill first, the result is the
// sequential one whatever the schedule, and the grid depends on neither the
// number of steps nor R. The first version ran a block per (step, 128 rows)
// over a zero-filled output: 0.3365 ms of device time at R = 8 (65,536
// blocks of 4 KB), 0.2722 at R = 512, against a 0.1603 ms bound; its zero
// fill took 0.081 ms of each and its copy 0.251 and 0.186. This one takes
// 0.1925 and 0.1909 ms (83-84% of the bound), the owner fill and pass 5 us
// of it; P1's plain copy of the same bytes takes 0.1768 (NVIDIA H100 80GB
// HBM3, 700.00 W). Where few rows are owned, its zeros go out at about 2.5
// TB/s, slower than a fill kernel's 3.3.
//
// Offsets must lie in [0, rows - R]. A step whose read or write window does
// not lie inside is skipped as a whole: it reads nothing, writes nothing and
// takes no row from an earlier step.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_owner.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarp = 32;
constexpr int kRowVec = 32;  // uint4 per row of 128 u32: one a lane
constexpr int kBatch = 8;    // rows whose loads a lane keeps in flight

__global__ void __launch_bounds__(kBlock)
dyn_copy_2d_kernel(const uint4* __restrict__ x, long long rows,
                   const int* __restrict__ offs, int steps,
                   const int* __restrict__ owner, uint4* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const long long j0 =  // the warp's first row
      (static_cast<long long>(blockIdx.x) * (kBlock / kWarp) +
       threadIdx.x / kWarp) * kWarp;
  if (j0 >= rows) return;  // the whole warp
  // the row of x that row j0 + lane of out takes, or -1: zeros
  long long src = -1;
  if (j0 + lane < rows) {
    const int t = owner[j0 + lane];
    if (t >= 0) src = offs[t] + (j0 + lane - offs[steps - 1 - t]);
  }
  const int nr = rows - j0 < kWarp ? static_cast<int>(rows - j0) : kWarp;
  for (int b = 0; b < nr; b += kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long s = __shfl_sync(0xffffffffu, src, b + u);
      v[u] = make_uint4(0, 0, 0, 0);
      if (b + u < nr && s >= 0) v[u] = __ldg(x + s * kRowVec + lane);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (b + u < nr) out[(j0 + b + u) * kRowVec + lane] = v[u];
    }
  }
}

}  // namespace

// Launches P5 on `stream` of `device`: x and out ([rows, 128] 32-bit
// elements, 16-byte aligned; the kernel writes every row of out), offs
// (`steps` int32 row offsets), r rows per copy, owner (`rows` int32, filled
// with -1 by the caller). Returns the CUDA error of the launches, 0 on
// success.
extern "C" int kmh_probe_dyn_copy_2d(const void* x, long long rows,
                                     const void* offs, int steps, int r,
                                     void* owner, void* out, int device,
                                     void* stream) {
  if (rows < 0 || steps < 0 || r < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      !kmh_probe::owner_grid_fits(steps, r)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps > 0) {
    err = kmh_probe::launch_owner(rows, static_cast<const int*>(offs), steps,
                                  r, static_cast<int*>(owner), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long warps = (rows + kWarp - 1) / kWarp;
  const long long blocks = (warps + kBlock / kWarp - 1) / (kBlock / kWarp);
  dyn_copy_2d_kernel<<<static_cast<unsigned int>(blocks), kBlock, 0, s>>>(
      static_cast<const uint4*>(x), rows, static_cast<const int*>(offs), steps,
      static_cast<const int*>(owner), static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
