// The ownership pass of the row-window copies P5 (probe_dyn_copy_2d.cu) and
// P9 (probe_pipelined_copy.cu).
//
// Both compute, for t = 0 .. T-1 in order,
//   out[offs[T-1-t] : +R, :] = x[offs[t] : +R, :]
// with the later step's rows standing where write windows meet, and a step
// whose read or write window leaves x skipped whole. Blocks run at once, so
// "the later step wins" is decided before the copy: every step that is not
// skipped writes its number into owner[row] for the rows of its write window
// with atomicMax (owner starts at -1). A row then holds the last step that
// writes it, or -1 where no step does; 12 bytes a row (the fill, the atomic,
// the copy's read) beside the 1,024 that the copy moves.

#pragma once

#include <cuda_runtime.h>

namespace kmh_probe {

constexpr int kOwnerBlock = 256;

__device__ __forceinline__ bool inside(long long off, int r, long long rows) {
  return off >= 0 && off + r <= rows;
}

// owner[row] = the last step whose write window holds the row.
static __global__ void __launch_bounds__(kOwnerBlock)
owner_kernel(long long rows, const int* __restrict__ offs, int steps, int r,
             int* __restrict__ owner) {
  const long long i =
      blockIdx.x * static_cast<long long>(kOwnerBlock) + threadIdx.x;
  if (i >= static_cast<long long>(steps) * r) return;
  const int t = static_cast<int>(i / r);
  const long long src = offs[t];
  const long long dst = offs[steps - 1 - t];
  if (!inside(src, r, rows) || !inside(dst, r, rows)) return;
  atomicMax(owner + dst + i % r, t);
}

inline long long owner_blocks(int steps, int r) {
  return (static_cast<long long>(steps) * r + kOwnerBlock - 1) / kOwnerBlock;
}

// Whether one launch of the pass covers steps * r marks.
inline bool owner_grid_fits(int steps, int r) {
  return owner_blocks(steps, r) <= 0x7fffffffLL;
}

// Launches the pass on `stream` (steps >= 1; owner filled with -1 by the
// caller); returns the launch's error.
inline cudaError_t launch_owner(long long rows, const int* offs, int steps,
                                int r, int* owner, cudaStream_t stream) {
  owner_kernel<<<static_cast<unsigned int>(owner_blocks(steps, r)),
                 kOwnerBlock, 0, stream>>>(rows, offs, steps, r, owner);
  return cudaGetLastError();
}

}  // namespace kmh_probe
