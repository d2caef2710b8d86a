// P6 on Hopper: a gather of 2 KB records from row offsets that only the
// device knows.
//
//   out[i*R : (i+1)*R, :] = x[offs[i] : +R, :]     R = 4 rows of 128 u32
//
// Replaces the kernel of r2b_small_dma_rate in
// tools/chip_probes/sort_probes_r3.py (kern at :139, pallas_call at :158):
// there each grid step started 64 DMAs of 2 KB, one semaphore each, and then
// waited for all of them; the probe asked how many small transfers a second
// the DMA engine sustains, the bound of a distribution pass that moves
// segments. Here no engine is asked: a warp is the transfer.
//
// What bounds it: device memory, 4 KB per record (2 KB read, 2 KB written)
// plus 4 bytes of offset; with the reference's 4,096 records (16 MB) the
// launch. The design: one warp per record. A lane reads the offset (one
// broadcast load), issues its four 16-byte loads (the record's 128 uint4
// over 32 lanes, neighbouring lanes on neighbouring addresses, all four in
// flight before the first store) and stores them the same way. A row is 512
// bytes, so every record is 16-byte aligned on both sides.
//
// Offsets must lie in [0, rows - R]; a record whose window does not lie
// inside x reads nothing and comes out as zeros.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kRows = 4;                   // R, rows per record
constexpr int kRecVec = kRows * 128 / 4;  // uint4 per record: 128

__global__ void __launch_bounds__(kBlock)
small_copy_kernel(const uint4* __restrict__ x, long long rows,
                  const int* __restrict__ offs, long long n_rec,
                  uint4* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (i >= n_rec) return;
  const int lane = threadIdx.x % 32;
  const long long off = offs[i];
  uint4 v[kRecVec / 32];
  if (off >= 0 && off + kRows <= rows) {
    const uint4* s = x + off * 32;
#pragma unroll
    for (int j = 0; j < kRecVec / 32; ++j) v[j] = s[j * 32 + lane];
  } else {
#pragma unroll
    for (int j = 0; j < kRecVec / 32; ++j) v[j] = make_uint4(0, 0, 0, 0);
  }
  uint4* d = out + i * kRecVec;
#pragma unroll
  for (int j = 0; j < kRecVec / 32; ++j) d[j * 32 + lane] = v[j];
}

}  // namespace

// Launches P6 on `stream` of `device`: x ([rows, 128] 32-bit elements), offs
// (n_rec int32 row offsets), out ([n_rec * r, 128]), both 16-byte aligned;
// `r` must be 4. Returns the CUDA error of the launch, 0 on success.
extern "C" int kmh_probe_small_copy(const void* x, long long rows,
                                    const void* offs, long long n_rec, int r,
                                    void* out, int device, void* stream) {
  if (rows < 0 || n_rec < 0 || r != kRows ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rec == 0) return 0;
  const long long blocks = (n_rec + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  small_copy_kernel<<<static_cast<unsigned int>(blocks), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), rows, static_cast<const int*>(offs), n_rec,
      static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
