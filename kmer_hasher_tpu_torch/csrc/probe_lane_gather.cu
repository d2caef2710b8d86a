// P10 on Hopper: a per-lane lookup table.
//
//   out[r, c] = tab[idx[r, c], c]     tab: [1024, 128] u32 (512 KB),
//                                     idx: [rows, 128] int32 in [0, 1024)
//
// (take_along_axis(tab, idx, axis=0)). Replaces kern0 of d3_gather_2d in
// tools/chip_probes/dma_probes_r3.py (kernel at :117, pallas_call at :124):
// there the whole table sat in VMEM beside a block of 1,024 index rows; the
// probe asked whether a 2-D gather inside a kernel compiles and what it
// costs per element, which decides whether a radix pass can keep one bucket
// table per lane.
//
// What bounds it: device memory, 8 bytes per element (4 of index read, 4 of
// value written); the table is read from L2 once per block. 512 KB does not
// fit one SM's 227 KB of shared memory, so a block takes a slab of 32 of the
// 128 columns: 1,024 x 32 entries = 128 KB of shared memory, one block per
// SM, the four slabs side by side in the grid. Lane l of a warp handles
// column c0 + l of a row, so the warp reads and writes 128-byte row
// segments, and its lookups slab[i * 32 + l] fall on bank l whatever the
// indices: no bank conflicts. Each thread keeps 16 rows' indices in flight.
// (The other form, the table left in L2 and read with plain loads, was not
// built: each lookup would be a 32-byte L2 sector for 4 bytes.)
//
// An index outside [0, 1024) reads nothing: its element comes out 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTableRows = 1 << 10;
constexpr int kCols = 128;
constexpr int kSlab = 32;  // columns of the table a block holds
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 16;  // rows in flight per thread
constexpr int kSmem = kTableRows * kSlab * 4;

__global__ void __launch_bounds__(kThreads, 1)
lane_gather_kernel(const uint32_t* __restrict__ tab,
                   const int* __restrict__ idx, long long rows,
                   uint32_t* __restrict__ out) {
  extern __shared__ uint32_t slab[];  // [kTableRows][kSlab]
  const int c0 = blockIdx.x * kSlab;
  for (int e = threadIdx.x; e < kTableRows * kSlab; e += kThreads) {
    slab[e] = tab[(e / kSlab) * kCols + c0 + e % kSlab];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long step =
      static_cast<long long>(gridDim.y) * kWarps * kUnroll;
  for (long long r0 = (static_cast<long long>(blockIdx.y) * kWarps + warp) *
                      kUnroll;
       r0 < rows; r0 += step) {
    int v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u;
      v[u] = r < rows ? idx[r * kCols + c0 + lane] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u;
      if (r < rows) {
        const unsigned i = static_cast<unsigned>(v[u]);
        out[r * kCols + c0 + lane] = i < kTableRows ? slab[i * kSlab + lane]
                                                    : 0u;
      }
    }
  }
}

}  // namespace

static_assert(kCols % kSlab == 0, "the slabs tile the columns");

// Launches P10 on `stream` of `device`: tab (`table_rows` = 1,024 rows of
// `cols` = 128 32-bit elements), idx and out ([rows, 128] 32-bit elements).
// Returns the CUDA error of the launch, 0 on success.
extern "C" int kmh_probe_lane_gather(const void* tab, int table_rows, int cols,
                                     const void* idx, long long rows,
                                     void* out, int device, void* stream) {
  if (table_rows != kTableRows || cols != kCols || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(lane_gather_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slabs = kCols / kSlab;
  long long groups = (rows + kWarps * kUnroll - 1) / (kWarps * kUnroll);
  const long long most = sms / slabs > 0 ? sms / slabs : 1;
  if (groups > most) groups = most;
  const dim3 grid(slabs, static_cast<unsigned int>(groups));
  lane_gather_kernel<<<grid, kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tab), static_cast<const int*>(idx), rows,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
