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
// indices: no bank conflicts.
//
// At the TPU probe's 2^20 indices the data is 8 MB, a few microseconds of
// the card, so the slab has to arrive in about one latency and every SM
// needs an equal share. The design:
//  - Each thread loads its 128 bytes of the slab as eight 16-byte loads,
//    all in flight before the first store to shared memory (a table that
//    does not start on a 16-byte boundary: 32 loads of 4 bytes, the same
//    way). Bulk copies (cp.async.bulk) of the slab's 1,024 row segments of
//    128 bytes against one mbarrier took several times as long at 2^20 on
//    an H100: the copies are served one at a time.
//  - A task is kUnroll consecutive rows of one warp, its 16 index loads in
//    flight together. Tasks are dealt round robin over the row groups, so
//    consecutive tasks fall on different SMs and every SM gets an equal
//    share even where there are fewer tasks than warps; a warp loads its
//    next task's indices as soon as it has stored the current one's.
//  - The grid is the four slabs times as many row groups as the occupancy
//    API says fit on the card (one block an SM), and no more than there
//    are tasks. The launcher raises the shared-memory limit and asks for
//    the occupancy once per device, not on every launch.
//
// An index outside [0, 1024) reads nothing: its element comes out 0.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTableRows = 1 << 10;
constexpr int kCols = 128;
constexpr int kSlab = 32;  // columns of the table a block holds
constexpr int kSlabs = kCols / kSlab;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 16;  // rows of a task
constexpr int kSmem = kTableRows * kSlab * 4;

// This thread's share of the slab, every load in flight before the first
// store: as uint4 (T = uint4, a 16-byte aligned table) or as u32.
template <typename T>
__device__ __forceinline__ void load_slab(const uint32_t* __restrict__ tab,
                                          int c0, uint32_t* slab) {
  constexpr int kWords = sizeof(T) / 4;
  constexpr int kRowUnits = kSlab / kWords;  // units of a slab row
  constexpr int kPer = kTableRows * kRowUnits / kThreads;
  const T* t = reinterpret_cast<const T*>(tab);
  T* s = reinterpret_cast<T*>(slab);
  T v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = u * kThreads + threadIdx.x;  // unit of the slab
    v[u] = t[(e / kRowUnits) * (kCols / kWords) + c0 / kWords +
             e % kRowUnits];
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) s[u * kThreads + threadIdx.x] = v[u];
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lane_gather_kernel(const uint32_t* __restrict__ tab,
                   const int* __restrict__ idx, long long rows,
                   uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t slab[];  // [kTableRows][kSlab]
  const int c0 = blockIdx.x * kSlab;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  load_slab<T>(tab, c0, slab);

  const long long tasks = (rows + kUnroll - 1) / kUnroll;
  const long long groups = gridDim.y;
  const long long stride = groups * kWarps;
  long long task = blockIdx.y + groups * warp;
  int v[kUnroll];
  auto load = [&](long long t) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = t * kUnroll + u;
      v[u] = r < rows ? idx[r * kCols + c0 + lane] : 0;
    }
  };
  if (task < tasks) load(task);
  __syncthreads();
  for (; task < tasks; task += stride) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = task * kUnroll + u;
      if (r < rows) {
        const unsigned i = static_cast<unsigned>(v[u]);
        out[r * kCols + c0 + lane] = i < kTableRows ? slab[i * kSlab + lane]
                                                    : 0u;
      }
    }
    if (task + stride < tasks) load(task + stride);
  }
}

constexpr int kMaxDevices = 64;

// Blocks of lane_gather_kernel<T> that fit on `device` at once (one an SM),
// found on the first launch there, after the shared-memory limit is raised,
// and kept: two first launches that race compute the same number.
template <typename T>
cudaError_t resident_blocks(int device, int* blocks) {
  static std::atomic<int> cache[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int got = cache[device].load(std::memory_order_relaxed);
  if (got == 0) {
    auto kernel = lane_gather_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kSmem);
    if (err != cudaSuccess) return err;
    got = sms * (per_sm > 0 ? per_sm : 1);
    cache[device].store(got, std::memory_order_relaxed);
  }
  *blocks = got;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const uint32_t* tab, const int* idx, long long rows,
                   uint32_t* out, int device, cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = resident_blocks<T>(device, &resident);
  if (err != cudaSuccess) return err;
  const long long tasks = (rows + kUnroll - 1) / kUnroll;
  long long groups = resident / kSlabs > 0 ? resident / kSlabs : 1;
  if (groups > tasks) groups = tasks;
  lane_gather_kernel<T><<<dim3(kSlabs, static_cast<unsigned int>(groups)),
                          kThreads, kSmem, stream>>>(tab, idx, rows, out);
  return cudaGetLastError();
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
  const auto* t = static_cast<const uint32_t*>(tab);
  const auto* i = static_cast<const int*>(idx);
  auto* o = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(reinterpret_cast<uintptr_t>(tab) % 16 == 0
                              ? launch<uint4>(t, i, rows, o, device, s)
                              : launch<uint32_t>(t, i, rows, o, device, s));
}
