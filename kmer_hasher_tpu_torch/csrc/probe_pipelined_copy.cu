// P9 on Hopper: row windows copied between offsets that only the device
// knows, in the order of the steps, through a ring of shared-memory stages
// kept full by the Tensor Memory Accelerator's bulk copies.
//
//   for t = 0 .. T-1, in order:
//     out[offs[T-1-t] : +R, :] = x[offs[t] : +R, :]      rows of 128 u32
//
// on an output that starts as zeros: P5's function (probe_dyn_copy_2d.cu).
// Replaces the kernel of d1_pipelined_dyn_dma in
// tools/chip_probes/dma_probes_r3.py (kern at :44, pallas_call at :82):
// there each grid step waited for its window's DMA into one of two VMEM
// slots, started the next step's read into the other slot, and wrote its
// slot out to the mirrored offset. The probe asked whether copies kept in
// flight that way reach the copy ceiling, and, with dynamic=False (D2, the
// control: offsets t*R and (T-1-t)*R computed, not read), what reading the
// offset from memory costs.
//
// What bounds it: device memory, 1,024 bytes per row moved (512 read, 512
// written). The design:
//  - Persistent blocks of one warp walk the work items (step t, chunk c of
//    its window) g = blockIdx.x, + gridDim.x, ...; a chunk is up to 32 rows
//    (16 KB), so a 512-row window (256 KB, more than one SM's 227 KB of
//    shared memory) moves in 16 pieces, and the items of all steps spread
//    evenly over the blocks.
//  - A block holds kStages chunks in shared memory. Lane 0 starts the
//    global -> shared bulk copy (cp.async.bulk with an mbarrier that counts
//    the bytes) of each item kStages - 1 items ahead, waits for the oldest,
//    and sends it out with a shared -> global bulk copy; a stage is reloaded
//    once the store that read it has (cp.async.bulk.wait_group.read). Every
//    window starts on a 512-byte row, so every bulk copy is aligned. The
//    occupancy API picks as many blocks per SM as their stages fit.
//  - Ownership (the dynamic form): the later step's rows must stand where
//    write windows meet. The pass of probe_owner.cuh, shared with P5, leaves
//    each row of the output with the last step that writes it; the warp
//    reads its chunk's 32 owners with one coalesced load and a ballot. A
//    chunk its step owns whole leaves in one bulk store, any other row by
//    row (512-byte bulk stores), so no row of the output is written twice.
//    A last pass writes zeros to the rows no step owns; so the output is
//    never zero-filled first (with the TPU's offsets, a permutation of the
//    windows, every row is owned). The static form (D2) never overlaps: it
//    needs no ownership, and its wrapper zeroes rows past T*R.
//
// Offsets must lie in [0, rows - R]. A step whose read or write window does
// not lie inside is skipped as a whole: it reads nothing, writes nothing and
// takes no row from an earlier step.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_owner.cuh"

namespace {

constexpr int kStages = 4;
constexpr int kChunkRows = 32;  // rows of one stage: a lane each
constexpr int kRowBytes = 512;  // 128 u32
constexpr int kWarp = 32;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive on `bar` expecting `bytes`, then copy them global -> shared; the
// copy's completion counts them off.
__device__ __forceinline__ void load_async(uint64_t* bar, void* dst,
                                           const void* src, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A skipped item: complete the stage's phase with no bytes.
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void store_async(void* dst, const void* src,
                                            unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

struct Item {
  long long src, dst;  // first rows of the step's read and write windows
  int step, row0, rows;  // the chunk: rows [row0, row0 + rows) of the window
  bool live;             // false: the step is skipped
};

template <bool kDynamic>
__device__ __forceinline__ Item item_of(long long g, int chunks, int chunk_rows,
                                        const int* __restrict__ offs,
                                        int steps, int r, long long rows) {
  Item it;
  it.step = static_cast<int>(g / chunks);
  it.row0 = static_cast<int>(g % chunks) * chunk_rows;
  it.rows = min(chunk_rows, r - it.row0);
  if (kDynamic) {
    it.src = offs[it.step];
    it.dst = offs[steps - 1 - it.step];
    it.live = kmh_probe::inside(it.src, r, rows) &&
              kmh_probe::inside(it.dst, r, rows);
  } else {
    it.src = static_cast<long long>(it.step) * r;
    it.dst = static_cast<long long>(steps - 1 - it.step) * r;
    it.live = true;  // the launcher checked steps * r <= rows
  }
  return it;
}

template <bool kDynamic>
__global__ void __launch_bounds__(kWarp)
pipelined_copy_kernel(const unsigned char* __restrict__ x, long long rows,
                      const int* __restrict__ offs, int steps, int r,
                      int chunk_rows, const int* __restrict__ owner,
                      unsigned char* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char stages[];
  __shared__ __align__(8) uint64_t full[kStages];
  const int lane = threadIdx.x;
  const int chunks = (r + chunk_rows - 1) / chunk_rows;
  const long long items = static_cast<long long>(steps) * chunks;
  const long long stride = gridDim.x;
  const long long mine =
      blockIdx.x < items ? (items - 1 - blockIdx.x) / stride + 1 : 0;
  const int stage_bytes = chunk_rows * kRowBytes;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  auto issue = [&](long long j) {  // lane 0: start item j's load
    const Item it = item_of<kDynamic>(blockIdx.x + j * stride, chunks,
                                      chunk_rows, offs, steps, r, rows);
    const int s = static_cast<int>(j % kStages);
    if (it.live) {
      load_async(&full[s], stages + s * stage_bytes,
                 x + (it.src + it.row0) * kRowBytes,
                 static_cast<unsigned>(it.rows) * kRowBytes);
    } else {
      arrive(&full[s]);
    }
  };

  if (lane == 0) {
    for (long long j = 0; j < kStages && j < mine; ++j) issue(j);
  }
  for (long long i = 0; i < mine; ++i) {
    const Item it = item_of<kDynamic>(blockIdx.x + i * stride, chunks,
                                      chunk_rows, offs, steps, r, rows);
    const unsigned all =
        it.rows == kWarp ? 0xffffffffu : (1u << it.rows) - 1u;
    unsigned mask = it.live ? all : 0u;
    if (kDynamic && it.live) {
      const bool own =
          lane < it.rows && owner[it.dst + it.row0 + lane] == it.step;
      mask = __ballot_sync(0xffffffffu, own);
    }
    if (lane == 0) {
      const int s = static_cast<int>(i % kStages);
      wait_phase(&full[s], static_cast<unsigned>((i / kStages) & 1));
      unsigned char* dst = out + (it.dst + it.row0) * kRowBytes;
      const unsigned char* src = stages + s * stage_bytes;
      if (mask == all && mask) {
        store_async(dst, src, static_cast<unsigned>(it.rows) * kRowBytes);
      } else {
        for (unsigned m = mask; m; m &= m - 1) {
          const int b = __ffs(m) - 1;
          store_async(dst + b * kRowBytes, src + b * kRowBytes, kRowBytes);
        }
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // reload the stage item i - 1 used once its store has read it
      const long long j = i - 1 + kStages;
      if (i >= 1 && j < mine) {
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        issue(j);
      }
    }
    __syncwarp();
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Zeros to every row of the output that no step owns: a warp reads 32
// rows' owners with one load, then writes each unowned row with 16 bytes a
// lane (a row is 512 bytes).
__global__ void __launch_bounds__(256)
zero_unowned_kernel(long long rows, const int* __restrict__ owner,
                    uint4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = blockIdx.x * 256LL + threadIdx.x;
  const long long first = row - lane;  // the warp's first row
  unsigned m = __ballot_sync(0xffffffffu, row < rows && owner[row] < 0);
  for (; m; m &= m - 1) {
    const long long r = first + __ffs(m) - 1;
    out[r * (kRowBytes / 16) + lane] = make_uint4(0, 0, 0, 0);
  }
}

template <bool kDynamic>
cudaError_t launch_copy(const void* x, long long rows, const int* offs,
                        int steps, int r, const int* owner, void* out,
                        cudaStream_t stream) {
  const int chunk_rows = r < kChunkRows ? r : kChunkRows;
  const int smem = kStages * chunk_rows * kRowBytes;
  auto kernel = pipelined_copy_kernel<kDynamic>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarp,
                                                      smem);
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>(steps) * ((r + chunk_rows - 1) / chunk_rows);
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > items) blocks = items;
  kernel<<<static_cast<unsigned int>(blocks), kWarp, smem, stream>>>(
      static_cast<const unsigned char*>(x), rows, offs, steps, r, chunk_rows,
      owner, static_cast<unsigned char*>(out));
  return cudaGetLastError();
}

}  // namespace

// Launches P9 on `stream` of `device`: x and out ([rows, 128] 32-bit
// elements, 16-byte aligned), r rows per copy, `steps` steps. dynamic != 0:
// offs holds `steps` int32 row offsets and owner `rows` int32 filled with -1
// by the caller; the kernel writes every row of out. dynamic == 0 (D2): offs
// and owner are not read, steps * r must not exceed rows, and the rows from
// steps * r on are the caller's to zero. Returns the CUDA error of the
// launches, 0 on success.
extern "C" int kmh_probe_pipelined_copy(const void* x, long long rows,
                                        const void* offs, int steps, int r,
                                        int dynamic, void* owner, void* out,
                                        int device, void* stream) {
  if (rows < 0 || steps < 0 || r < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (dynamic && !kmh_probe::owner_grid_fits(steps, r)) ||
      (!dynamic && static_cast<long long>(steps) * r > rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dynamic) {
    if (steps == 0) return 0;
    return static_cast<int>(launch_copy<false>(x, rows, nullptr, steps, r,
                                               nullptr, out, s));
  }
  const int* o = static_cast<const int*>(offs);
  int* own = static_cast<int*>(owner);
  if (steps > 0) {
    err = kmh_probe::launch_owner(rows, o, steps, r, own, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_copy<true>(x, rows, o, steps, r, own, out, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (rows == 0) return 0;
  zero_unowned_kernel<<<static_cast<unsigned int>((rows + 255) / 256), 256, 0,
                        s>>>(rows, own, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
