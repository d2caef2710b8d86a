// P3 and P4 on Hopper: rotate a tile by a shift that only the device knows.
//
//   out[t, (i + e_t) mod N] = x[t, i],   e_t = (shifts[t] mod (N / unit)) * unit
//
// with the mathematical (non-negative) mod, so negative shifts and shifts
// above N behave as np.roll's. unit = the row width gives P3, np.roll of a
// [rows, cols] tile along axis 0 (e3_traced_roll in
// tools/chip_probes/sort_probes.py, kern at :112, pallas_call at :117);
// unit = 1 gives P4, np.roll of the flattened tile (e3b_traced_roll_flat,
// kern at :135, pallas_call at :143). The TPU probes asked whether
// pltpu.roll compiles with a shift that is not known when the kernel is
// built; on this card any kernel may read its shift from memory, so the
// question becomes what the rotation costs beside a plain copy.
//
// What bounds it: device memory, 8 bytes per element plus 4 per tile; for one
// tile of 32 KB the launch itself. The design: one block per tile reads its
// shift from device memory, stages the tile in shared memory with aligned
// 16-byte loads and writes the output with aligned 16-byte stores, taking
// each store's four elements from the rotated position in shared memory
// (one 16-byte read when the shift is a multiple of four elements, as every
// row shift is; four 4-byte reads with the wrap applied to each otherwise).
// The misalignment is paid in shared memory, never in device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxTile = 1 << 13;  // elements: 32 KB of shared memory

__global__ void __launch_bounds__(kBlock)
roll_kernel(const uint32_t* __restrict__ x, const int* __restrict__ shifts,
            int n_tile, int unit, uint32_t* __restrict__ out) {
  __shared__ uint4 tile4[kMaxTile / 4];
  const uint32_t* tile = reinterpret_cast<const uint32_t*>(tile4);
  const long long base = static_cast<long long>(blockIdx.x) * n_tile;
  const uint4* src4 = reinterpret_cast<const uint4*>(x + base);
  for (int j = threadIdx.x; j < n_tile / 4; j += kBlock) tile4[j] = src4[j];

  const int rows = n_tile / unit;
  int s = shifts[blockIdx.x] % rows;  // C's remainder: sign of the dividend
  if (s < 0) s += rows;
  const int e = s * unit;  // 0 <= e < n_tile
  __syncthreads();

  uint4* dst4 = reinterpret_cast<uint4*>(out + base);
  for (int j4 = threadIdx.x; j4 < n_tile / 4; j4 += kBlock) {
    int from = 4 * j4 - e;  // out[j] = x[(j - e) mod N]
    if (from < 0) from += n_tile;
    uint4 v;
    if ((e & 3) == 0) {
      v = tile4[from >> 2];
    } else {
      uint32_t w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int at = from + u;
        if (at >= n_tile) at -= n_tile;
        w[u] = tile[at];
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    dst4[j4] = v;
  }
}

}  // namespace

// Launches the rotation on `stream` of `device`: x and out hold `tiles`
// tiles of n_tile 32-bit elements (16-byte aligned, n_tile a multiple of 4
// and of `unit`, at most 2^13), shifts holds one int32 per tile. Returns the
// CUDA error of the launch, 0 on success.
extern "C" int kmh_probe_roll(const void* x, const void* shifts, int tiles,
                              int n_tile, int unit, void* out, int device,
                              void* stream) {
  if (tiles < 0 || n_tile < 4 || n_tile > kMaxTile || n_tile % 4 != 0 ||
      unit < 1 || n_tile % unit != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  roll_kernel<<<static_cast<unsigned int>(tiles), kBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int*>(shifts), n_tile,
      unit, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
