// B2 on Hopper: the quality-likelihood FSM; a warp owns 32 reads.
//
// Replaces kmer_hasher_tpu/ops/pallas_scan.py::_kernel with _fsm_step
// (entry ll_scan_pallas). For every read of a padded [B, L] batch it walks
// the bases in order and gives, per position p, for the window ending at p:
//
//   emit[p]  whether the iterator yields that window
//   fwd[p]   the forward register, raw 2k-bit pattern in an int64
//   rc[p]    the bottom-aligned reverse-complement register, likewise
//
// and, in the flags instantiation, one byte per read: whether any
// comparison fell within its tracked f32 error bound of the threshold.
// Positions past the read's end, and reads of length <= k, leave the state
// untouched and emit nothing. N is not checked on this path. The result is
// bitwise what the plain PyTorch version (ops/scan_iter.py::ll_scan) gives:
// every product and sum below is one rounded operation in the same order,
// and the build passes --fmad=false so nvcc contracts none of them.
//
// What differs from the TPU kernel, which blocked 1024 reads x 16 positions
// into [8, 128] register sets and carried the state through VMEM scratch
// between position blocks: here a thread owns a read, the 9-11 state values
// stay in registers for the whole read, and the loop over positions is the
// sequential grid axis. The per-quality log-likelihood comes from a
// 256-entry table in shared memory (the TPU evaluated it arithmetically
// because its gathers are slow). f64 runs natively, so one source gives
// three instantiations: f32, f32 with the error lanes and the flag, f64.
//
// What bounds it: device memory in principle — 2 bytes read and 17 written
// per (read, position), 85.3 MB at the counting path's [29,696 x 151] —
// and in practice that and the FSM's chain of dependent operations (two
// shared-memory loads and about 30 rounded or logical operations a
// position), which with 7 warps an SM the stores overlap only in part
// (PERF.md has the split). A thread that loaded and stored its own row in
// device memory would touch 32 rows L bytes apart with every warp
// instruction, so the warp's traffic is made contiguous:
//
// - A warp owns 32 consecutive reads and one-warp blocks spread the warps
//   evenly (928 warps on 132 SMs fit in one wave at the counting shape).
// - Each lane stages its read's bases and qualities into shared memory with
//   16-byte cp.async copies of the aligned granules that cover the row
//   (bytes of a neighbouring row in a granule are copied and never read; a
//   granule that reaches outside the input is copied byte by byte). Rows
//   sit 16-byte aligned at a stride whose count of 16-byte units is odd,
//   so the lanes' byte reads spread over the banks. Rows longer than
//   kMaxWindow positions are staged one window at a time (each window with
//   one position of look-ahead for the next quality; windows are a
//   multiple of 16 positions long, so a row's shift within its first
//   granule holds for every window).
// - The outputs go through shared memory in chunks of kChunk positions:
//   each lane writes its row's emit byte and two registers into [32 x
//   kChunk] tiles (padded against bank conflicts); then the warp writes
//   each row's segment with consecutive lanes on consecutive addresses, two
//   rows an instruction (128 contiguous bytes a row for fwd and rc). A row
//   of 151 int64 starts anywhere in a 32-byte sector, so each register
//   segment goes out from a sector boundary and the positions after the
//   chunk's last whole sector are carried into the next chunk: a sector
//   written in two parts made the card fetch and write it twice (the same
//   stores without the carry ran 1.7x longer).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 16;        // positions put out at once
constexpr int kMaxWindow = 512;   // positions staged at once, kChunk x 32
constexpr int kEmitStride = kChunk + 4;  // bytes: 5 words a row, an odd count
constexpr int kCarry = 4;         // int64 of a 32-byte sector
// a row of the fwd / rc tiles: the previous chunk's last kCarry positions,
// then this chunk's; an odd count of int64, against bank conflicts
constexpr int kRegStride = kCarry + kChunk + 1;
constexpr int kTableBytes = 256 * 8;
constexpr int kTileOff = kTableBytes;
constexpr int kEmitOff = kTileOff + 2 * kWarp * kRegStride * 8;
constexpr int kStageOff = kEmitOff + kWarp * kEmitStride;  // 16-byte aligned
static_assert(kStageOff % 16 == 0, "staged rows must start 16-byte aligned");
static_assert(kMaxWindow % 16 == 0 && kMaxWindow % kChunk == 0 &&
                  kChunk % kCarry == 0,
              "windows keep a row's granule shift and hold whole chunks, "
              "chunks keep a row's sector phase");

// Bytes a staged row takes: W + 1 positions after a shift of up to 15
// bytes, rounded out to 16-byte granules, an odd number of granules.
__host__ __device__ constexpr int stage_stride(int w) {
  const int s = (w + 1 + 15 + 15) / 16 * 16;
  return (s / 16) % 2 ? s : s + 16;
}

__host__ __device__ constexpr int smem_bytes(int w) {
  return kStageOff + 2 * kWarp * stage_stride(w);
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Copies bytes [src, src + n) of one row to dst + (src & 15), by the
// 16-byte granules that cover them; [lo, hi) bounds the input array, and a
// granule not wholly inside it goes byte by byte (only its inside bytes).
__device__ __forceinline__ void stage_row(uint8_t* dst, const uint8_t* src,
                                          int n, const uint8_t* lo,
                                          const uint8_t* hi) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t g0 = a & ~static_cast<uintptr_t>(15);
  const uintptr_t g1 = (a + n + 15) & ~static_cast<uintptr_t>(15);
  for (uintptr_t g = g0; g < g1; g += 16) {
    uint8_t* d = dst + (g - g0);
    const uint8_t* s = reinterpret_cast<const uint8_t*>(g);
    if (s >= lo && s + 16 <= hi) {
      cp_async_16(d, s);
    } else {
      for (int b = 0; b < 16; ++b) {
        if (s + b >= lo && s + b < hi) d[b] = s[b];
      }
    }
  }
}

template <typename F, bool kFlags>
__global__ void __launch_bounds__(kWarp)
ll_scan_kernel(const uint8_t* __restrict__ seq,
               const uint8_t* __restrict__ qual,
               const int* __restrict__ lengths, int n_reads, int row_len,
               int window, int k, const F* __restrict__ table, F min_ll,
               float rel, float merr, bool* __restrict__ emit_out,
               long long* __restrict__ fwd_out, long long* __restrict__ rc_out,
               bool* __restrict__ flag_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  F* tab = reinterpret_cast<F*>(smem);
  long long* tile_fwd = reinterpret_cast<long long*>(smem + kTileOff);
  long long* tile_rc = tile_fwd + kWarp * kRegStride;
  uint8_t* tile_emit = smem + kEmitOff;
  const int stride = stage_stride(window);
  uint8_t* s_seq = smem + kStageOff;
  uint8_t* s_qual = s_seq + kWarp * stride;

  const int lane = threadIdx.x;
  for (int t = lane; t < 256; t += kWarp) tab[t] = table[t];

  const int r0 = blockIdx.x * kWarp;
  const int rows = min(kWarp, n_reads - r0);
  const int read = r0 + lane;
  const bool live = lane < rows;
  const long long base = static_cast<long long>(read) * row_len;
  const int len = live ? lengths[read] : 0;
  const int n_on = len > k ? (len < row_len ? len : row_len) : 0;
  const long long total = static_cast<long long>(n_reads) * row_len;
  const int shift =
      static_cast<int>(reinterpret_cast<uintptr_t>(seq + base) & 15);
  const int qshift =
      static_cast<int>(reinterpret_cast<uintptr_t>(qual + base) & 15);
  const uint8_t* my_seq = s_seq + lane * stride + shift;
  const uint8_t* my_qual = s_qual + lane * stride + qshift;

  const unsigned long long mask =
      k == 32 ? ~0ull : ((1ull << (2 * k)) - 1ull);
  const int top = 2 * k - 2;
  const float eps = 5.9604644775390625e-08f;   // 2^-24
  const float abs0 = 1.8189894035458565e-12f;  // 2^-39
  const F zero = static_cast<F>(0);

  bool rolling = false, border = false;
  int j = 0;
  unsigned long long fwd = 0, rc = 0;
  F acc = zero, emitC = zero;
  float aerr = 0.0f, eerr = 0.0f;
  F llv = zero;

  for (int w0 = 0; w0 < row_len; w0 += window) {
    const int wend = min(w0 + window, row_len);
    // stage positions [w0, min(wend + 1, row_len)) of this lane's row
    __syncwarp();  // every lane is done with the previous window
    if (live) {
      const int n = min(wend + 1, row_len) - w0;
      stage_row(s_seq + lane * stride, seq + base + w0, n, seq, seq + total);
      stage_row(s_qual + lane * stride, qual + base + w0, n, qual,
                qual + total);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    if (w0 == 0 && n_on > 0) llv = tab[my_qual[0]];

    for (int c0 = w0; c0 < wend; c0 += kChunk) {
      const int n = min(kChunk, wend - c0);
      for (int m = 0; m < kCarry; ++m) {  // this lane's own row
        tile_fwd[lane * kRegStride + m] =
            tile_fwd[lane * kRegStride + kChunk + m];
        tile_rc[lane * kRegStride + m] =
            tile_rc[lane * kRegStride + kChunk + m];
      }
      for (int i = 0; i < n; ++i) {
        const int p = c0 + i;
        bool emit = false;
        if (p < n_on) {
          const int q = p - w0;
          const unsigned long long c = (my_seq[q] >> 1) & 3u;
          const F llnext = p + 1 < len && p + 1 < row_len
                               ? tab[my_qual[q + 1]] : zero;

          const F v = emitC + llv;
          const bool v_low = v < min_ll;
          const bool roll_ok = rolling && !v_low;
          const bool roll_fail = rolling && v_low;
          const bool building = !rolling;
          const F bv = acc + llv;
          const bool ok1 = building && bv > min_ll;
          const bool ok2 = building && !ok1 && llv > min_ll;
          const bool b_ok = ok1 || ok2;

          float te = 0.0f;
          if (kFlags) {
            // kFlags is only instantiated with F = float
            const float fl = static_cast<float>(llv);
            const float fv = static_cast<float>(v);
            const float fbv = static_cast<float>(bv);
            const float fm = static_cast<float>(min_ll);
            te = rel * fabsf(fl) + abs0;
            const float verr = (eerr + te) + eps * fabsf(fv);
            const float bverr = (aerr + te) + eps * fabsf(fbv);
            const bool eq_t = fl == fm;
            const bool near_v = fabsf(fv - fm) <= verr + merr;
            const bool near_bv = fabsf(fbv - fm) <= bverr + merr;
            const bool near_ll = fabsf(fl - fm) <= te + merr;
            border = border ||
                     (rolling && near_v) ||
                     (building && ((near_bv && !(acc == zero && eq_t)) ||
                                   (!ok1 && near_ll && !eq_t)));
          }

          const int j_base = ok1 ? j : 0;
          const F acc_base = ok1 ? acc : zero;
          if (roll_ok || b_ok) {
            const bool keep = ok1 || roll_ok;
            const unsigned long long sf = keep ? fwd : 0ull;
            const unsigned long long sr = keep ? rc : 0ull;
            fwd = ((sf << 2) | c) & mask;
            rc = ((sr >> 2) | ((c ^ 2ull) << top)) & mask;
          }

          int j_new = b_ok ? j_base + 1 : (building ? 0 : j);
          F acc_new = b_ok ? acc_base + llv : (building ? zero : acc);
          const bool completed = building && b_ok && j_new == k;
          emit = completed || roll_ok;
          if (roll_fail) {
            j_new = 0;
            acc_new = zero;
          }
          const F ecand = (acc_new - llv) + llnext;
          if (kFlags) {
            const float fl = static_cast<float>(llv);
            const float aerr_base = ok1 ? aerr : 0.0f;
            const float fsum = static_cast<float>(acc_base + llv);
            float aerr_new = b_ok ? (aerr_base + te) + eps * fabsf(fsum)
                                  : (building ? 0.0f : aerr);
            if (roll_fail) aerr_new = 0.0f;
            const float tn = rel * fabsf(static_cast<float>(llnext)) + abs0;
            const float mag = (fabsf(static_cast<float>(acc_new)) +
                               fabsf(fl)) +
                              fabsf(static_cast<float>(ecand));
            const float ecand_err = ((aerr_new + te) + tn) + eps * mag;
            eerr = completed ? ecand_err : (roll_fail ? 0.0f : eerr);
            aerr = aerr_new;
          }
          emitC = completed ? ecand : (roll_fail ? zero : emitC);
          rolling = (rolling && !roll_fail) || completed;
          j = j_new;
          acc = acc_new;
          llv = llnext;
        }
        tile_emit[lane * kEmitStride + i] = emit;
        tile_fwd[lane * kRegStride + kCarry + i] = static_cast<long long>(fwd);
        tile_rc[lane * kRegStride + kCarry + i] = static_cast<long long>(rc);
      }
      __syncwarp();
      // two rows an instruction: lanes 0-15 row 2r, lanes 16-31 row 2r + 1.
      // A row's registers go out from a 32-byte sector boundary to the last
      // one this chunk completes; the rest waits for the next chunk, so no
      // sector is written in parts, bar the two at the row's ends.
      const int pos = lane & (kChunk - 1);
      const bool last = c0 + n == row_len;
      for (int r = lane / kChunk; r < rows; r += kWarp / kChunk) {
        const long long g = static_cast<long long>(r0 + r) * row_len;
        if (pos < n) emit_out[g + c0 + pos] = tile_emit[r * kEmitStride + pos];
        const int ps =
            c0 == 0 ? 0 : c0 - static_cast<int>((g + c0) & (kCarry - 1));
        const int pe = last ? row_len
                            : c0 + n - static_cast<int>((g + c0 + n) &
                                                        (kCarry - 1));
        for (int p = ps + pos; p < pe; p += kChunk) {  // at most 19 positions
          const int t = r * kRegStride + kCarry + (p - c0);
          fwd_out[g + p] = tile_fwd[t];
          rc_out[g + p] = tile_rc[t];
        }
      }
      __syncwarp();  // the tiles are free for the next chunk
    }
  }
  if (kFlags && live) flag_out[read] = border;
}

template <typename F, bool kFlags>
cudaError_t launch(const void* seq, const void* qual, const void* lengths,
                   int n_reads, int row_len, int k, const void* table,
                   double min_ll, float rel, float merr, void* emit, void* fwd,
                   void* rc, void* flag, cudaStream_t stream) {
  const int window = row_len < kMaxWindow ? row_len : kMaxWindow;
  const int blocks = (n_reads + kWarp - 1) / kWarp;
  ll_scan_kernel<F, kFlags><<<blocks, kWarp, smem_bytes(window), stream>>>(
      static_cast<const uint8_t*>(seq), static_cast<const uint8_t*>(qual),
      static_cast<const int*>(lengths), n_reads, row_len, window, k,
      static_cast<const F*>(table), static_cast<F>(min_ll), rel, merr,
      static_cast<bool*>(emit), static_cast<long long*>(fwd),
      static_cast<long long*>(rc), static_cast<bool*>(flag));
  return cudaGetLastError();
}

static_assert(smem_bytes(kMaxWindow) <= 48 * 1024,
              "B2 stays within the static shared-memory limit");

}  // namespace

// Launches B2 on `stream` of `device`. Device pointers: seq, qual
// (n_reads * row_len bytes each), lengths (n_reads int32), table (256
// values: float for variants 0 and 1, double for 2), emit (bool), fwd, rc
// (int64, n_reads * row_len each), flag (n_reads bool; variant 1 only).
// variant: 0 = f32, 1 = f32 with error lanes and flag, 2 = f64. min_ll is
// the threshold in the variant's float type, widened to double. Returns the
// CUDA error of the launch, 0 on success.
extern "C" int kmh_ll_scan(const void* seq, const void* qual,
                           const void* lengths, int n_reads, int row_len,
                           int k, const void* table, int variant,
                           double min_ll, float rel, float merr, void* emit,
                           void* fwd, void* rc, void* flag, int device,
                           void* stream) {
  if (n_reads <= 0 || row_len <= 0 || k < 1 || k > 32 || variant < 0 ||
      variant > 2 || (variant == 1 && flag == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    err = launch<float, false>(seq, qual, lengths, n_reads, row_len, k, table,
                               min_ll, rel, merr, emit, fwd, rc, flag, s);
  } else if (variant == 1) {
    err = launch<float, true>(seq, qual, lengths, n_reads, row_len, k, table,
                              min_ll, rel, merr, emit, fwd, rc, flag, s);
  } else {
    err = launch<double, false>(seq, qual, lengths, n_reads, row_len, k, table,
                                min_ll, rel, merr, emit, fwd, rc, flag, s);
  }
  return static_cast<int>(err);
}
