// B2 on Hopper: the quality-likelihood FSM, one read per thread.
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
// What bounds it: device memory, nominally — 2 bytes read and 17 written
// per (read, position). This first version does not reach that bound:
// a thread's consecutive positions lie L bytes apart from its neighbour's,
// so loads and stores are not coalesced, and one thread per read leaves
// the card with few warps in flight at the batch sizes the counting path
// uses. A transposed layout and fusing the canonical minimum are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

template <typename F, bool kFlags>
__global__ void __launch_bounds__(kBlock)
ll_scan_kernel(const uint8_t* __restrict__ seq,
               const uint8_t* __restrict__ qual,
               const int* __restrict__ lengths, int n_reads, int row_len,
               int k, const F* __restrict__ table, F min_ll, float rel,
               float merr, bool* __restrict__ emit_out,
               long long* __restrict__ fwd_out, long long* __restrict__ rc_out,
               bool* __restrict__ flag_out) {
  __shared__ F tab[256];
  for (int t = threadIdx.x; t < 256; t += kBlock) tab[t] = table[t];
  __syncthreads();

  const int read = blockIdx.x * kBlock + threadIdx.x;
  if (read >= n_reads) return;
  const long long base = static_cast<long long>(read) * row_len;
  const int len = lengths[read];
  const int n_on = len > k ? (len < row_len ? len : row_len) : 0;

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

  F llv = n_on > 0 ? tab[qual[base]] : zero;
  for (int p = 0; p < n_on; ++p) {
    const unsigned long long c = (seq[base + p] >> 1) & 3u;
    const F llnext = p + 1 < len && p + 1 < row_len ? tab[qual[base + p + 1]]
                                                    : zero;

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
    const bool emit = completed || roll_ok;
    if (roll_fail) {
      j_new = 0;
      acc_new = zero;
    }
    const F ecand = (acc_new - llv) + llnext;
    if (kFlags) {
      const float fl = static_cast<float>(llv);
      const float aerr_base = ok1 ? aerr : 0.0f;
      const float fsum = static_cast<float>(acc_base + llv);
      float aerr_new =
          b_ok ? (aerr_base + te) + eps * fabsf(fsum) : (building ? 0.0f : aerr);
      if (roll_fail) aerr_new = 0.0f;
      const float tn = rel * fabsf(static_cast<float>(llnext)) + abs0;
      const float mag = (fabsf(static_cast<float>(acc_new)) + fabsf(fl)) +
                        fabsf(static_cast<float>(ecand));
      const float ecand_err = ((aerr_new + te) + tn) + eps * mag;
      eerr = completed ? ecand_err : (roll_fail ? 0.0f : eerr);
      aerr = aerr_new;
    }
    emitC = completed ? ecand : (roll_fail ? zero : emitC);
    rolling = (rolling && !roll_fail) || completed;
    j = j_new;
    acc = acc_new;

    emit_out[base + p] = emit;
    fwd_out[base + p] = static_cast<long long>(fwd);
    rc_out[base + p] = static_cast<long long>(rc);
    llv = llnext;
  }
  for (int p = n_on; p < row_len; ++p) {
    emit_out[base + p] = false;
    fwd_out[base + p] = static_cast<long long>(fwd);
    rc_out[base + p] = static_cast<long long>(rc);
  }
  if (kFlags) flag_out[read] = border;
}

template <typename F, bool kFlags>
cudaError_t launch(const void* seq, const void* qual, const void* lengths,
                   int n_reads, int row_len, int k, const void* table,
                   double min_ll, float rel, float merr, void* emit, void* fwd,
                   void* rc, void* flag, cudaStream_t stream) {
  const int blocks = (n_reads + kBlock - 1) / kBlock;
  ll_scan_kernel<F, kFlags><<<blocks, kBlock, 0, stream>>>(
      static_cast<const uint8_t*>(seq), static_cast<const uint8_t*>(qual),
      static_cast<const int*>(lengths), n_reads, row_len, k,
      static_cast<const F*>(table), static_cast<F>(min_ll), rel, merr,
      static_cast<bool*>(emit), static_cast<long long*>(fwd),
      static_cast<long long*>(rc), static_cast<bool*>(flag));
  return cudaGetLastError();
}

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
