// Unrolled multi-time-step LIF with the optional fused IAND epilogue.
//
// Replaces: src/repro/kernels/lif_parallel/kernel.py::lif_parallel_fwd
//           (bodies lif_fwd_kernel and lif_iand_fwd_kernel).
//
// Computes, for a (T, N) f32 drive and every neuron column n:
//     u_t = lam * v_{t-1} + I_t,  s_t = (u_t >= theta),
//     v_t = u_t * (1 - s_t)  (hard reset)  or  u_t - theta * s_t  (soft),
// with the membrane restarting from zero every chain_len steps (the paper's
// reconfigurable 111/101/000 mux), and writes s_t, or skip_t * (1 - s_t) when
// the IAND residual is fused in.
//
// Bound on this card: bytes.  The work is a handful of flops per element
// against a 4-byte read of the drive (and the skip) and a 4-byte write, far
// below the H100's flop-per-byte balance.  The least traffic is: read the
// drive once, read the skip once, write the output once.
//
// Design: one thread per neuron column; the T-step chain runs in a register,
// so the membrane never reaches device memory (the analogue of the paper
// eliminating the membrane SRAM).  At step t, adjacent threads touch adjacent
// n, so every load and store of a warp is one coalesced 128-byte line.  The
// ragged tail is masked, not padded.
//
// Bit-exactness with the plain PyTorch version: built without
// --use_fast_math (no flush-to-zero), the spike compares u >= theta (under
// FTZ, u - theta >= 0 would read a negative denormal difference as -0), and
// lam * v + I is written with __fmul_rn/__fadd_rn so that no FMA contraction
// rounds differently from the two separate eager operations.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kIand, bool kSoft>
__global__ void __launch_bounds__(kThreads)
lif_parallel_kernel(const float* __restrict__ drive, const float* __restrict__ skip,
                    float* __restrict__ out, int t_total, int n, int chain_len,
                    float lam, float theta) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float v = 0.0f;
  for (int t = 0; t < t_total; ++t) {
    if (t % chain_len == 0) v = 0.0f;  // mux: chain boundary -> fresh membrane
    const long long idx = static_cast<long long>(t) * n + i;
    const float u = __fadd_rn(__fmul_rn(lam, v), drive[idx]);
    const float s = (u >= theta) ? 1.0f : 0.0f;
    v = kSoft ? __fsub_rn(u, __fmul_rn(theta, s)) : __fmul_rn(u, __fsub_rn(1.0f, s));
    out[idx] = kIand ? __fmul_rn(skip[idx], __fsub_rn(1.0f, s)) : s;
  }
}

template <bool kIand>
void launch(const float* drive, const float* skip, float* out, int t_total, int n,
            int chain_len, float lam, float theta, int soft, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (soft) {
    lif_parallel_kernel<kIand, true><<<blocks, kThreads, 0, stream>>>(
        drive, skip, out, t_total, n, chain_len, lam, theta);
  } else {
    lif_parallel_kernel<kIand, false><<<blocks, kThreads, 0, stream>>>(
        drive, skip, out, t_total, n, chain_len, lam, theta);
  }
}

}  // namespace

extern "C" int lif_parallel_fwd(const void* drive, const void* skip, void* out,
                                int t_total, int n, int chain_len, float lam,
                                float theta, int soft, void* stream) {
  const auto* d = static_cast<const float*>(drive);
  const auto* k = static_cast<const float*>(skip);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (k != nullptr) {
    launch<true>(d, k, o, t_total, n, chain_len, lam, theta, soft, s);
  } else {
    launch<false>(d, k, o, t_total, n, chain_len, lam, theta, soft, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
