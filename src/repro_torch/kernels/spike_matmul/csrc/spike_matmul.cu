// Tick-batched spike x weight GEMM: (M, K) {0,1} spikes x (K, C) f32 -> (M, C) f32.
//
// Replaces: src/repro/kernels/spike_matmul/kernel.py::spike_matmul_fwd
//           (body matmul_kernel).
//
// One GEMM serves every weight layer of the deploy plan, as the paper's one
// reconfigurable PE dataflow does: linears directly, 3x3 convs through an
// im2col gather done by the wrapper.  The T time steps are folded into M, so
// each weight tile is read once for all time steps.
//
// Bound on this card: operations.  At the main path's shapes
// (K = 384..1728) the product does 2*K flops per 4-byte output and reads
// each weight once per M-tile; that is above the float32 balance of the H100
// (67 TFLOP/s against 3.35 TB/s).  The product stays in full float32, as the
// TPU kernel's f32 accumulation does: no TF32, so no tensor core.
//
// Design: a tiled SIMT GEMM.  A 256-thread block owns a 128 x 128 output
// tile and walks K in steps of 8: it stages an (8 x 128) slab of x
// (transposed) and of w in shared memory, and each thread accumulates an
// 8 x 8 register micro-tile with FMAs, reading its operands from shared
// memory as float4.  Ragged M, K and C are masked: loads
// outside the operands read zero, stores outside the output are skipped.
// Each output is one f32 sum over k in increasing order; the order differs
// from a library GEMM's, so results agree to f32 reassociation only.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kTM = 8, kTN = 8;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__global__ void __launch_bounds__(kThreads)
spike_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int m, int k, int c) {
  __shared__ __align__(16) float xs[kBK][kBM];  // x slab, transposed: xs[kk][row]
  __shared__ __align__(16) float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  const int tr = tid / (kBN / kTN);  // micro-tile row group, 0..15
  const int tc = tid % (kBN / kTN);  // micro-tile column group, 0..15

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < kBM * kBK / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int r = e / kBK, kk = e % kBK;
      const long long gr = row0 + r;
      const int gk = k0 + kk;
      xs[kk][r] = (gr < m && gk < k) ? x[gr * k + gk] : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < kBK * kBN / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int kk = e / kBN, cc = e % kBN;
      const int gk = k0 + kk, gc = col0 + cc;
      ws[kk][cc] = (gk < k && gc < c) ? w[static_cast<long long>(gk) * c + gc] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int v = 0; v < kTM / 4; ++v) {
        const float4 t = *reinterpret_cast<const float4*>(&xs[kk][tr * kTM + 4 * v]);
        a[4 * v] = t.x; a[4 * v + 1] = t.y; a[4 * v + 2] = t.z; a[4 * v + 3] = t.w;
      }
#pragma unroll
      for (int v = 0; v < kTN / 4; ++v) {
        const float4 t = *reinterpret_cast<const float4*>(&ws[kk][tc * kTN + 4 * v]);
        b[4 * v] = t.x; b[4 * v + 1] = t.y; b[4 * v + 2] = t.z; b[4 * v + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long gr = row0 + tr * kTM + i;
    if (gr >= m) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = col0 + tc * kTN + j;
      if (gc < c) out[gr * c + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int spike_matmul_fwd(const void* x, const void* w, void* out, int m, int k,
                                int c, void* stream) {
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((c + kBN - 1) / kBN));
  spike_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), m, k, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
