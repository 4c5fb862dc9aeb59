// Tick-batched softmax-free spiking self-attention: out = (q k^T) v * scale.
//
// Replaces: src/repro/kernels/spiking_attention/kernel.py::ssa_fwd
//           (body ssa_kernel).
//
// q: (G, N, D), k and v: (G, M, D), out: (G, N, D), G = T*B*H folds time,
// batch and heads, so all T time steps ride one launch.  There is no softmax
// (binary q, k, v give a non-negative score matrix); with causal != 0 the
// scores of keys after the query are zeroed.
//
// Bound on this card: operations.  At the main path's shape (G = 384,
// N = M = 196, D = 32) the two products do 4*N*M*D flops per fold against
// 16*N*D bytes moved, about 49 flops per byte, above the float32 balance.
//
// Design: one block per (fold g, tile of 32 queries).  The block stages its
// query tile in shared memory once, then walks the keys in tiles of 64:
// each tile of k and v is staged in shared memory, the 32 x 64 score tile is
// computed into shared memory, and each thread adds its share of
// score @ v_tile into f32 registers, written once at the end.  Tiling the
// keys (instead of holding K and V of the fold whole, as the TPU kernel holds
// them in VMEM) keeps shared memory fixed in N.  The k tile's rows are padded
// by one float so the score loop, whose threads walk different keys at the
// same feature, reads distinct banks.  Ragged N and M are masked: rows past
// the operands load as zero (adding exactly 0) and are never stored.
// For binary q, k, v the scores are integers <= D and the sums integers
// <= M*D, exact in f32, so the result is bit-exact whatever the summation
// order.

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32, kBKV = 64, kThreads = 256, kMaxD = 128;
constexpr int kOutPerThread = kBQ * kMaxD / kThreads;  // 16

__host__ __device__ inline int smem_floats(int d) {
  return kBQ * d + kBKV * (d + 1) + kBKV * d + kBQ * kBKV;
}

__global__ void __launch_bounds__(kThreads)
ssa_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, int n, int m, int d,
           float scale, int causal) {
  extern __shared__ float smem[];
  const int ldk = d + 1;
  float* qs = smem;               // [kBQ][d]
  float* ks = qs + kBQ * d;       // [kBKV][d + 1]
  float* vs = ks + kBKV * ldk;    // [kBKV][d]
  float* ss = vs + kBKV * d;      // [kBQ][kBKV]

  const int tid = threadIdx.x;
  const long long g = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const float* qg = q + g * n * d;
  const float* kg = k + g * m * d;
  const float* vg = v + g * m * d;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d;
    qs[e] = (q0 + r < n) ? qg[static_cast<long long>(q0 + r) * d + e % d] : 0.0f;
  }

  float acc[kOutPerThread];
#pragma unroll
  for (int l = 0; l < kOutPerThread; ++l) acc[l] = 0.0f;

  const int kv_end = causal ? min(m, q0 + kBQ) : m;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBKV * d; e += kThreads) {
      const int r = e / d, f = e % d;
      const bool in = kv0 + r < m;
      const long long src = static_cast<long long>(kv0 + r) * d + f;
      ks[r * ldk + f] = in ? kg[src] : 0.0f;
      vs[e] = in ? vg[src] : 0.0f;
    }
    __syncthreads();

    for (int e = tid; e < kBQ * kBKV; e += kThreads) {
      const int i = e / kBKV, j = e % kBKV;
      float s = 0.0f;
      for (int f = 0; f < d; ++f) s = fmaf(qs[i * d + f], ks[j * ldk + f], s);
      if (causal && kv0 + j > q0 + i) s = 0.0f;
      ss[e] = s;
    }
    __syncthreads();

#pragma unroll
    for (int l = 0; l < kOutPerThread; ++l) {
      const int e = tid + l * kThreads;
      if (e < kBQ * d) {
        const int i = e / d, f = e % d;
        float a = acc[l];
        for (int j = 0; j < kBKV; ++j) a = fmaf(ss[i * kBKV + j], vs[j * d + f], a);
        acc[l] = a;
      }
    }
  }

  float* og = out + g * n * d;
#pragma unroll
  for (int l = 0; l < kOutPerThread; ++l) {
    const int e = tid + l * kThreads;
    if (e < kBQ * d && q0 + e / d < n) {
      og[static_cast<long long>(q0 + e / d) * d + e % d] = acc[l] * scale;
    }
  }
}

}  // namespace

extern "C" int ssa_fwd(const void* q, const void* k, const void* v, void* out, int g,
                       int n, int m, int d, float scale, int causal, void* stream) {
  if (d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(g), static_cast<unsigned>((n + kBQ - 1) / kBQ));
  ssa_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, m, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
