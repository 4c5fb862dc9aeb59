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
//
// Packed variant, packed_ssa_fwd: q words (W, G, N, D), k and v words
// (W, G, M, D), G = B*H, bit t % 32 of word t / 32 the spike at time step t
// -> (T, G, N, D) f32.
//
// Replaces: src/repro/kernels/spiking_attention/kernel.py::packed_ssa_fwd
//           (body packed_ssa_kernel).
//
// Bound on this card: operations, as the dense kernel (4*T*N*M*D); the
// operands are read at 1/T of the dense kernel's bytes (T <= 32).
//
// Design: the dense kernel's structure with a bitplane axis.  One block per
// (fold g, tile of 32 queries, group of P consecutive time steps; P = 1, 2 or
// 4 divides 32, so a group never straddles two words).  The q word tile is
// staged once; the keys are walked in tiles of 32, each k and v word tile
// staged in shared memory once and serving all P planes of the group.  A
// score is a count: one AND of the q and k words per feature serves every
// plane, and plane p adds bit p of it, so the P score tiles (integers <= D)
// are exact.  Each thread adds its share of score @ v for all P planes into
// P*16 f32 registers, with the v bit shifted out of the staged word.  The
// causal mask is col <= row over global rows, as in the dense kernel.  T > 4
// re-reads the word tiles once per group of P planes.  All sums are integers
// below 2^24, so the result is bit-exact whatever the order.
//
// Plane-gated variant, sparse_packed_ssa_fwd: the packed kernel with a
// (G, T) int32 liveness map beside the words, live[g][t] != 0 iff the q, k
// and v planes t of fold g each carry a spike.
//
// Replaces: src/repro/kernels/spiking_attention/kernel.py::sparse_packed_ssa_fwd
//           (body sparse_packed_ssa_kernel).
//
// Bound on this card: operations, 4*T'*N*M*D with T' the live (fold, plane)
// pairs.
//
// Design: a block reads the liveness of its P planes first (the same values
// in every thread, so every branch below is uniform).  When all P are dead it
// writes its zero output tiles and returns before it stages any word tile.
// In a live group a dead plane skips its score counts and its score @ v
// FMAs and is written as zero.  A dead plane's output is exactly zero in the
// packed kernel too (one of its two products has an all-zero operand), and
// live planes run the packed kernel's integer arithmetic, so the result
// equals the packed kernel's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kPBQ = 32, kPBKV = 32;

template <int P>
__host__ __device__ inline int packed_smem_bytes(int d) {
  return 4 * (kPBQ * d + kPBKV * (d + 1) + kPBKV * d + P * kPBQ * kPBKV);
}

// kGated: live holds the (G, T) plane liveness, and dead planes are skipped;
// otherwise live is unused.
template <int P, bool kGated>
__global__ void __launch_bounds__(kThreads)
packed_ssa_kernel(const uint32_t* __restrict__ qw, const uint32_t* __restrict__ kw,
                  const uint32_t* __restrict__ vw, const int* __restrict__ live,
                  float* __restrict__ out, int g_total, int n, int m, int d, int t_total,
                  float scale, int causal) {
  extern __shared__ uint32_t psmem[];
  const int ldk = d + 1;
  uint32_t* qs = psmem;             // [kPBQ][d] words
  uint32_t* ks = qs + kPBQ * d;     // [kPBKV][d + 1] words
  uint32_t* vs = ks + kPBKV * ldk;  // [kPBKV][d] words
  float* ss = reinterpret_cast<float*>(vs + kPBKV * d);  // [P][kPBQ][kPBKV] scores

  const int tid = threadIdx.x;
  const long long g = blockIdx.x;
  const int q0 = blockIdx.y * kPBQ;
  const int p0 = blockIdx.z * P;
  const int bit0 = p0 & 31;
  const long long plane = static_cast<long long>(p0 >> 5) * g_total + g;  // (word, fold)
  const uint32_t* qg = qw + plane * n * d;
  const uint32_t* kg = kw + plane * m * d;
  const uint32_t* vg = vw + plane * m * d;

  unsigned live_mask = (1u << P) - 1u;  // bit p: plane p0 + p is computed
  if (kGated) {
    live_mask = 0u;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p0 + p < t_total && live[g * t_total + p0 + p] != 0) live_mask |= 1u << p;
    }
    if (live_mask == 0u) {  // every plane of the group is dead: zeros, no staging
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (p0 + p >= t_total) break;
        float* og = out + (static_cast<long long>(p0 + p) * g_total + g) * n * d;
        for (int e = tid; e < kPBQ * d; e += kThreads) {
          if (q0 + e / d < n) og[static_cast<long long>(q0 + e / d) * d + e % d] = 0.0f;
        }
      }
      return;
    }
  }

  for (int e = tid; e < kPBQ * d; e += kThreads) {
    const int r = e / d;
    qs[e] = (q0 + r < n) ? qg[static_cast<long long>(q0 + r) * d + e % d] : 0u;
  }

  float acc[P][kOutPerThread];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int l = 0; l < kOutPerThread; ++l) acc[p][l] = 0.0f;

  const int kv_end = causal ? min(m, q0 + kPBQ) : m;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kPBKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kPBKV * d; e += kThreads) {
      const int r = e / d, f = e % d;
      const bool in = kv0 + r < m;
      const long long src = static_cast<long long>(kv0 + r) * d + f;
      ks[r * ldk + f] = in ? kg[src] : 0u;
      vs[e] = in ? vg[src] : 0u;
    }
    __syncthreads();

    for (int e = tid; e < kPBQ * kPBKV; e += kThreads) {
      const int i = e / kPBKV, j = e % kPBKV;
      int cnt[P];
#pragma unroll
      for (int p = 0; p < P; ++p) cnt[p] = 0;
      for (int f = 0; f < d; ++f) {
        const uint32_t both = (qs[i * d + f] & ks[j * ldk + f]) >> bit0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if ((live_mask >> p) & 1u) cnt[p] += static_cast<int>((both >> p) & 1u);
        }
      }
      const bool masked = causal && kv0 + j > q0 + i;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        ss[(p * kPBQ + i) * kPBKV + j] = masked ? 0.0f : static_cast<float>(cnt[p]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int l = 0; l < kOutPerThread; ++l) {
      const int e = tid + l * kThreads;
      if (e < kPBQ * d) {
        const int i = e / d, f = e % d;
        for (int j = 0; j < kPBKV; ++j) {
          const uint32_t vbits = vs[j * d + f] >> bit0;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if ((live_mask >> p) & 1u) {
              acc[p][l] = fmaf(ss[(p * kPBQ + i) * kPBKV + j],
                               static_cast<float>((vbits >> p) & 1u), acc[p][l]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int t = p0 + p;
    if (t >= t_total) break;
    float* og = out + (static_cast<long long>(t) * g_total + g) * n * d;
#pragma unroll
    for (int l = 0; l < kOutPerThread; ++l) {
      const int e = tid + l * kThreads;
      if (e < kPBQ * d && q0 + e / d < n) {
        og[static_cast<long long>(q0 + e / d) * d + e % d] = acc[p][l] * scale;
      }
    }
  }
}

template <int P, bool kGated>
int launch_packed(const uint32_t* qw, const uint32_t* kw, const uint32_t* vw,
                  const int* live, float* out, int g, int n, int m, int d, int t_total,
                  float scale, int causal, cudaStream_t stream) {
  const size_t smem = packed_smem_bytes<P>(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_ssa_kernel<P, kGated>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(g), static_cast<unsigned>((n + kPBQ - 1) / kPBQ),
                  static_cast<unsigned>((t_total + P - 1) / P));
  packed_ssa_kernel<P, kGated><<<grid, kThreads, smem, stream>>>(
      qw, kw, vw, live, out, g, n, m, d, t_total, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGated>
int launch_packed_steps(const void* qw, const void* kw, const void* vw, const void* live,
                        void* out, int g, int n, int m, int d, int t_total, float scale,
                        int causal, void* stream) {
  if (d > kMaxD || t_total < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const uint32_t*>(qw);
  const auto* k = static_cast<const uint32_t*>(kw);
  const auto* v = static_cast<const uint32_t*>(vw);
  const auto* lv = static_cast<const int*>(live);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (t_total == 1) {
    return launch_packed<1, kGated>(q, k, v, lv, o, g, n, m, d, t_total, scale, causal, s);
  }
  if (t_total == 2) {
    return launch_packed<2, kGated>(q, k, v, lv, o, g, n, m, d, t_total, scale, causal, s);
  }
  return launch_packed<4, kGated>(q, k, v, lv, o, g, n, m, d, t_total, scale, causal, s);
}

}  // namespace

extern "C" int packed_ssa_fwd(const void* qw, const void* kw, const void* vw, void* out,
                              int g, int n, int m, int d, int t_total, float scale,
                              int causal, void* stream) {
  return launch_packed_steps<false>(qw, kw, vw, nullptr, out, g, n, m, d, t_total, scale,
                                    causal, stream);
}

// live: (g, t_total) int32, nonzero where plane t of fold g is live.
extern "C" int sparse_packed_ssa_fwd(const void* qw, const void* kw, const void* vw,
                                     const void* live, void* out, int g, int n, int m,
                                     int d, int t_total, float scale, int causal,
                                     void* stream) {
  return launch_packed_steps<true>(qw, kw, vw, live, out, g, n, m, d, t_total, scale,
                                   causal, stream);
}

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
