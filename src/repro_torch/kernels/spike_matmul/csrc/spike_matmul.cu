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
//
// Packed variant, packed_spike_matmul_fwd: (M, K) 32-bit spike words x (K, C)
// f32 -> (T, M, C) f32, T <= 32, bit t of word x[m, k] the spike of (m, k) at
// time step t.
//
// Replaces: src/repro/kernels/spike_matmul/kernel.py::packed_spike_matmul_fwd
//           (body packed_matmul_kernel).
//
// Bound on this card: operations, as the dense GEMM (2*T*M*K*C flops); the
// activation read is 1/T of the dense kernel's, because one word carries all
// T time steps.
//
// Design: the dense kernel's SIMT tiling with a bitplane axis.  A 256-thread
// block owns a 64 x 64 output tile for P consecutive time steps (P = 1, 2 or
// 4; blockIdx.z walks the groups of P planes, so T > 4 re-reads the words
// once per group).  It stages an (8 x 64) slab of words, unpacks each word
// once into P f32 bitplanes in shared memory (shift and mask), stages the
// (8 x 64) weight slab, and each thread accumulates a 4 x 4 micro-tile for
// each of its P planes (P*16 f32 accumulators; the dense kernel's 8 x 8 tile
// already took 127 registers, so the micro-tile shrinks by the plane count).
// Each output is one f32 sum over k in increasing order with the same
// fmaf(spike, w, acc) as the dense kernel, so it equals the dense kernel's
// output on the unpacked operand bit for bit.  Ragged M, K and C are masked.
//
// Occupancy-gated variant, sparse_packed_spike_matmul_fwd: the packed GEMM
// with, beside the words, an int32 array of spike counts per (64-row M tile,
// 128-feature K tile) of the word operand, (ceil(M/64), ceil(K/128)).
//
// Replaces: src/repro/kernels/spike_matmul/kernel.py::
//           sparse_packed_spike_matmul_fwd (body sparse_packed_matmul_kernel).
//
// Bound on this card: operations, 2*T*K'*M*C flops where K' counts only the
// live (M, K) tiles; the word and weight reads of a dead tile are skipped too.
//
// Design: the packed kernel with its K loop cut into 128-feature tiles.  At
// each tile boundary every thread of the block reads the same count, so the
// branch is uniform: a dead tile (count 0) skips its 16 K-steps whole --
// no word or weight load, no unpack, no FMA.  A dead tile's contribution is
// fmaf(0, w, acc) == acc for finite w, and the surviving K-steps run in the
// packed kernel's order, so the result equals the packed kernel's bit for bit
// (and through it the dense kernel's on the unpacked operand).  The last K
// tile may be short: its K-steps stop at K, and its count covers only the
// columns that exist.

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kPBM = 64, kPBN = 64, kPBK = 8, kPTM = 4, kPTN = 4;
constexpr int kPThreads = (kPBM / kPTM) * (kPBN / kPTN);  // 256
constexpr int kOccTile = 128;  // K features per occupancy tile, a multiple of kPBK

// kGated: tiles holds the (ceil(M/64), ceil(K/128)) spike counts, and a K tile
// whose count is 0 is skipped; otherwise tiles is unused.
template <int P, bool kGated>
__global__ void __launch_bounds__(kPThreads)
packed_spike_matmul_kernel(const uint32_t* __restrict__ xw, const float* __restrict__ w,
                           const int* __restrict__ tiles, float* __restrict__ out, int m,
                           int k, int c, int t_total) {
  __shared__ __align__(16) float xs[P][kPBK][kPBM];  // bitplanes of the word slab, transposed
  __shared__ __align__(16) float ws[kPBK][kPBN];

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kPBM;
  const int col0 = blockIdx.y * kPBN;
  const int p0 = blockIdx.z * P;  // first time step of this block; p0 + P <= 32
  const int tr = tid / (kPBN / kPTN);
  const int tc = tid % (kPBN / kPTN);

  float acc[P][kPTM][kPTN];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < kPTM; ++i)
#pragma unroll
      for (int j = 0; j < kPTN; ++j) acc[p][i][j] = 0.0f;

  const int k_tiles = (k + kOccTile - 1) / kOccTile;
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kGated && tiles[static_cast<long long>(blockIdx.x) * k_tiles + kt] == 0) continue;
    const int k_stop = min(k, (kt + 1) * kOccTile);
    for (int k0 = kt * kOccTile; k0 < k_stop; k0 += kPBK) {
#pragma unroll
      for (int l = 0; l < kPBM * kPBK / kPThreads; ++l) {
        const int e = tid + l * kPThreads;
        const int r = e / kPBK, kk = e % kPBK;
        const long long gr = row0 + r;
        const int gk = k0 + kk;
        const uint32_t word = (gr < m && gk < k) ? (xw[gr * k + gk] >> p0) : 0u;
#pragma unroll
        for (int p = 0; p < P; ++p) xs[p][kk][r] = static_cast<float>((word >> p) & 1u);
      }
#pragma unroll
      for (int l = 0; l < kPBK * kPBN / kPThreads; ++l) {
        const int e = tid + l * kPThreads;
        const int kk = e / kPBN, cc = e % kPBN;
        const int gk = k0 + kk, gc = col0 + cc;
        ws[kk][cc] = (gk < k && gc < c) ? w[static_cast<long long>(gk) * c + gc] : 0.0f;
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < kPBK; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tc * kPTN]);
        const float b[kPTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float4 av = *reinterpret_cast<const float4*>(&xs[p][kk][tr * kPTM]);
          const float a[kPTM] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int i = 0; i < kPTM; ++i)
#pragma unroll
            for (int j = 0; j < kPTN; ++j) acc[p][i][j] = fmaf(a[i], b[j], acc[p][i][j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int t = p0 + p;
    if (t >= t_total) break;
#pragma unroll
    for (int i = 0; i < kPTM; ++i) {
      const long long gr = row0 + tr * kPTM + i;
      if (gr >= m) break;
      float* orow = out + (static_cast<long long>(t) * m + gr) * c;
#pragma unroll
      for (int j = 0; j < kPTN; ++j) {
        const int gc = col0 + tc * kPTN + j;
        if (gc < c) orow[gc] = acc[p][i][j];
      }
    }
  }
}

template <int P, bool kGated>
void launch_packed(const uint32_t* xw, const float* w, const int* tiles, float* out, int m,
                   int k, int c, int t_total, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + kPBM - 1) / kPBM),
                  static_cast<unsigned>((c + kPBN - 1) / kPBN),
                  static_cast<unsigned>((t_total + P - 1) / P));
  packed_spike_matmul_kernel<P, kGated><<<grid, kPThreads, 0, stream>>>(
      xw, w, tiles, out, m, k, c, t_total);
}

template <bool kGated>
int launch_packed_steps(const void* xw, const void* w, const void* tiles, void* out, int m,
                        int k, int c, int t_total, void* stream) {
  if (t_total < 1 || t_total > 32) return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const uint32_t*>(xw);
  const auto* wt = static_cast<const float*>(w);
  const auto* tl = static_cast<const int*>(tiles);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (t_total == 1) {
    launch_packed<1, kGated>(x, wt, tl, o, m, k, c, t_total, s);
  } else if (t_total == 2) {
    launch_packed<2, kGated>(x, wt, tl, o, m, k, c, t_total, s);
  } else {
    launch_packed<4, kGated>(x, wt, tl, o, m, k, c, t_total, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int packed_spike_matmul_fwd(const void* xw, const void* w, void* out, int m,
                                       int k, int c, int t_total, void* stream) {
  return launch_packed_steps<false>(xw, w, nullptr, out, m, k, c, t_total, stream);
}

// tiles: (ceil(m/64), ceil(k/128)) int32 spike counts of the word operand.
extern "C" int sparse_packed_spike_matmul_fwd(const void* xw, const void* w,
                                              const void* tiles, void* out, int m, int k,
                                              int c, int t_total, void* stream) {
  return launch_packed_steps<true>(xw, w, tiles, out, m, k, c, t_total, stream);
}

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
