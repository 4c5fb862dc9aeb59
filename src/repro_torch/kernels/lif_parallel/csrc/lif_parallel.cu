// Unrolled multi-time-step LIF with the optional fused IAND epilogue, in two
// output forms: dense f32 spikes, and spikes bit-packed along time; and its
// backward pass (the drive cotangent under the boxcar surrogate).
//
// Replaces: src/repro/kernels/lif_parallel/kernel.py::lif_parallel_fwd
//           (bodies lif_fwd_kernel and lif_iand_fwd_kernel),
//           src/repro/kernels/lif_parallel/kernel.py::lif_parallel_pack_fwd
//           (bodies lif_pack_fwd_kernel, lif_iand_pack_fwd_kernel, _pack_rows),
//           and src/repro/kernels/lif_parallel/kernel.py::lif_parallel_bwd
//           (body lif_bwd_kernel).
//
// Computes, for a (T, N) f32 or bf16 drive and every neuron column n:
//     u_t = lam * v_{t-1} + I_t,  s_t = (u_t >= theta),
//     v_t = u_t * (1 - s_t)  (hard reset)  or  u_t - theta * s_t  (soft),
// with the membrane restarting from zero every chain_len steps (the paper's
// reconfigurable 111/101/000 mux).  lif_parallel_fwd writes s_t, or
// skip_t * (1 - s_t) when the IAND residual is fused in.  lif_parallel_pack_fwd
// ORs s_t into bit t % 32 of word t / 32 and writes ceil(T/32) 32-bit words
// per neuron, or skip_word & ~word when the IAND residual is fused in; only
// bits < T are ever set, so the ragged tail of the last word stays zero.
//
// Bound on this card: bytes.  The work is a handful of flops per element
// against a 4-byte read of the drive and a 4-byte write (dense) or a 4-byte
// word per 32 steps (packed), far below the H100's flop-per-byte balance.
// The least traffic is: read the drive once, read the skip once, write the
// output once; the packed form cuts the write (and the skip read) by T/ceil(T/32).
//
// Design: one thread per neuron column; the T-step chain runs in a register,
// so the membrane never reaches device memory (the analogue of the paper
// eliminating the membrane SRAM), and in the packed form the word is built in
// a register too.  At step t, adjacent threads touch adjacent n, so every load
// and store of a warp is one coalesced 128-byte line.  The ragged tail is
// masked, not padded.  Both forms run the one chain step lif_step, so their
// spikes are the same bit for bit.
//
// Occupancy epilogue of the packed form (the sparse datapath's skip index;
// replaces the jnp map that src/repro/kernels/lif_parallel/ops.py::
// _occ_epilogue lets XLA fuse into the op): given occ and occ_cols = D, the
// (T, N) drive is read as N / D rows of D features, and occ[w][row][tile]
// receives the popcount of the final words (IAND applied) of the D-feature
// row's 128-feature tile `tile`, per word plane w -- a ragged tail counts as
// a short tile.  Each lane popcounts its own word; the lanes of a warp that
// share a tile (consecutive columns, so contiguous runs of lanes) sum their
// counts with a segmented shuffle scan, and the last lane of each run adds
// the sum to the map with one atomicAdd (the map is zeroed on the stream
// first).  Integer sums, so the order of the atomics does not matter.  The
// scan needs every lane of the warp, so lanes past N stay alive and count 0.
//
// Backward (lif_parallel_bwd): given the drive and the spike cotangent g,
// both (T, N) of the drive's dtype, it writes dx = d(spikes)/d(drive)^T g, the surrogate of
// H(u - theta) being the boxcar [|u - theta| < width/2] / width.  Chains are
// independent (the mux cuts the membrane, and with it dv, at every chain
// boundary), so each thread takes its column's chains one at a time: it
// recomputes u_t of the chain forward with the forward kernels' own step,
// keeps them in registers (chain_len 1, 2, 4 or 8; a longer chain parks u_t
// in the thread's own dx column between the two walks), then walks the
// chain in reverse with dv, the cotangent of the membrane v_t:
//     hard reset:  ds = g - dv*u,       du = ds*surr + dv*(1 - s)
//     soft reset:  ds = g - theta*dv,   du = ds*surr + dv
//     dx_t = du,   dv = lam*du,   and dv = 0 entering a chain's last step.
// The spike cotangent is summed BEFORE the surrogate multiplies it, which is
// the grouping autograd gives the plain chain; every product and sum is
// rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn), as eager PyTorch
// rounds them, so nvcc contracts none of them into an FMA and the result
// equals the plain version's autograd bit for bit.  Bound on this card:
// bytes -- read the drive and g once, write dx once, 12*T bytes per neuron
// against ~10 flops per step; every access of a warp is one coalesced
// 128-byte line, as in the forward kernels.
//
// Bit-exactness with the plain PyTorch version: built without
// --use_fast_math (no flush-to-zero), the spike compares u >= theta (under
// FTZ, u - theta >= 0 would read a negative denormal difference as -0), and
// lam * v + I is written with __fmul_rn/__fadd_rn so that no FMA contraction
// rounds differently from the two separate eager operations.
//
// bf16 drives (every kernel, an element type template parameter T): the
// reference runs the chain in the drive's dtype (src/repro/kernels/
// lif_parallel/kernel.py::_chain), so every product and sum is a bf16 value.
// Each operation is computed in f32 with the same __fmul_rn/__fadd_rn/
// __fsub_rn and its result rounded to bf16 (__float2bfloat16_rn) before the
// next operation reads it -- what eager PyTorch does for bf16 tensors (f32
// arithmetic, one rounding per op, a Python scalar such as lam kept in f32) --
// so the kernels equal the plain version in bf16 bit for bit.  The membrane
// lives in an f32 register holding a bf16 value.  The dense forward writes
// bf16 spikes (and takes a bf16 skip), the packed forward the same words as
// from an f32 drive's chain, and the backward a bf16 dx from a bf16 g.
// Bound on this card: bytes, 2 per element read or written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOccTile = 128;           // features per occupancy tile
constexpr unsigned kFullWarp = 0xffffffffu;

// The element types: f32 and bf16 drives (and spikes, skips, cotangents).
// rnd<T> rounds one operation's f32 result to T (the identity for f32), and
// every value kept between operations has passed through it.
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One step of the chain: returns the membrane u_t = lam * v + drive and
// advances v to v_t, reset by the spike s_t = (u_t >= theta); each operation
// rounded to T.
template <typename T, bool kSoft>
__device__ __forceinline__ float lif_membrane(float& v, float drive, float lam, float theta) {
  const float u = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(lam, v)), drive));
  const float sf = u >= theta ? 1.0f : 0.0f;
  v = kSoft ? rnd<T>(__fsub_rn(u, rnd<T>(__fmul_rn(theta, sf))))
            : rnd<T>(__fmul_rn(u, __fsub_rn(1.0f, sf)));
  return u;
}

// One step of the chain: advances the membrane v and returns the spike s_t.
template <typename T, bool kSoft>
__device__ __forceinline__ bool lif_step(float& v, float drive, float lam, float theta) {
  return lif_membrane<T, kSoft>(v, drive, lam, theta) >= theta;
}

// One reverse step of the chain: returns the drive cotangent du_t from the
// membrane u_t and the spike cotangent g_t; dv enters as the cotangent of v_t
// and leaves as that of v_{t-1}.  The spike is H(u - theta), as in the plain
// version (the same as u >= theta without flush-to-zero); inv_width is
// 1 / width rounded to T.  Each operation is rounded to T.
template <typename T, bool kSoft>
__device__ __forceinline__ float lif_bwd_step(float& dv, float u, float g, float lam,
                                              float theta, float half_width,
                                              float inv_width) {
  const float x = rnd<T>(__fsub_rn(u, theta));
  const float surr = fabsf(x) < half_width ? inv_width : 0.0f;
  float du;
  if (kSoft) {
    const float ds = rnd<T>(__fsub_rn(g, rnd<T>(__fmul_rn(theta, dv))));
    du = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(ds, surr)), dv));
  } else {
    const float sf = x >= 0.0f ? 1.0f : 0.0f;
    const float ds = rnd<T>(__fsub_rn(g, rnd<T>(__fmul_rn(dv, u))));
    du = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(ds, surr)),
                          rnd<T>(__fmul_rn(dv, __fsub_rn(1.0f, sf)))));
  }
  dv = rnd<T>(__fmul_rn(lam, du));
  return du;
}

template <typename T, bool kIand, bool kSoft>
__global__ void __launch_bounds__(kThreads)
lif_parallel_kernel(const T* __restrict__ drive, const T* __restrict__ skip,
                    T* __restrict__ out, int t_total, int n, int chain_len,
                    float lam, float theta) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float v = 0.0f;
  for (int t = 0; t < t_total; ++t) {
    if (t % chain_len == 0) v = 0.0f;  // mux: chain boundary -> fresh membrane
    const long long idx = static_cast<long long>(t) * n + i;
    const float s = lif_step<T, kSoft>(v, to_f32(drive[idx]), lam, theta) ? 1.0f : 0.0f;
    out[idx] = from_f32<T>(kIand ? __fmul_rn(to_f32(skip[idx]), __fsub_rn(1.0f, s)) : s);
  }
}

// Adds cnt to occ[tile], summed first over the lanes of the warp that share
// the tile.  Every lane of the warp must call it, at the same point.
__device__ __forceinline__ void occ_add(uint32_t* occ, long long tile, uint32_t cnt) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const long long prev = __shfl_up_sync(kFullWarp, tile, 1);
  const unsigned heads = __ballot_sync(kFullWarp, lane == 0 || prev != tile);
  const int start = 31 - __clz(heads & (kFullWarp >> (31 - lane)));  // this run's first lane
  uint32_t sum = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t up = __shfl_up_sync(kFullWarp, sum, off);
    if (lane - off >= start) sum += up;
  }
  const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
  if (last && sum != 0u) atomicAdd(occ + tile, sum);
}

template <typename T, bool kIand, bool kSoft, bool kOcc>
__global__ void __launch_bounds__(kThreads)
lif_pack_kernel(const T* __restrict__ drive, const uint32_t* __restrict__ skip_words,
                uint32_t* __restrict__ out_words, uint32_t* __restrict__ occ, int t_total,
                int n, int chain_len, float lam, float theta, int occ_cols) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = i < n;
  if (!kOcc && !valid) return;
  long long tile = 0, plane_tiles = 0;   // this column's tile, and tiles per word plane
  if (kOcc) {
    const int nt = (occ_cols + kOccTile - 1) / kOccTile;
    const long long row = i / occ_cols;
    tile = row * nt + (i - row * occ_cols) / kOccTile;
    plane_tiles = static_cast<long long>(n / occ_cols) * nt;
  }
  float v = 0.0f;
  uint32_t word = 0u;
  for (int t = 0; t < t_total; ++t) {
    if (t % chain_len == 0) v = 0.0f;  // mux: chain boundary -> fresh membrane
    const float x = valid ? to_f32(drive[static_cast<long long>(t) * n + i]) : 0.0f;
    const bool s = lif_step<T, kSoft>(v, x, lam, theta) && valid;
    word |= static_cast<uint32_t>(s) << (t & 31);
    if ((t & 31) == 31 || t == t_total - 1) {  // word full, or the train ends
      const long long w = static_cast<long long>(t >> 5) * n + i;
      const uint32_t out = kIand ? ((valid ? skip_words[w] : 0u) & ~word) : word;
      if (valid) out_words[w] = out;
      if (kOcc) occ_add(occ + (t >> 5) * plane_tiles, tile, valid ? __popc(out) : 0u);
      word = 0u;
    }
  }
}

// kChain > 0: every chain has kChain steps, and u_t stays in registers;
// kChain == 0: chain_len steps, u_t parked in dx between the two walks.
template <typename T, int kChain, bool kSoft>
__global__ void __launch_bounds__(kThreads)
lif_bwd_kernel(const T* __restrict__ drive, const T* __restrict__ g,
               T* __restrict__ dx, int t_total, int n, int chain_len, float lam,
               float theta, float width) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float half_width = __fmul_rn(0.5f, width);
  const float inv_width = rnd<T>(__fdiv_rn(1.0f, width));
  const int len = kChain > 0 ? kChain : chain_len;
  for (int t0 = 0; t0 < t_total; t0 += len) {
    const long long base = static_cast<long long>(t0) * n + i;
    float v = 0.0f, dv = 0.0f;   // a chain starts from a zero membrane, and no
                                 // cotangent flows past its last step
    if constexpr (kChain > 0) {
      float u[kChain];
#pragma unroll
      for (int c = 0; c < kChain; ++c) {
        u[c] = lif_membrane<T, kSoft>(v, to_f32(drive[base + static_cast<long long>(c) * n]),
                                      lam, theta);
      }
#pragma unroll
      for (int c = kChain - 1; c >= 0; --c) {
        const long long idx = base + static_cast<long long>(c) * n;
        dx[idx] = from_f32<T>(lif_bwd_step<T, kSoft>(dv, u[c], to_f32(g[idx]), lam, theta,
                                                     half_width, inv_width));
      }
    } else {
      for (int c = 0; c < len; ++c) {
        const long long idx = base + static_cast<long long>(c) * n;
        dx[idx] = from_f32<T>(lif_membrane<T, kSoft>(v, to_f32(drive[idx]), lam, theta));
      }
      for (int c = len - 1; c >= 0; --c) {
        const long long idx = base + static_cast<long long>(c) * n;
        dx[idx] = from_f32<T>(lif_bwd_step<T, kSoft>(dv, to_f32(dx[idx]), to_f32(g[idx]), lam,
                                                     theta, half_width, inv_width));
      }
    }
  }
}

unsigned grid_for(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

template <typename T, bool kIand>
void launch_dense(const void* drive, const void* skip, void* out, int t_total, int n,
                  int chain_len, float lam, float theta, int soft, cudaStream_t stream) {
  const auto* d = static_cast<const T*>(drive);
  const auto* k = static_cast<const T*>(skip);
  auto* o = static_cast<T*>(out);
  if (soft) {
    lif_parallel_kernel<T, kIand, true><<<grid_for(n), kThreads, 0, stream>>>(
        d, k, o, t_total, n, chain_len, lam, theta);
  } else {
    lif_parallel_kernel<T, kIand, false><<<grid_for(n), kThreads, 0, stream>>>(
        d, k, o, t_total, n, chain_len, lam, theta);
  }
}

template <typename T>
void launch_dense_t(const void* drive, const void* skip, void* out, int t_total, int n,
                    int chain_len, float lam, float theta, int soft, cudaStream_t stream) {
  if (skip != nullptr) {
    launch_dense<T, true>(drive, skip, out, t_total, n, chain_len, lam, theta, soft, stream);
  } else {
    launch_dense<T, false>(drive, skip, out, t_total, n, chain_len, lam, theta, soft, stream);
  }
}

template <typename T, bool kIand, bool kOcc>
void launch_pack(const T* drive, const uint32_t* skip_words, uint32_t* out_words,
                 uint32_t* occ, int t_total, int n, int chain_len, float lam, float theta,
                 int soft, int occ_cols, cudaStream_t stream) {
  if (soft) {
    lif_pack_kernel<T, kIand, true, kOcc><<<grid_for(n), kThreads, 0, stream>>>(
        drive, skip_words, out_words, occ, t_total, n, chain_len, lam, theta, occ_cols);
  } else {
    lif_pack_kernel<T, kIand, false, kOcc><<<grid_for(n), kThreads, 0, stream>>>(
        drive, skip_words, out_words, occ, t_total, n, chain_len, lam, theta, occ_cols);
  }
}

template <typename T, bool kIand>
int launch_pack_occ(const T* drive, const uint32_t* skip_words, uint32_t* out_words,
                    uint32_t* occ, int t_total, int n, int chain_len, float lam,
                    float theta, int soft, int occ_cols, cudaStream_t stream) {
  if (occ == nullptr) {
    launch_pack<T, kIand, false>(drive, skip_words, out_words, occ, t_total, n, chain_len,
                                 lam, theta, soft, occ_cols, stream);
    return static_cast<int>(cudaGetLastError());
  }
  if (occ_cols < 1 || n % occ_cols) return static_cast<int>(cudaErrorInvalidValue);
  const size_t tiles = static_cast<size_t>((t_total + 31) / 32) * (n / occ_cols) *
                       ((occ_cols + kOccTile - 1) / kOccTile);
  const cudaError_t err = cudaMemsetAsync(occ, 0, tiles * sizeof(uint32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_pack<T, kIand, true>(drive, skip_words, out_words, occ, t_total, n, chain_len, lam,
                              theta, soft, occ_cols, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pack_t(const void* drive, const void* skip_words, void* out_words, void* occ,
                  int t_total, int n, int chain_len, float lam, float theta, int soft,
                  int occ_cols, cudaStream_t stream) {
  const auto* d = static_cast<const T*>(drive);
  const auto* k = static_cast<const uint32_t*>(skip_words);
  auto* o = static_cast<uint32_t*>(out_words);
  auto* m = static_cast<uint32_t*>(occ);
  if (k != nullptr) {
    return launch_pack_occ<T, true>(d, k, o, m, t_total, n, chain_len, lam, theta, soft,
                                    occ_cols, stream);
  }
  return launch_pack_occ<T, false>(d, k, o, m, t_total, n, chain_len, lam, theta, soft,
                                   occ_cols, stream);
}

template <typename T, int kChain>
void launch_bwd(const void* drive, const void* g, void* dx, int t_total, int n,
                int chain_len, float lam, float theta, int soft, float width,
                cudaStream_t stream) {
  const auto* d = static_cast<const T*>(drive);
  const auto* gg = static_cast<const T*>(g);
  auto* o = static_cast<T*>(dx);
  if (soft) {
    lif_bwd_kernel<T, kChain, true><<<grid_for(n), kThreads, 0, stream>>>(
        d, gg, o, t_total, n, chain_len, lam, theta, width);
  } else {
    lif_bwd_kernel<T, kChain, false><<<grid_for(n), kThreads, 0, stream>>>(
        d, gg, o, t_total, n, chain_len, lam, theta, width);
  }
}

template <typename T>
void launch_bwd_t(const void* drive, const void* g, void* dx, int t_total, int n,
                  int chain_len, float lam, float theta, int soft, float width,
                  cudaStream_t s) {
  switch (chain_len) {
    case 1: launch_bwd<T, 1>(drive, g, dx, t_total, n, chain_len, lam, theta, soft, width, s); break;
    case 2: launch_bwd<T, 2>(drive, g, dx, t_total, n, chain_len, lam, theta, soft, width, s); break;
    case 4: launch_bwd<T, 4>(drive, g, dx, t_total, n, chain_len, lam, theta, soft, width, s); break;
    case 8: launch_bwd<T, 8>(drive, g, dx, t_total, n, chain_len, lam, theta, soft, width, s); break;
    default: launch_bwd<T, 0>(drive, g, dx, t_total, n, chain_len, lam, theta, soft, width, s);
  }
}

}  // namespace

// bf16 != 0: drive, skip and out are bf16; otherwise f32.
extern "C" int lif_parallel_fwd(const void* drive, const void* skip, void* out,
                                int t_total, int n, int chain_len, float lam,
                                float theta, int soft, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_dense_t<__nv_bfloat16>(drive, skip, out, t_total, n, chain_len, lam, theta, soft, s);
  } else {
    launch_dense_t<float>(drive, skip, out, t_total, n, chain_len, lam, theta, soft, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// occ == nullptr: no occupancy map (occ_cols is ignored).  Otherwise occ holds
// ceil(T/32) * (n / occ_cols) * ceil(occ_cols / 128) counts; it is zeroed here.
// bf16 != 0: the drive is bf16; otherwise f32.
extern "C" int lif_parallel_pack_fwd(const void* drive, const void* skip_words,
                                     void* out_words, void* occ, int t_total, int n,
                                     int chain_len, float lam, float theta, int soft,
                                     int occ_cols, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_pack_t<__nv_bfloat16>(drive, skip_words, out_words, occ, t_total, n,
                                        chain_len, lam, theta, soft, occ_cols, s);
  }
  return launch_pack_t<float>(drive, skip_words, out_words, occ, t_total, n, chain_len, lam,
                              theta, soft, occ_cols, s);
}

// dx: (t_total, n), the drive cotangent; chain_len must divide t_total.
// bf16 != 0: drive, g and dx are bf16; otherwise f32.
extern "C" int lif_parallel_bwd(const void* drive, const void* g, void* dx, int t_total,
                                int n, int chain_len, float lam, float theta, int soft,
                                float width, int bf16, void* stream) {
  if (chain_len < 1 || t_total % chain_len) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_bwd_t<__nv_bfloat16>(drive, g, dx, t_total, n, chain_len, lam, theta, soft, width, s);
  } else {
    launch_bwd_t<float>(drive, g, dx, t_total, n, chain_len, lam, theta, soft, width, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
