// Unrolled multi-time-step LIF with the optional fused IAND epilogue, in two
// output forms: dense f32 spikes, and spikes bit-packed along time.
//
// Replaces: src/repro/kernels/lif_parallel/kernel.py::lif_parallel_fwd
//           (bodies lif_fwd_kernel and lif_iand_fwd_kernel), and
//           src/repro/kernels/lif_parallel/kernel.py::lif_parallel_pack_fwd
//           (bodies lif_pack_fwd_kernel, lif_iand_pack_fwd_kernel, _pack_rows).
//
// Computes, for a (T, N) f32 drive and every neuron column n:
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
// Bit-exactness with the plain PyTorch version: built without
// --use_fast_math (no flush-to-zero), the spike compares u >= theta (under
// FTZ, u - theta >= 0 would read a negative denormal difference as -0), and
// lam * v + I is written with __fmul_rn/__fadd_rn so that no FMA contraction
// rounds differently from the two separate eager operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOccTile = 128;           // features per occupancy tile
constexpr unsigned kFullWarp = 0xffffffffu;

// One step of the chain: advances the membrane v and returns the spike s_t.
template <bool kSoft>
__device__ __forceinline__ bool lif_step(float& v, float drive, float lam, float theta) {
  const float u = __fadd_rn(__fmul_rn(lam, v), drive);
  const bool s = u >= theta;
  const float sf = s ? 1.0f : 0.0f;
  v = kSoft ? __fsub_rn(u, __fmul_rn(theta, sf)) : __fmul_rn(u, __fsub_rn(1.0f, sf));
  return s;
}

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
    const float s = lif_step<kSoft>(v, drive[idx], lam, theta) ? 1.0f : 0.0f;
    out[idx] = kIand ? __fmul_rn(skip[idx], __fsub_rn(1.0f, s)) : s;
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

template <bool kIand, bool kSoft, bool kOcc>
__global__ void __launch_bounds__(kThreads)
lif_pack_kernel(const float* __restrict__ drive, const uint32_t* __restrict__ skip_words,
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
    const float x = valid ? drive[static_cast<long long>(t) * n + i] : 0.0f;
    const bool s = lif_step<kSoft>(v, x, lam, theta) && valid;
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

unsigned grid_for(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

template <bool kIand>
void launch_dense(const float* drive, const float* skip, float* out, int t_total, int n,
                  int chain_len, float lam, float theta, int soft, cudaStream_t stream) {
  if (soft) {
    lif_parallel_kernel<kIand, true><<<grid_for(n), kThreads, 0, stream>>>(
        drive, skip, out, t_total, n, chain_len, lam, theta);
  } else {
    lif_parallel_kernel<kIand, false><<<grid_for(n), kThreads, 0, stream>>>(
        drive, skip, out, t_total, n, chain_len, lam, theta);
  }
}

template <bool kIand, bool kOcc>
void launch_pack(const float* drive, const uint32_t* skip_words, uint32_t* out_words,
                 uint32_t* occ, int t_total, int n, int chain_len, float lam, float theta,
                 int soft, int occ_cols, cudaStream_t stream) {
  if (soft) {
    lif_pack_kernel<kIand, true, kOcc><<<grid_for(n), kThreads, 0, stream>>>(
        drive, skip_words, out_words, occ, t_total, n, chain_len, lam, theta, occ_cols);
  } else {
    lif_pack_kernel<kIand, false, kOcc><<<grid_for(n), kThreads, 0, stream>>>(
        drive, skip_words, out_words, occ, t_total, n, chain_len, lam, theta, occ_cols);
  }
}

template <bool kIand>
int launch_pack_occ(const float* drive, const uint32_t* skip_words, uint32_t* out_words,
                    uint32_t* occ, int t_total, int n, int chain_len, float lam,
                    float theta, int soft, int occ_cols, cudaStream_t stream) {
  if (occ == nullptr) {
    launch_pack<kIand, false>(drive, skip_words, out_words, occ, t_total, n, chain_len,
                              lam, theta, soft, occ_cols, stream);
    return static_cast<int>(cudaGetLastError());
  }
  if (occ_cols < 1 || n % occ_cols) return static_cast<int>(cudaErrorInvalidValue);
  const size_t tiles = static_cast<size_t>((t_total + 31) / 32) * (n / occ_cols) *
                       ((occ_cols + kOccTile - 1) / kOccTile);
  const cudaError_t err = cudaMemsetAsync(occ, 0, tiles * sizeof(uint32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_pack<kIand, true>(drive, skip_words, out_words, occ, t_total, n, chain_len, lam,
                           theta, soft, occ_cols, stream);
  return static_cast<int>(cudaGetLastError());
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
    launch_dense<true>(d, k, o, t_total, n, chain_len, lam, theta, soft, s);
  } else {
    launch_dense<false>(d, k, o, t_total, n, chain_len, lam, theta, soft, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// occ == nullptr: no occupancy map (occ_cols is ignored).  Otherwise occ holds
// ceil(T/32) * (n / occ_cols) * ceil(occ_cols / 128) counts; it is zeroed here.
extern "C" int lif_parallel_pack_fwd(const void* drive, const void* skip_words,
                                     void* out_words, void* occ, int t_total, int n,
                                     int chain_len, float lam, float theta, int soft,
                                     int occ_cols, void* stream) {
  const auto* d = static_cast<const float*>(drive);
  const auto* k = static_cast<const uint32_t*>(skip_words);
  auto* o = static_cast<uint32_t*>(out_words);
  auto* m = static_cast<uint32_t*>(occ);
  auto s = static_cast<cudaStream_t>(stream);
  if (k != nullptr) {
    return launch_pack_occ<true>(d, k, o, m, t_total, n, chain_len, lam, theta, soft,
                                 occ_cols, s);
  }
  return launch_pack_occ<false>(d, k, o, m, t_total, n, chain_len, lam, theta, soft,
                                occ_cols, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
