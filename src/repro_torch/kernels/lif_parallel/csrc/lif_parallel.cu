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
// Design of the two forward kernels: the T-step chain of a neuron column runs
// in a register, so the membrane never reaches device memory (the analogue of
// the paper eliminating the membrane SRAM), and in the packed form the word
// is built in a register too.  What bounds them is bytes in flight: the
// packed form is a pure read stream.  So each thread takes VEC adjacent
// columns, 16 bytes of the drive a step (VEC = 4 in f32, 8 in bf16), moved
// by one 16-byte access; a warp's access of a step is 512 contiguous bytes,
// and K1's spikes and K4's words are stored the same way (words 4 to an
// access).  Before a step's arithmetic runs, the thread issues the loads of
// a whole chunk of steps: all T of them when T == 4 (the main paths' T,
// unrolled at compile time), else 8 at a time (a word of 32 steps is four
// chunks), so a thread has up to 8 x 16 bytes in flight.  The chain's
// arithmetic is lif_step, column by column.
// Where N (or a map's D) is not a multiple of VEC, or an operand's address is
// not 16-byte aligned (a view at an offset), the wrapper picks VEC = 1: the same kernel's
// scalar body, with the same chunked loads.  Small launches (an LM decode
// step's 4 x 2048 neurons) take smaller blocks, so that they still spread
// over the SMs.  Both forms run the one chain step lif_step, so their spikes
// are the same bit for bit.
//
// Occupancy epilogue of the packed form (the sparse datapath's skip index;
// replaces the jnp map that src/repro/kernels/lif_parallel/ops.py::
// _occ_epilogue lets XLA fuse into the op): given occ and occ_cols = D, the
// (T, N) drive is read as N / D rows of D features, and occ[w][row][tile]
// receives the popcount of the final words (IAND applied) of the D-feature
// row's 128-feature tile `tile`, per word plane w -- a ragged tail counts as
// a short tile.  Each lane popcounts its VEC words.  Where D is a multiple of
// 128 and VEC >= 4, the tiles are the global 128-column blocks and the lanes
// of a tile are a fixed group of 128 / VEC lanes (the whole warp in f32, a
// half warp in bf16): one warp reduction (__reduce_add_sync, or a half
// warp's shuffles) and one plain store by the group's first lane give every
// tile its count, so the map needs no memset and no atomics.  Otherwise
// (the tokenizer's D = 48, 96, 192, a ragged D) a lane's VEC columns still
// lie in one tile (D is a multiple of VEC, or VEC = 1); the lanes of a warp
// that share a tile (contiguous runs) sum their counts with a segmented
// shuffle scan, and the last lane of each run adds the sum to the map with
// one atomicAdd, the map zeroed on the stream first.  Integer sums, so the
// order of the atomics does not matter.  A warp wholly past N returns; the
// lanes past N of the last warp stay for the warp's sums and count 0.
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
// against ~10 flops per step; one column a thread, so every access of a warp
// is one coalesced 128-byte line.
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

#include <atomic>

namespace {

constexpr int kThreads = 256;           // threads a block (the forward kernels: at most)
constexpr int kOccTile = 128;           // features per occupancy tile
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kVecBytes = 16;           // one vector access of the forward kernels
constexpr int kChunk = 8;               // steps loaded together where T != 4
constexpr int kMaxDevices = 64;         // devices whose SM count is kept

// Occupancy epilogue of the packed forward: none, summed in the warp and
// stored (D % 128 == 0, VEC >= 4), or a segmented scan and atomics.
enum OccMode { kOccNone = 0, kOccWarp = 1, kOccAtomic = 2 };

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

// An element's bits as the forward kernels move them, and their value: a
// bf16 is the top half of its f32 (so get is exact), and put rounds to
// nearest even, as from_f32 does.
template <typename T> struct Elem;
template <> struct Elem<float> {
  using Bits = float;
  static __device__ __forceinline__ float get(float b) { return b; }
  static __device__ __forceinline__ float put(float x) { return x; }
};
template <> struct Elem<__nv_bfloat16> {
  using Bits = unsigned short;
  static __device__ __forceinline__ float get(unsigned short b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  static __device__ __forceinline__ unsigned short put(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

// VEC adjacent elements, moved by one access (16 bytes at full width).
template <typename B, int VEC>
struct alignas(sizeof(B) * VEC) Vec {
  B e[VEC];
};

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

// K1: VEC columns a thread; kT == 4: T is 4, unrolled; kT == 0: any T, in
// chunks of kChunk steps.  n % VEC == 0 (the wrapper's choice of VEC).
template <typename T, int VEC, int kT, bool kIand, bool kSoft>
__global__ void __launch_bounds__(kThreads)
lif_parallel_kernel(const typename Elem<T>::Bits* __restrict__ drive,
                    const typename Elem<T>::Bits* __restrict__ skip,
                    typename Elem<T>::Bits* __restrict__ out, int t_total, int n,
                    int chain_len, float lam, float theta) {
  using E = Elem<T>;
  using V = Vec<typename E::Bits, VEC>;
  constexpr int kC = kT > 0 ? kT : kChunk;
  const long long c0 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= n) return;
  const int steps = kT > 0 ? kT : t_total;
  float v[VEC];
  int left = 0;                      // steps left in the current chain
  for (int t0 = 0; t0 < steps; t0 += kC) {
    V x[kC], k[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) {     // the chunk's loads, all issued first
      if (kT > 0 || t0 + j < steps) {
        const long long idx = static_cast<long long>(t0 + j) * n + c0;
        x[j] = *reinterpret_cast<const V*>(drive + idx);
        if (kIand) k[j] = *reinterpret_cast<const V*>(skip + idx);
      }
    }
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      if (kT > 0 || t0 + j < steps) {
        if (left == 0) {               // mux: chain boundary -> fresh membrane
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = 0.0f;
          left = chain_len;
        }
        --left;
        V o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float s = lif_step<T, kSoft>(v[e], E::get(x[j].e[e]), lam, theta) ? 1.0f : 0.0f;
          o.e[e] = E::put(kIand ? __fmul_rn(E::get(k[j].e[e]), __fsub_rn(1.0f, s)) : s);
        }
        *reinterpret_cast<V*>(out + static_cast<long long>(t0 + j) * n + c0) = o;
      }
    }
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

// Stores into occ[tile] the sum of cnt over the tile's 128 / VEC lanes, an
// aligned group of the warp; `store`: the group lies within N.  Every lane
// of the warp must call it, at the same point.
template <int VEC>
__device__ __forceinline__ void occ_warp(uint32_t* occ, long long tile, uint32_t cnt,
                                         bool store) {
  constexpr int kLanes = kOccTile / VEC;
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "a tile's lanes must divide the warp");
  uint32_t sum;
  if constexpr (kLanes == 32) {
    sum = __reduce_add_sync(kFullWarp, cnt);
  } else {
    sum = cnt;
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFullWarp, sum, off);
  }
  if (store && (threadIdx.x & (kLanes - 1)) == 0) occ[tile] = sum;
}

// K4: VEC columns a thread as K1, its words stored 4 (or VEC) to an access;
// kOcc: the occupancy epilogue (OccMode).
template <typename T, int VEC, int kT, bool kIand, bool kSoft, int kOcc>
__global__ void __launch_bounds__(kThreads)
lif_pack_kernel(const typename Elem<T>::Bits* __restrict__ drive,
                const uint32_t* __restrict__ skip_words, uint32_t* __restrict__ out_words,
                uint32_t* __restrict__ occ, int t_total, int n, int chain_len, float lam,
                float theta, int occ_cols) {
  using E = Elem<T>;
  using V = Vec<typename E::Bits, VEC>;
  constexpr int kWV = VEC < 4 ? VEC : 4;   // words an access
  using W = Vec<uint32_t, kWV>;
  constexpr int kC = kT > 0 ? kT : kChunk;
  const long long c0 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (c0 - static_cast<long long>(threadIdx.x & 31) * VEC >= n) return;  // the warp is past N
  const bool valid = c0 < n;
  long long tile = 0, plane_tiles = 0;   // this thread's tile, and tiles per word plane
  if (kOcc == kOccAtomic) {
    const int nt = (occ_cols + kOccTile - 1) / kOccTile;
    const long long row = c0 / occ_cols;
    tile = row * nt + (c0 - row * occ_cols) / kOccTile;
    plane_tiles = static_cast<long long>(n / occ_cols) * nt;
  } else if (kOcc == kOccWarp) {         // D % 128 == 0: a row's tiles are 128-column blocks
    tile = c0 / kOccTile;
    plane_tiles = n / kOccTile;
  }
  const int steps = kT > 0 ? kT : t_total;
  float v[VEC];
  uint32_t word[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) word[e] = 0u;
  int left = 0;                          // steps left in the current chain
  for (int t0 = 0; t0 < steps; t0 += kC) {
    V x[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) {         // the chunk's loads, all issued first
      if (kT > 0 || t0 + j < steps) {
        x[j] = valid ? *reinterpret_cast<const V*>(drive + static_cast<long long>(t0 + j) * n + c0)
                     : V{};
      }
    }
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int t = t0 + j;
      if (kT > 0 || t < steps) {
        if (left == 0) {                   // mux: chain boundary -> fresh membrane
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = 0.0f;
          left = chain_len;
        }
        --left;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          word[e] |= static_cast<uint32_t>(lif_step<T, kSoft>(v[e], E::get(x[j].e[e]), lam,
                                                              theta)) << (t & 31);
        }
        if ((t & 31) == 31 || t == steps - 1) {  // word full, or the train ends
          const long long w = static_cast<long long>(t >> 5) * n + c0;
          uint32_t cnt = 0u;
#pragma unroll
          for (int p = 0; p < VEC / kWV; ++p) {
            W o, sk{};
            if (kIand && valid) sk = *reinterpret_cast<const W*>(skip_words + w + p * kWV);
#pragma unroll
            for (int e = 0; e < kWV; ++e) {
              o.e[e] = kIand ? (sk.e[e] & ~word[p * kWV + e]) : word[p * kWV + e];
              cnt += __popc(o.e[e]);
            }
            if (valid) *reinterpret_cast<W*>(out_words + w + p * kWV) = o;
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) word[e] = 0u;
          if (!valid) cnt = 0u;
          if constexpr (kOcc == kOccWarp) {
            occ_warp<VEC>(occ + static_cast<long long>(t >> 5) * plane_tiles, tile, cnt, valid);
          } else if constexpr (kOcc == kOccAtomic) {
            occ_add(occ + static_cast<long long>(t >> 5) * plane_tiles, tile, cnt);
          }
        }
      }
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

// A forward launch's arguments, as the C entry points take them.
struct FwdArgs {
  const void* drive;
  const void* skip;                      // K1: the skip; K4: the skip words
  void* out;
  uint32_t* occ;                         // K4's map, or nullptr
  int t_total, n, chain_len;
  float lam, theta;
  int soft, occ_cols, vec, occ_warp;
};

// The current device's streaming multiprocessors, asked once a device (1
// where the runtime cannot say: the launch that follows then reports the
// error).
int sm_count() {
  static std::atomic<int> counts[kMaxDevices];   // zero: not yet asked
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 1;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 1;
    counts[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Threads a block of a forward launch of `threads` threads: kThreads, halved
// (down to 64) while the grid would give fewer than two blocks an SM.
int block_threads(long long threads) {
  const int sms = sm_count();
  int b = kThreads;
  while (b > 64 && (threads + b - 1) / b < 2 * sms) b >>= 1;
  return b;
}

template <typename T, int VEC, int kT, bool kIand, bool kSoft>
void launch_dense(const FwdArgs& a, cudaStream_t stream) {
  using B = typename Elem<T>::Bits;
  const long long threads = a.n / VEC;
  const int b = block_threads(threads);
  lif_parallel_kernel<T, VEC, kT, kIand, kSoft>
      <<<static_cast<unsigned>((threads + b - 1) / b), b, 0, stream>>>(
          static_cast<const B*>(a.drive), static_cast<const B*>(a.skip), static_cast<B*>(a.out),
          a.t_total, a.n, a.chain_len, a.lam, a.theta);
}

template <typename T, int VEC, int kT, bool kIand, bool kSoft, int kOcc>
void launch_pack(const FwdArgs& a, cudaStream_t stream) {
  using B = typename Elem<T>::Bits;
  const long long threads = a.n / VEC;
  const int b = block_threads(threads);
  lif_pack_kernel<T, VEC, kT, kIand, kSoft, kOcc>
      <<<static_cast<unsigned>((threads + b - 1) / b), b, 0, stream>>>(
          static_cast<const B*>(a.drive), static_cast<const uint32_t*>(a.skip),
          static_cast<uint32_t*>(a.out), a.occ, a.t_total, a.n, a.chain_len, a.lam, a.theta,
          a.occ_cols);
}

// The runtime flags of a forward launch, turned into template arguments one
// at a time: the reset, the IAND, T == 4, the vector width, the element type.
template <bool kPack, typename T, int VEC, int kT, bool kIand, bool kSoft>
void launch_fwd(const FwdArgs& a, cudaStream_t s) {
  if constexpr (kPack) {
    if (a.occ == nullptr) {
      launch_pack<T, VEC, kT, kIand, kSoft, kOccNone>(a, s);
    } else if (a.occ_warp) {
      if constexpr (VEC >= 4) launch_pack<T, VEC, kT, kIand, kSoft, kOccWarp>(a, s);
    } else {
      launch_pack<T, VEC, kT, kIand, kSoft, kOccAtomic>(a, s);
    }
  } else {
    launch_dense<T, VEC, kT, kIand, kSoft>(a, s);
  }
}

template <bool kPack, typename T, int VEC, int kT, bool kIand>
void fwd_soft(const FwdArgs& a, cudaStream_t s) {
  if (a.soft) launch_fwd<kPack, T, VEC, kT, kIand, true>(a, s);
  else launch_fwd<kPack, T, VEC, kT, kIand, false>(a, s);
}

template <bool kPack, typename T, int VEC, int kT>
void fwd_iand(const FwdArgs& a, cudaStream_t s) {
  if (a.skip != nullptr) fwd_soft<kPack, T, VEC, kT, true>(a, s);
  else fwd_soft<kPack, T, VEC, kT, false>(a, s);
}

template <bool kPack, typename T, int VEC>
void fwd_steps(const FwdArgs& a, cudaStream_t s) {
  if (a.t_total == 4) fwd_iand<kPack, T, VEC, 4>(a, s);
  else fwd_iand<kPack, T, VEC, 0>(a, s);
}

template <bool kPack, typename T>
void fwd_vec(const FwdArgs& a, cudaStream_t s) {
  if (a.vec > 1) fwd_steps<kPack, T, kVecBytes / static_cast<int>(sizeof(T))>(a, s);
  else fwd_steps<kPack, T, 1>(a, s);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0; }

// cudaSuccess if the wrapper's choice of body is one this launch allows: vec
// is 1, or the full width (16 bytes of the drive) where N (and D) are
// multiples of it and every operand is 16-byte aligned; occ_warp only with a
// map whose D is a multiple of 128 at vec >= 4.
cudaError_t check_body(const FwdArgs& a, int elem_bytes) {
  const int full = kVecBytes / elem_bytes;
  if (a.vec != 1 && a.vec != full) return cudaErrorInvalidValue;
  if (a.vec > 1 && (a.n % a.vec || !aligned(a.drive) || !aligned(a.out) ||
                    (a.skip != nullptr && !aligned(a.skip)) ||
                    (a.occ != nullptr && a.occ_cols % a.vec))) {
    return cudaErrorMisalignedAddress;
  }
  if (a.occ_warp && (a.occ == nullptr || a.vec < 4 || a.occ_cols % kOccTile)) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
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

// bf16 != 0: drive, skip and out are bf16; otherwise f32.  vec: columns a
// thread, 1 or 16 bytes' worth (4 f32, 8 bf16; see check_body).
extern "C" int lif_parallel_fwd(const void* drive, const void* skip, void* out,
                                int t_total, int n, int chain_len, float lam,
                                float theta, int soft, int bf16, int vec, void* stream) {
  const FwdArgs a{drive, skip, out, nullptr, t_total, n, chain_len, lam, theta, soft, 0, vec, 0};
  cudaError_t err = check_body(a, bf16 ? 2 : 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    fwd_vec<false, __nv_bfloat16>(a, s);
  } else {
    fwd_vec<false, float>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// occ == nullptr: no occupancy map (occ_cols is ignored).  Otherwise occ holds
// ceil(T/32) * (n / occ_cols) * ceil(occ_cols / 128) counts, every one of them
// written here: stored by the warps where occ_warp != 0, else zeroed on the
// stream and summed into by atomics.  bf16 != 0: the drive is bf16; otherwise
// f32.  vec, occ_warp: the body (see check_body).
extern "C" int lif_parallel_pack_fwd(const void* drive, const void* skip_words,
                                     void* out_words, void* occ, int t_total, int n,
                                     int chain_len, float lam, float theta, int soft,
                                     int occ_cols, int bf16, int vec, int occ_warp,
                                     void* stream) {
  const FwdArgs a{drive, skip_words, out_words, static_cast<uint32_t*>(occ), t_total, n,
                  chain_len, lam, theta, soft, occ_cols, vec, occ_warp};
  if (occ != nullptr && (occ_cols < 1 || n % occ_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = check_body(a, bf16 ? 2 : 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  if (occ != nullptr && !occ_warp) {
    const size_t tiles = static_cast<size_t>((t_total + 31) / 32) * (n / occ_cols) *
                         ((occ_cols + kOccTile - 1) / kOccTile);
    err = cudaMemsetAsync(occ, 0, tiles * sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (bf16) {
    fwd_vec<true, __nv_bfloat16>(a, s);
  } else {
    fwd_vec<true, float>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
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
