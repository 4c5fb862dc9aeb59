// Tick-batched softmax-free spiking self-attention: out = (q k^T) v * scale.
//
// Three entry points on three tensor-core kernels (the third for D > 128):
//
//   ssa_fwd               dense f32 spikes   ssa_tc_kernel<Dp, W>,
//                                            ssa_wide_tc_kernel<DQ, false, false>
//     Replaces: src/repro/kernels/spiking_attention/kernel.py::ssa_fwd
//               (body ssa_kernel).
//   packed_ssa_fwd        packed words       packed_ssa_tc_kernel<Dp, P, false>,
//                                            ssa_wide_tc_kernel<DQ, true, false>
//     Replaces: src/repro/kernels/spiking_attention/kernel.py::packed_ssa_fwd
//               (body packed_ssa_kernel).
//   sparse_packed_ssa_fwd packed words,      packed_ssa_tc_kernel<Dp, P, true>,
//                         plane-gated        ssa_wide_tc_kernel<DQ, true, true>
//     Replaces: src/repro/kernels/spiking_attention/kernel.py::sparse_packed_ssa_fwd
//               (body sparse_packed_ssa_kernel).
//
// Layouts.  Dense: q (G, N, D), k and v (G, M, D), out (G, N, D), G = T*B*H
// folds time, batch and heads, so all T time steps ride one launch.  Packed:
// q words (W, G, N, D), k and v words (W, G, M, D), G = B*H, bit t % 32 of
// word t / 32 the spike at time step t -> out (T, G, N, D) f32.  There is no
// softmax; with causal != 0 the scores of keys after the query (global
// indices, key > query) are zeroed.  The gated kernel also takes a (G, T)
// int32 liveness map, live[g][t] != 0 iff the q, k and v planes t of fold g
// each carry a spike; a dead plane's output is zero.
//
// Operand contract and exactness.  q, k and v are spikes in {0, 1} (every
// caller passes LIF outputs) and D <= 512.  Then {0, 1} is exact in f16; a
// score q.k is an integer <= D <= 512, exact in f16 (integers up to 2048
// are).  The keys are summed in ranges of R keys (key_range: R = M while
// M*D < 2^24, else the largest multiple of 64 with R*D < 2^24), ascending:
// every partial sum of S v within a range is an integer <= R*D < 2^24, exact
// in an f32 accumulator whatever the order of the tensor cores' additions;
// each range's partial, from zero, is then added into the output (held in
// the output tensor between ranges, unscaled) with one f32 rounding; and the
// final multiply by scale rounds once.  The plain version sums the same
// ranges in the same order, so the f16 products with f32 accumulation below
// equal it bit for bit at any M (below the 2^24 edge there is one range and
// no rounding at all).  Each kernel has a last template flag kSplit: the
// range loop's instantiation, launched only past the edge, and the one-range
// one, whose code and registers are those of a kernel without ranges.  The causal mask reads absolute key positions in
// every range.  Outside that contract (non-binary operands) the f16 rounding
// of the operands and scores shows, and the result is not the plain
// version's.  The shape half of the contract is checked: the entry points
// return cudaErrorInvalidValue for D > 512 (the Python wrappers raise
// ValueError first).
//
// Bound on this card: device bytes.  With binary operands the two products
// run on the f16 tensor cores (989 TFLOP/s dense); at the main path's shape
// (G = 384, N = M = 196, D = 32) a dense launch does 1.9 GFLOP (0.002 ms)
// against 38.5 MB of f32 q, k, v and out (0.011 ms at 3.35 TB/s); a packed
// launch moves 7.2 MB of words and 9.6 MB of f32 output (0.005 ms).  At the
// spiking LM's (llama3.2-1b width, Dh = 512, G = T*B*H = 64, causal) the work
// is larger but the bound is still bytes up to a few thousand tokens.
//
// Tensor-core design (ssa_tc_kernel, packed_ssa_tc_kernel).  One block of W
// warps per (fold g, tile of 16W query rows[, group of P planes]); warp w owns
// query rows 16w..16w+15 of the tile and holds their A fragments in registers
// for the whole key loop, loaded once straight from device memory (8-byte
// pairs).  The block walks the keys in tiles of 64, staged in shared memory
// by all its threads, and each warp walks a tile in chunks of 16 keys:
//   S (16 x 16)  = Q (16 x Dp) K_chunk^T     mma.m16n8k16, Dp/16 k-steps x 2 n8 tiles
//   O (16 x Dp) += S (16 x 16) V_chunk       mma.m16n8k16, Dp/8 n8 tiles
// with Dp = D rounded up to 16, 32, 64 or 128 (features past D load as 0).
// The m16n8k16 fragments (groupID g = lane / 4, t4 = lane % 4): A holds rows
// g and g + 8 at columns 2*t4, 2*t4 + 1 (a0, a1) and those + 8 (a2, a3); B
// holds column (n) g at rows (k) 2*t4, 2*t4 + 1 (b0) and those + 8 (b1); C
// holds rows g (c0, c1) and g + 8 (c2, c3) at columns 2*t4, 2*t4 + 1.  So the
// C fragments of S's two n8 tiles are, converted to f16 in registers, the A
// fragment of the k16 step of S V (the FlashAttention-2 layout trick): S
// never touches shared memory, and with no softmax nothing is rescaled.  The
// causal mask zeroes S entries before that conversion; a warp stops at the
// first chunk past its last query row, and the key loop ends at the tile's
// last row.  Rows and features past the operands load as zeros (they add
// exactly 0) and the stores are masked; the epilogue multiplies by scale and
// stores float2 pairs where D is even.
//
// Dense (ssa_tc_kernel<Dp, W>): W = 16 warps past 64 tokens, so that a block
// stages each key tile once for all of a fold's query rows (N = 196: one block
// per fold, a quarter of the key and value reads of 64-row blocks), else W = 4.
// k and v are read as f32 (float4 loads where D % 4 == 0 and the pointers are
// 16-byte aligned), converted to f16 in registers (cp.async cannot convert) and
// stored in shared memory rows padded by 8 halfs, so the 8 rows of an ldmatrix
// phase land on distinct banks; K fragments come from ldmatrix, V's from
// ldmatrix.trans.
//
// Wide (ssa_wide_tc_kernel<DQ, kPacked, kGated>, 128 < D <= 512, DQ = 256 or
// 512): a warp's 16 x D output tile would need 4*D/8 f32 registers and its q
// fragments another D/4, too many past D = 128.  So the grid gets an axis over
// 128-feature slabs of the output (and, packed, over the T planes: grid z is
// plane * slabs + slab), and each block computes the full-width S = Q K^T of
// its 64 query rows for every key chunk, then S V[:, slab]: S is recomputed
// once per slab (4x the Q K^T work at D = 512).  Q (64 rows), the key tile
// (32 keys) and the slab of the value tile go through shared memory as f16
// rows padded by 8 halfs -- dense spikes converted from f32, packed ones built
// from the block's plane of the words (one plane a block, 0x3C00 per set bit)
// -- and every fragment comes from ldmatrix; 108.5 KB at DQ = 512, two blocks
// an SM.  A gated block whose plane is dead writes its slab's zeros and
// returns.  The arithmetic of an output element is the narrow kernels' (S in
// f32 over 16-feature steps, rounded to f16, O in f32 over 16-key steps), so
// the exactness argument above is unchanged.
//
// Packed (packed_ssa_tc_kernel<Dp, P, kGated>, W = 4 warps): one kernel for both
// packed entry points; kGated = false is packed_ssa_fwd (every plane computed),
// kGated = true sparse_packed_ssa_fwd.  The q words and the k and v word tiles are
// read once per block and serve all P planes of the group (P = 4, 4, 2, 1 for Dp =
// 16, 32, 64, 128, so that P q-fragment sets and P output tiles fit in registers;
// P divides 32, so a group never straddles two words, and T > 32 walks the words
// by blockIdx.z).  Fragments are built straight from the bits: an f16 1.0 is
// 0x3C00, so with the words of the two f16 lanes of a register merged as (w0 >>
// bit0) & 0xFFFF | (w1 >> bit0) << 16, plane p's register is ((merged >> p) &
// 0x00010001) * 0x3C00.  B of S (k, keys) reads a register's two words as one
// 64-bit load from rows padded to Dp + 8 words; B of S V (v, two key rows per
// register) reads two 32-bit words from rows padded to Dp + 4 words; both
// paddings keep a warp's reads on distinct banks.  W = 4: at P = 4 a thread
// holds ~160 registers, so that 4 warps a block keep three blocks resident on
// an SM.  Planes at or past T (the last group of a T that P does not divide)
// are neither computed nor stored.  With kGated a block first reads its P
// liveness flags (the same in every thread, so every branch on them is
// uniform): when all are dead it writes its zero tiles and returns before it
// reads any word; in a live group a dead plane's MMAs are skipped and it is
// written as zero.  A dead plane's output is exactly zero in the ungated
// computation too (one of its two products has an all-zero operand), so the
// gated result equals the ungated one bit for bit.  Without kGated the liveness
// pointer is never read (packed_ssa_fwd passes none) and the plane mask holds
// exactly the planes below T.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 512;
constexpr long long kMaxSum = 1LL << 24;  // R * D stays below: sums of S v exact in f32

// ---- tensor-core kernels ----------------------------------------------------

constexpr int kPackedWarps = 4;  // warps of 16 query rows per block of the packed kernel
constexpr int kKeys = 64;  // keys per staged tile (a multiple of the wide kernel's)

// Keys per range of the S v sum (the header's exactness argument): all M
// while M * D < 2^24, else the largest multiple of kKeys whose sums stay
// below 2^24.  kernels/spiking_attention/ref.py::key_range is the same.
int key_range(int m, int d) {
  if (static_cast<long long>(m) * d < kMaxSum) return m;
  return static_cast<int>((kMaxSum - 1) / d / kKeys * kKeys);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const auto s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const auto s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t pack_half2(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The two f16 lanes' words of a register, shifted to the group's first bit:
// plane p sits at bits p and 16 + p.
__device__ __forceinline__ uint32_t merge_words(uint32_t w0, uint32_t w1, int bit0) {
  return ((w0 >> bit0) & 0xFFFFu) | ((w1 >> bit0) << 16);
}

// Plane p of a merged register as f16 lanes: 1.0 (0x3C00) where the bit is set.
__device__ __forceinline__ uint32_t plane_half2(uint32_t merged, int p) {
  return ((merged >> p) & 0x00010001u) * 0x3C00u;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ uint2 load2(const uint32_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// Elements (row, f) and (row, f + 1) of a (rows, d) matrix, zero past it;
// pair: one 8-byte load (d even, src 8-byte aligned).
template <typename T>
__device__ __forceinline__ void load_pair(T& x0, T& x1, const T* src, int row, int rows,
                                          int f, int d, bool pair) {
  x0 = x1 = T(0);
  if (row >= rows || f >= d) return;
  const T* p = src + static_cast<long long>(row) * d + f;
  if (pair) {
    const auto both = load2(p);
    x0 = both.x;
    x1 = both.y;
  } else {
    x0 = p[0];
    if (f + 1 < d) x1 = p[1];
  }
}

// S (two n8 tiles of one 16-key chunk) with the causal mask applied, as the
// A fragment of the k16 step of S V.  Row of c0/c1: row0 + g, of c2/c3: + 8;
// column of c0 in tile j: key0 + 8j + 2*t4.
__device__ __forceinline__ void scores_to_a(uint32_t (&a)[4], float (&s)[2][4], bool causal,
                                            int row0, int key0, int lane) {
  if (causal) {
    const int r = row0 + (lane >> 2), c = key0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + 8 * j + (e & 1) > r + 8 * (e >> 1)) s[j][e] = 0.0f;
      }
    }
  }
  a[0] = pack_half2(s[0][0], s[0][1]);
  a[1] = pack_half2(s[0][2], s[0][3]);
  a[2] = pack_half2(s[1][0], s[1][1]);
  a[3] = pack_half2(s[1][2], s[1][3]);
}

// Rows row0 .. row0 + ROWS - 1, features f0 .. f0 + DP - 1 of a (rows_total,
// d) f32 matrix as f16 into dst[ROWS][LD], zero past the matrix, by THREADS
// threads; vec: d % 4 == 0, f0 % 4 == 0 and src 16-byte aligned.
template <int DP, int LD, int THREADS, int ROWS = kKeys>
__device__ __forceinline__ void stage_f16(__half* dst, const float* src, int row0,
                                          int rows_total, int d, bool vec, int f0 = 0) {
  constexpr int kChunks = DP / 4;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += THREADS) {
    const int r = c / kChunks, f = (c % kChunks) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < rows_total && f0 + f < d) {
      const float* p = src + static_cast<long long>(row0 + r) * d + f0 + f;
      if (vec) {
        x = *reinterpret_cast<const float4*>(p);
      } else {
        x.x = p[0];
        if (f0 + f + 1 < d) x.y = p[1];
        if (f0 + f + 2 < d) x.z = p[2];
        if (f0 + f + 3 < d) x.w = p[3];
      }
    }
    auto* o = reinterpret_cast<__half2*>(dst + r * LD + f);
    o[0] = __floats2half2_rn(x.x, x.y);
    o[1] = __floats2half2_rn(x.z, x.w);
  }
}

// The same for (rows_total, d) words into dst[kKeys][LD] words.
template <int DP, int LD, int THREADS>
__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* src, int row0,
                                            int rows_total, int d, bool vec) {
  constexpr int kChunks = DP / 4;
  for (int c = threadIdx.x; c < kKeys * kChunks; c += THREADS) {
    const int r = c / kChunks, f = (c % kChunks) * 4;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows_total && f < d) {
      const uint32_t* p = src + static_cast<long long>(row0 + r) * d + f;
      if (vec) {
        x = *reinterpret_cast<const uint4*>(p);
      } else {
        x.x = p[0];
        if (f + 1 < d) x.y = p[1];
        if (f + 2 < d) x.z = p[2];
        if (f + 3 < d) x.w = p[3];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + f) = x;
  }
}

// Bit plane `bit` of the words at rows row0 .. row0 + ROWS - 1, features f0 ..
// f0 + DP - 1 of a (rows_total, d) word matrix as f16 (1.0 is 0x3C00) into
// dst[ROWS][LD], zero past the matrix, by THREADS threads; vec as stage_f16.
template <int DP, int LD, int THREADS, int ROWS>
__device__ __forceinline__ void stage_plane_f16(__half* dst, const uint32_t* src, int row0,
                                                int rows_total, int d, bool vec, int f0,
                                                int bit) {
  constexpr int kChunks = DP / 4;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += THREADS) {
    const int r = c / kChunks, f = (c % kChunks) * 4;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows_total && f0 + f < d) {
      const uint32_t* p = src + static_cast<long long>(row0 + r) * d + f0 + f;
      if (vec) {
        x = *reinterpret_cast<const uint4*>(p);
      } else {
        x.x = p[0];
        if (f0 + f + 1 < d) x.y = p[1];
        if (f0 + f + 2 < d) x.z = p[2];
        if (f0 + f + 3 < d) x.w = p[3];
      }
    }
    *reinterpret_cast<uint2*>(dst + r * LD + f) =
        make_uint2(plane_half2(merge_words(x.x, x.y, bit), 0),
                   plane_half2(merge_words(x.z, x.w, bit), 0));
  }
}

// One warp's 16 x Dp output tile, times scale, into og (n, d); pair: float2
// loads and stores (d even, og 8-byte aligned).  Features from f0 on (a slab
// of the wide kernel).  add: the tile is first added to what og holds, the
// unscaled sum of the earlier key ranges (each thread reads back only what it
// wrote itself).
template <int NT>
__device__ __forceinline__ void store_tile(float* og, const float (&o)[NT][4], int row0, int n,
                                           int d, float scale, bool pair, int lane, int f0,
                                           bool add) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int f = f0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + (lane >> 2) + 8 * h;
      if (row >= n || f >= d) continue;
      float* p = og + static_cast<long long>(row) * d + f;
      float x0 = o[j][2 * h], x1 = o[j][2 * h + 1];
      if (add) {
        float y0, y1 = 0.0f;
        if (pair) {
          const float2 y = load2(p);
          y0 = y.x;
          y1 = y.y;
        } else {
          y0 = p[0];
          if (f + 1 < d) y1 = p[1];
        }
        x0 = __fadd_rn(y0, x0);
        x1 = __fadd_rn(y1, x1);
      }
      x0 = __fmul_rn(x0, scale);
      x1 = __fmul_rn(x1, scale);
      if (pair) {
        *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
      } else {
        p[0] = x0;
        if (f + 1 < d) p[1] = x1;
      }
    }
  }
}

// WARPS warps of 16 query rows each per block.  kSplit: the keys are summed
// in ranges of `range` (M * D >= 2^24); otherwise in one, and `range` is unused.
template <int DP, int WARPS, bool kSplit>
__global__ void __launch_bounds__(32 * WARPS)
ssa_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int n, int m, int d,
              int range, float scale, int causal, int vec, int pair) {
  constexpr int LD = DP + 8;   // halfs: 16-byte row pad, conflict-free ldmatrix
  constexpr int KS = DP / 16;  // k16 steps of Q K^T
  constexpr int NT = DP / 8;   // n8 tiles of O
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __half* ks = reinterpret_cast<__half*>(tc_smem);  // [kKeys][LD]
  __half* vs = ks + kKeys * LD;                      // [kKeys][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t4 = lane & 3;
  const long long g = blockIdx.x;
  const int q0 = blockIdx.y * 16 * WARPS;
  const int row0 = q0 + 16 * warp;
  const float* qg = q + g * n * d;
  const float* kg = k + g * m * d;
  const float* vg = v + g * m * d;

  // A fragments of the warp's 16 query rows, straight from device memory:
  // a_i holds row g (+8 for odd i) at features 16st + 2*t4 (+8 for i >= 2)
  uint32_t qf[KS][4];
#pragma unroll
  for (int st = 0; st < KS; ++st) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x0, x1;
      load_pair(x0, x1, qg, row0 + gid + 8 * (i & 1), n, 16 * st + 8 * (i >> 1) + 2 * t4, d,
                vec);
      qf[st][i] = pack_half2(x0, x1);
    }
  }

  const int kv_end = causal ? min(m, q0 + 16 * WARPS) : m;
  const int warp_end = row0 >= n ? 0 : causal ? min(kv_end, row0 + 16) : kv_end;
  for (int r0 = 0;; r0 += range) {  // key ranges, ascending: exact sums in each
    const int r1 = kSplit ? min(kv_end, r0 + range) : kv_end;
    float o[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    for (int kv0 = r0; kv0 < r1; kv0 += kKeys) {
      __syncthreads();  // every warp is done with the previous tile
      stage_f16<DP, LD, 32 * WARPS>(ks, kg, kv0, m, d, vec);
      stage_f16<DP, LD, 32 * WARPS>(vs, vg, kv0, m, d, vec);
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kKeys / 16; ++c) {
        const int key0 = kv0 + 16 * c;
        if (key0 >= warp_end) break;  // warp-uniform: past the keys or the warp's last row
        float s[2][4] = {};
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          uint32_t b[4];  // keys 16c + (0..7 | 8..15) x features 16st + (0..7 | 8..15)
          ldsm_x4(b, ks + (16 * c + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * st +
                         8 * ((lane >> 3) & 1));
          mma_16816(s[0], qf[st], b[0], b[1]);
          mma_16816(s[1], qf[st], b[2], b[3]);
        }
        uint32_t a[4];
        scores_to_a(a, s, causal, row0, key0, lane);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t b[4];  // V rows 16c + (0..7 | 8..15), features 16j + (0..7 | 8..15)
          ldsm_x4_trans(b, vs + (16 * c + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 16 * j +
                               8 * (lane >> 4));
          mma_16816(o[2 * j], a, b[0], b[1]);
          mma_16816(o[2 * j + 1], a, b[2], b[3]);
        }
      }
    }
    const bool last = !kSplit || r1 >= kv_end;
    store_tile<NT>(out + g * n * d, o, row0, n, d, last ? scale : 1.0f, pair, lane, 0,
                   kSplit && r0 > 0);
    if (last) break;
  }
}

template <int DP>
__host__ __device__ constexpr int planes_per_block() {
  return DP <= 32 ? 4 : DP == 64 ? 2 : 1;
}

template <int DP>
__host__ __device__ constexpr int packed_tc_smem_bytes() {
  return 4 * kKeys * ((DP + 8) + (DP + 4));
}

// kPackedWarps warps of 16 query rows each and P planes (P divides 32) per
// block.  kGated: live holds the (G, T) plane liveness, and dead planes are
// skipped; otherwise live is unused and every plane is computed.
template <int DP, int P, bool kGated, bool kSplit>
__global__ void __launch_bounds__(32 * kPackedWarps)
packed_ssa_tc_kernel(const uint32_t* __restrict__ qw, const uint32_t* __restrict__ kw,
                     const uint32_t* __restrict__ vw, const int* __restrict__ live,
                     float* __restrict__ out, int g_total, int n, int m, int d, int t_total,
                     int range, float scale, int causal, int vec, int pair) {
  constexpr int LDK = DP + 8;  // words: 64-bit reads of rows g at 8-bank steps
  constexpr int LDV = DP + 4;  // words: 32-bit reads of rows 2*t4 (+1) at 8-bank steps
  constexpr int KS = DP / 16;
  constexpr int NT = DP / 8;
  constexpr int WARPS = kPackedWarps;
  extern __shared__ __align__(16) uint32_t tc_words[];
  uint32_t* ks = tc_words;          // [kKeys][LDK]
  uint32_t* vs = ks + kKeys * LDK;  // [kKeys][LDV]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t4 = lane & 3;
  const long long g = blockIdx.x;
  const int q0 = blockIdx.y * 16 * WARPS;
  const int row0 = q0 + 16 * warp;
  const int p0 = blockIdx.z * P, bit0 = p0 & 31;
  const long long plane = static_cast<long long>(p0 >> 5) * g_total + g;  // (word, fold)
  const uint32_t* qg = qw + plane * n * d;
  const uint32_t* kg = kw + plane * m * d;
  const uint32_t* vg = vw + plane * m * d;

  unsigned live_mask = 0u;  // bit p: plane p0 + p is computed
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p0 + p < t_total && (!kGated || live[g * t_total + p0 + p] != 0)) live_mask |= 1u << p;
  }
  if (live_mask == 0u) {  // every plane of the group is dead: zeros, no staging
    const int count = min(16 * WARPS, n - q0) * d;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p0 + p >= t_total) break;
      float* og = out + ((static_cast<long long>(p0 + p) * g_total + g) * n + q0) * d;
      for (int e = threadIdx.x; e < count; e += 32 * WARPS) og[e] = 0.0f;
    }
    return;
  }

  // A fragments of every plane, straight from the warp's q words
  uint32_t qf[P][KS][4];
#pragma unroll
  for (int st = 0; st < KS; ++st) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a_i: row g (+8 for odd i), features +8 for i >= 2
      uint32_t w0, w1;
      load_pair(w0, w1, qg, row0 + gid + 8 * (i & 1), n, 16 * st + 8 * (i >> 1) + 2 * t4, d,
                vec);
      const uint32_t merged = merge_words(w0, w1, bit0);
#pragma unroll
      for (int p = 0; p < P; ++p) qf[p][st][i] = plane_half2(merged, p);
    }
  }

  const int kv_end = causal ? min(m, q0 + 16 * WARPS) : m;
  const int warp_end = row0 >= n ? 0 : causal ? min(kv_end, row0 + 16) : kv_end;
  for (int r0 = 0;; r0 += range) {  // key ranges, ascending: exact sums in each
    const int r1 = kSplit ? min(kv_end, r0 + range) : kv_end;
    float o[P][NT][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < NT; ++j) o[p][j][0] = o[p][j][1] = o[p][j][2] = o[p][j][3] = 0.0f;
    for (int kv0 = r0; kv0 < r1; kv0 += kKeys) {
      __syncthreads();  // every warp is done with the previous tile
      stage_words<DP, LDK, 32 * WARPS>(ks, kg, kv0, m, d, vec);
      stage_words<DP, LDV, 32 * WARPS>(vs, vg, kv0, m, d, vec);
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kKeys / 16; ++c) {
        const int key0 = kv0 + 16 * c;
        if (key0 >= warp_end) break;  // warp-uniform: past the keys or the warp's last row
        float s[P][2][4] = {};
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          uint32_t kb[2][2];  // n8 tile j (keys 16c + 8j + g), b0/b1 (features +0 / +8)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint2 w = *reinterpret_cast<const uint2*>(
                  ks + (16 * c + 8 * j + gid) * LDK + 16 * st + 8 * h + 2 * t4);
              kb[j][h] = merge_words(w.x, w.y, bit0);
            }
          }
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if (!((live_mask >> p) & 1u)) continue;
            mma_16816(s[p][0], qf[p][st], plane_half2(kb[0][0], p), plane_half2(kb[0][1], p));
            mma_16816(s[p][1], qf[p][st], plane_half2(kb[1][0], p), plane_half2(kb[1][1], p));
          }
        }
        uint32_t a[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p) scores_to_a(a[p], s[p], causal, row0, key0, lane);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t vb[2];  // b0/b1: keys 16c + 2*t4 (+1), and + 8; feature 8j + g
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t* r = vs + (16 * c + 8 * h + 2 * t4) * LDV + 8 * j + gid;
            vb[h] = merge_words(r[0], r[LDV], bit0);
          }
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if (!((live_mask >> p) & 1u)) continue;
            mma_16816(o[p][j], a[p], plane_half2(vb[0], p), plane_half2(vb[1], p));
          }
        }
      }
    }
    const bool last = !kSplit || r1 >= kv_end;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p0 + p >= t_total) break;
      store_tile<NT>(out + (static_cast<long long>(p0 + p) * g_total + g) * n * d, o[p], row0, n,
                     d, last ? scale : 1.0f, pair, lane, 0, kSplit && r0 > 0);
    }
    if (last) break;
  }
}

// ---- head dims past 128 -------------------------------------------------------

constexpr int kWideWarps = 4;    // warps of 16 query rows per block of the wide kernel
constexpr int kWideKeys = 32;    // keys per staged tile of the wide kernel
constexpr int kSlab = 128;       // output features per block of the wide kernel

template <int DQ>
__host__ __device__ constexpr int wide_smem_bytes() {
  return 2 * ((16 * kWideWarps + kWideKeys) * (DQ + 8) + kWideKeys * (kSlab + 8));
}

// Rows r0 .. r0 + R - 1, features f0 .. f0 + W - 1 of fold (or word plane and
// fold) `base` of an (rows_total, d) operand as f16: f32 spikes, or bit `bit`
// of words.
template <bool kPacked, int W, int LD, int THREADS, int R>
__device__ __forceinline__ void stage_operand(__half* dst, const void* src, long long base,
                                              int r0, int rows_total, int d, bool vec, int f0,
                                              int bit) {
  if constexpr (kPacked) {
    stage_plane_f16<W, LD, THREADS, R>(
        dst, static_cast<const uint32_t*>(src) + base * rows_total * d, r0, rows_total, d, vec,
        f0, bit);
  } else {
    stage_f16<W, LD, THREADS, R>(dst, static_cast<const float*>(src) + base * rows_total * d,
                                 r0, rows_total, d, vec, f0);
  }
}

// One kernel for all three entry points at 128 < D <= DQ.  Grid (fold, tile of
// 64 query rows, plane * slabs + slab): a block computes the full-width scores
// S = Q K^T of its rows and then S V for one 128-feature slab of the output,
// so S is recomputed once per slab.  kPacked: q, k and v are words, and the
// block's plane (blockIdx.z / slabs) is staged as f16 from the bits; with
// kGated a dead plane's slab is written as zeros.  Dense: plane 0, f32 spikes
// staged as f16.  Q, K and V go through shared memory as f16 rows padded by 8
// halfs, and every fragment comes from ldmatrix (.trans for V).
template <int DQ, bool kPacked, bool kGated, bool kSplit>
__global__ void __launch_bounds__(32 * kWideWarps)
ssa_wide_tc_kernel(const void* __restrict__ qv, const void* __restrict__ kv,
                   const void* __restrict__ vv, const int* __restrict__ live,
                   float* __restrict__ out, int g_total, int n, int m, int d, int t_total,
                   int slabs, int range, float scale, int causal, int vec, int pair) {
  constexpr int LDQ = DQ + 8;      // halfs, q and k rows
  constexpr int LDV = kSlab + 8;   // halfs, v rows
  constexpr int KS = DQ / 16;
  constexpr int NT = kSlab / 8;
  constexpr int ROWS = 16 * kWideWarps;
  constexpr int THREADS = 32 * kWideWarps;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __half* qs = reinterpret_cast<__half*>(tc_smem);  // [ROWS][LDQ]
  __half* ks = qs + ROWS * LDQ;                      // [kWideKeys][LDQ]
  __half* vs = ks + kWideKeys * LDQ;                 // [kWideKeys][LDV]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = blockIdx.x;
  const int q0 = blockIdx.y * ROWS;
  const int row0 = q0 + 16 * warp;
  const int plane = blockIdx.z / slabs, f0 = (blockIdx.z % slabs) * kSlab;
  const long long base = kPacked ? static_cast<long long>(plane >> 5) * g_total + g : g;
  float* og = out + (static_cast<long long>(plane) * g_total + g) * n * d;

  if (kGated && live[g * t_total + plane] == 0) {  // a dead plane: its slab is zero
    const int rows = min(ROWS, n - q0), cols = min(kSlab, d - f0);
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      og[static_cast<long long>(q0 + e / cols) * d + f0 + e % cols] = 0.0f;
    }
    return;
  }
  const int bit = plane & 31;
  stage_operand<kPacked, DQ, LDQ, THREADS, ROWS>(qs, qv, base, q0, n, d, vec, 0, bit);

  const int kv_end = causal ? min(m, q0 + ROWS) : m;
  const int warp_end = row0 >= n ? 0 : causal ? min(kv_end, row0 + 16) : kv_end;
  for (int r0 = 0;; r0 += range) {  // key ranges, ascending: exact sums in each
    const int r1 = kSplit ? min(kv_end, r0 + range) : kv_end;
    float o[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    for (int kv0 = r0; kv0 < r1; kv0 += kWideKeys) {
      __syncthreads();  // q staged; every warp is done with the previous tile
      stage_operand<kPacked, DQ, LDQ, THREADS, kWideKeys>(ks, kv, base, kv0, m, d, vec, 0, bit);
      stage_operand<kPacked, kSlab, LDV, THREADS, kWideKeys>(vs, vv, base, kv0, m, d, vec, f0, bit);
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kWideKeys / 16; ++c) {
        const int key0 = kv0 + 16 * c;
        if (key0 >= warp_end) break;  // warp-uniform: past the keys or the warp's last row
        float s[2][4] = {};
#pragma unroll 4
        for (int st = 0; st < KS; ++st) {
          uint32_t a[4], b[4];  // a: rows 16w + (0..15), features 16st + (0..7 | 8..15)
          ldsm_x4(a, qs + (16 * warp + (lane & 15)) * LDQ + 16 * st + 8 * (lane >> 4));
          ldsm_x4(b, ks + (16 * c + (lane & 7) + 8 * (lane >> 4)) * LDQ + 16 * st +
                         8 * ((lane >> 3) & 1));
          mma_16816(s[0], a, b[0], b[1]);
          mma_16816(s[1], a, b[2], b[3]);
        }
        uint32_t a[4];
        scores_to_a(a, s, causal, row0, key0, lane);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t b[4];  // V rows 16c + (0..7 | 8..15), slab features 16j + (0..7 | 8..15)
          ldsm_x4_trans(b, vs + (16 * c + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDV + 16 * j +
                               8 * (lane >> 4));
          mma_16816(o[2 * j], a, b[0], b[1]);
          mma_16816(o[2 * j + 1], a, b[2], b[3]);
        }
      }
    }
    const bool last = !kSplit || r1 >= kv_end;
    store_tile<NT>(og, o, row0, n, d, last ? scale : 1.0f, pair, lane, f0, kSplit && r0 > 0);
    if (last) break;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DP, int WARPS, bool kSplit>
int launch_dense(const float* q, const float* k, const float* v, float* out, int g, int n,
                 int m, int d, float scale, int causal, cudaStream_t stream) {
  const size_t smem = 2 * kKeys * (DP + 8) * sizeof(__half);
  const cudaError_t err = allow_smem(ssa_tc_kernel<DP, WARPS, kSplit>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = d % 4 == 0 && aligned(q, 16) && aligned(k, 16) && aligned(v, 16);
  const int pair = d % 2 == 0 && aligned(out, 8);
  const dim3 grid(static_cast<unsigned>(g),
                  static_cast<unsigned>((n + 16 * WARPS - 1) / (16 * WARPS)));
  ssa_tc_kernel<DP, WARPS, kSplit><<<grid, 32 * WARPS, smem, stream>>>(
      q, k, v, out, n, m, d, key_range(m, d), scale, causal, vec, pair);
  return static_cast<int>(cudaGetLastError());
}

// Past 64 tokens the dense kernel's block covers 256 query rows (16 warps), so
// that a block stages a fold's keys once for all its rows (the ImageNet
// configs' 196 tokens).  Up to 64 tokens (the CIFAR configs) a block of 4
// warps holds every row and eight such blocks fit an SM against two of 16
// warps: at G = 384, N = 64, Dh = 32 (slot batch 8) they take 4.7 us of device
// time against 6.0 us on an H100 (src/repro_torch/launch/timing.py).
template <int DP, bool kSplit>
int launch_dense_rows(const float* q, const float* k, const float* v, float* out, int g, int n,
                      int m, int d, float scale, int causal, cudaStream_t stream) {
  if (n <= 64) return launch_dense<DP, 4, kSplit>(q, k, v, out, g, n, m, d, scale, causal, stream);
  return launch_dense<DP, 16, kSplit>(q, k, v, out, g, n, m, d, scale, causal, stream);
}

// Past the 2^24 edge (key_range < M) the kernels' range-split instantiation;
// below it the one-range instantiation, whose code is the loop without ranges.
template <int DP>
int launch_dense_split(const float* q, const float* k, const float* v, float* out, int g,
                       int n, int m, int d, float scale, int causal, cudaStream_t stream) {
  if (key_range(m, d) < m) {
    return launch_dense_rows<DP, true>(q, k, v, out, g, n, m, d, scale, causal, stream);
  }
  return launch_dense_rows<DP, false>(q, k, v, out, g, n, m, d, scale, causal, stream);
}

template <int DP, bool kGated, bool kSplit>
int launch_packed_tc(const uint32_t* qw, const uint32_t* kw, const uint32_t* vw,
                     const int* live, float* out, int g, int n, int m, int d, int t_total,
                     float scale, int causal, cudaStream_t stream) {
  constexpr int P = planes_per_block<DP>();
  const size_t smem = packed_tc_smem_bytes<DP>();
  const cudaError_t err = allow_smem(packed_ssa_tc_kernel<DP, P, kGated, kSplit>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = d % 4 == 0 && aligned(qw, 16) && aligned(kw, 16) && aligned(vw, 16);
  const int pair = d % 2 == 0 && aligned(out, 8);
  const dim3 grid(static_cast<unsigned>(g),
                  static_cast<unsigned>((n + 16 * kPackedWarps - 1) / (16 * kPackedWarps)),
                  static_cast<unsigned>((t_total + P - 1) / P));
  packed_ssa_tc_kernel<DP, P, kGated, kSplit><<<grid, 32 * kPackedWarps, smem, stream>>>(
      qw, kw, vw, live, out, g, n, m, d, t_total, key_range(m, d), scale, causal, vec, pair);
  return static_cast<int>(cudaGetLastError());
}

// Past D = 128: ssa_wide_tc_kernel, D rounded up to 256 or 512 for the scores.
template <bool kPacked, bool kGated, bool kSplit>
int launch_wide(const void* q, const void* k, const void* v, const int* live, float* out, int g,
                int n, int m, int d, int t_total, float scale, int causal, cudaStream_t stream) {
  const auto kernel = d <= 256 ? ssa_wide_tc_kernel<256, kPacked, kGated, kSplit>
                               : ssa_wide_tc_kernel<512, kPacked, kGated, kSplit>;
  const size_t smem = d <= 256 ? wide_smem_bytes<256>() : wide_smem_bytes<512>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = d % 4 == 0 && aligned(q, 16) && aligned(k, 16) && aligned(v, 16);
  const int pair = d % 2 == 0 && aligned(out, 8);
  const int slabs = (d + kSlab - 1) / kSlab;
  const dim3 grid(static_cast<unsigned>(g),
                  static_cast<unsigned>((n + 16 * kWideWarps - 1) / (16 * kWideWarps)),
                  static_cast<unsigned>((kPacked ? t_total : 1) * slabs));
  kernel<<<grid, 32 * kWideWarps, smem, stream>>>(q, k, v, live, out, g, n, m, d, t_total, slabs,
                                                  key_range(m, d), scale, causal, vec, pair);
  return static_cast<int>(cudaGetLastError());
}

// The operand contract's shape half (see the header): 1 <= D <= 512 (every
// score exact in f16, and the wide kernel's shared memory) and M >= 1.
// Operands past it are refused.
bool exact_shape(int m, int d) { return d >= 1 && d <= kMaxD && m >= 1; }

template <bool kGated, bool kSplit>
int launch_packed_dp(const uint32_t* q, const uint32_t* k, const uint32_t* v, const int* lv,
                     float* o, int g, int n, int m, int d, int t_total, float scale, int causal,
                     cudaStream_t s) {
  if (d <= 16) return launch_packed_tc<16, kGated, kSplit>(q, k, v, lv, o, g, n, m, d, t_total, scale, causal, s);
  if (d <= 32) return launch_packed_tc<32, kGated, kSplit>(q, k, v, lv, o, g, n, m, d, t_total, scale, causal, s);
  if (d <= 64) return launch_packed_tc<64, kGated, kSplit>(q, k, v, lv, o, g, n, m, d, t_total, scale, causal, s);
  if (d <= 128) return launch_packed_tc<128, kGated, kSplit>(q, k, v, lv, o, g, n, m, d, t_total, scale, causal, s);
  return launch_wide<true, kGated, kSplit>(q, k, v, lv, o, g, n, m, d, t_total, scale, causal, s);
}

template <bool kGated>
int launch_packed_d(const void* qw, const void* kw, const void* vw, const void* live, void* out,
                    int g, int n, int m, int d, int t_total, float scale, int causal,
                    void* stream) {
  if (!exact_shape(m, d) || t_total < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const uint32_t*>(qw);
  const auto* k = static_cast<const uint32_t*>(kw);
  const auto* v = static_cast<const uint32_t*>(vw);
  const auto* lv = static_cast<const int*>(live);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (key_range(m, d) < m) {
    return launch_packed_dp<kGated, true>(q, k, v, lv, o, g, n, m, d, t_total, scale, causal, s);
  }
  return launch_packed_dp<kGated, false>(q, k, v, lv, o, g, n, m, d, t_total, scale, causal, s);
}

}  // namespace

// K6: every plane computed; the ungated kernel never reads live, so none is passed.
extern "C" int packed_ssa_fwd(const void* qw, const void* kw, const void* vw, void* out,
                              int g, int n, int m, int d, int t_total, float scale,
                              int causal, void* stream) {
  return launch_packed_d<false>(qw, kw, vw, nullptr, out, g, n, m, d, t_total, scale, causal,
                                stream);
}

// K9.  live: (g, t_total) int32, nonzero where plane t of fold g is live.
extern "C" int sparse_packed_ssa_fwd(const void* qw, const void* kw, const void* vw,
                                     const void* live, void* out, int g, int n, int m,
                                     int d, int t_total, float scale, int causal,
                                     void* stream) {
  return launch_packed_d<true>(qw, kw, vw, live, out, g, n, m, d, t_total, scale, causal,
                               stream);
}

extern "C" int ssa_fwd(const void* q, const void* k, const void* v, void* out, int g,
                       int n, int m, int d, float scale, int causal, void* stream) {
  if (!exact_shape(m, d)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch_dense_split<16>(qf, kf, vf, o, g, n, m, d, scale, causal, s);
  if (d <= 32) return launch_dense_split<32>(qf, kf, vf, o, g, n, m, d, scale, causal, s);
  if (d <= 64) return launch_dense_split<64>(qf, kf, vf, o, g, n, m, d, scale, causal, s);
  if (d <= 128) return launch_dense_split<128>(qf, kf, vf, o, g, n, m, d, scale, causal, s);
  if (key_range(m, d) < m) {
    return launch_wide<false, false, true>(qf, kf, vf, nullptr, o, g, n, m, d, 1, scale, causal, s);
  }
  return launch_wide<false, false, false>(qf, kf, vf, nullptr, o, g, n, m, d, 1, scale, causal, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
