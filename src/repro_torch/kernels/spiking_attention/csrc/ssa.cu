// Tick-batched softmax-free spiking self-attention: out = (q k^T) v * scale.
//
// Three entry points on three tensor-core kernels (the third for D > 128):
//
//   ssa_fwd               dense f32 spikes   ssa_tc_kernel<Dp, W>,
//                                            ssa_wide_tc_kernel<DQ, false, false, kSplit>
//     Replaces: src/repro/kernels/spiking_attention/kernel.py::ssa_fwd
//               (body ssa_kernel).
//   packed_ssa_fwd        packed words       packed_ssa_tc_kernel<Dp, P, false>,
//                                            ssa_wide_tc_kernel<DQ, true, false, kSplit>
//     Replaces: src/repro/kernels/spiking_attention/kernel.py::packed_ssa_fwd
//               (body packed_ssa_kernel).
//   sparse_packed_ssa_fwd packed words,      packed_ssa_tc_kernel<Dp, P, true>,
//                         plane-gated        ssa_wide_tc_kernel<DQ, true, true, kSplit>
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
// Wide (ssa_wide_tc_kernel<DQ, kPacked, kGated, kSplit>, 128 < D <= 512, DQ =
// 256 or 512).  One block of 8 warps covers 64 query rows of one fold (and,
// packed, one plane) and every output feature: warp (rg, hf) = (warp % 4,
// warp / 4) owns query rows 16 rg .. 16 rg + 15 and half hf of the features,
// so its output tile is 16 x DQ/2 f32 (128 accumulators a thread at DQ = 512;
// the block holds 64 x 512 outputs in registers, one block an SM).  The keys
// go in tiles of 16 (kWideKeys divides kKeys, so every key range ends on a
// tile boundary), and for each tile:
//   1. warp (rg, hf) computes the partial scores of its rows over its half
//      of the features (DQ/32 k16 steps, 2 n8 tiles), integers <= 256, and
//      writes them to shared memory as f16 (exact);
//   2. after one barrier it adds the two partials of its rows in f32 (exact:
//      integers <= 512), masks them on absolute key positions, rounds them to
//      f16 (exact) and multiplies them by the tile's V at its output features.
// So S = Q K^T is computed once per (query tile, key tile) for the whole head:
// 2,048 mma.sync per 64 x 64 tile pair at D = 512, against 5,120 in the form
// before it, whose grid had an axis over 128-feature output slabs and whose
// blocks each recomputed the full-width scores.  Q is staged once per block
// as f16 (its loads issued in rounds of 16 a thread before the first store).
// Each k and v tile is read once per block, straight into registers one tile
// ahead (the next tile's loads are in flight while this tile's MMAs run), and
// converted to f16 when stored: f32 spikes converted, or the block's plane of
// the words (0x3C00 per set bit).  Every fragment comes from ldmatrix (.trans
// for V); two barriers a tile.  Shared memory: q 66,560 B, the k and v tiles
// 33,280, the partials 6,144: 105,984 B of the 227 KB a block may have at DQ =
// 512 (56,832 at 256).  Packed, a block reads each word of a key tile once,
// for its one plane (the slab form read it once per plane and slab): a
// block's registers hold one plane's accumulators, so planes are not shared.
// Blocks run query tile first (the heaviest causal tile first), then fold,
// then plane; where they number at most a half (a quarter) of the SMs, two
// (four) groups of blocks each compute the scores and a half (a quarter) of
// the output features, so that a short prompt still fills the card.  A gated
// block whose plane is dead writes its zeros and returns before it reads any
// word.  The arithmetic of an output element is exact as above, so the
// result equals the plain version's bit for bit.
//
// Bound of the wide form at the LM's 2048-token prefill (G = 64, D = 512,
// causal): 275 GFLOP on the tensor cores (0.28 ms) against 1.07 GB of q, k, v
// and out read or written once (0.32 ms).  What the design leaves: each block
// streams its fold's keys up to its last row, so the k and v bytes read grow
// with the query tiles (8.9 GB at N = 2048, mostly from L2), and the
// accumulators fill the register file, so 8 warps an SM hide the latency of
// the loads and of the ldmatrix / mma chains.
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

// Rows row0 .. row0 + kKeys - 1, features 0 .. DP - 1 of a (rows_total, d)
// f32 matrix as f16 into dst[kKeys][LD], zero past the matrix, by THREADS
// threads; vec: d % 4 == 0 and src 16-byte aligned.
template <int DP, int LD, int THREADS>
__device__ __forceinline__ void stage_f16(__half* dst, const float* src, int row0,
                                          int rows_total, int d, bool vec) {
  constexpr int kChunks = DP / 4;
  for (int c = threadIdx.x; c < kKeys * kChunks; c += THREADS) {
    const int r = c / kChunks, f = (c % kChunks) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < rows_total && f < d) {
      const float* p = src + static_cast<long long>(row0 + r) * d + f;
      if (vec) {
        x = *reinterpret_cast<const float4*>(p);
      } else {
        x.x = p[0];
        if (f + 1 < d) x.y = p[1];
        if (f + 2 < d) x.z = p[2];
        if (f + 3 < d) x.w = p[3];
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

// One warp's 16 x Dp output tile, times scale, into og (n, d); pair: float2
// loads and stores (d even, og 8-byte aligned).  Features from f0 on, below
// f_end (a warp's share of the wide kernel's output).  add: the tile is first
// added to what og holds, the unscaled sum of the earlier key ranges (each
// thread reads back only what it wrote itself).
template <int NT>
__device__ __forceinline__ void store_tile(float* og, const float (&o)[NT][4], int row0, int n,
                                           int d, float scale, bool pair, int lane, int f0,
                                           bool add, int f_end = kMaxD) {
  const int f_stop = min(d, f_end);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int f = f0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + (lane >> 2) + 8 * h;
      if (row >= n || f >= f_stop) continue;
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

constexpr int kWideRows = 64;   // query rows per block of the wide kernel
constexpr int kWideKeys = 16;   // keys per tile of the wide kernel: divides kKeys, so
                                // that every key range ends on a tile boundary
constexpr int kWideWarps = 8;   // 4 row groups x 2 halves of the features
constexpr int kWideThreads = 32 * kWideWarps;

// q, the k and v tiles and the two score partials, as f16 rows padded by 8
// halfs: 105,984 B at DQ = 512, 56,832 B at DQ = 256.
template <int DQ>
__host__ __device__ constexpr int wide_smem_bytes() {
  return 2 * ((kWideRows + 2 * kWideKeys) * (DQ + 8) + 2 * kWideRows * (kWideKeys + 8));
}

// Four 4-byte elements as four f16: f32 spikes converted, or bit `bit` of
// the words (1.0 is 0x3C00).
template <bool kPacked>
__device__ __forceinline__ uint2 f16x4(uint4 x, int bit) {
  if constexpr (kPacked) {
    return make_uint2(plane_half2(merge_words(x.x, x.y, bit), 0),
                      plane_half2(merge_words(x.z, x.w, bit), 0));
  } else {
    return make_uint2(pack_half2(__uint_as_float(x.x), __uint_as_float(x.y)),
                      pack_half2(__uint_as_float(x.z), __uint_as_float(x.w)));
  }
}

// Chunk c (4 elements) of rows r0 .. of an (rows_total, d) matrix of 4-byte
// elements with DQ / 4 chunks a row, zero past the matrix; vec: d % 4 == 0
// and src 16-byte aligned (one 16-byte load).
template <int DQ>
__device__ __forceinline__ uint4 load_chunk(const uint32_t* src, int c, int r0, int rows_total,
                                            int d, bool vec) {
  const int r = c / (DQ / 4), f = (c % (DQ / 4)) * 4;
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if (r0 + r < rows_total && f < d) {
    const uint32_t* p = src + static_cast<long long>(r0 + r) * d + f;
    if (vec) {
      x = *reinterpret_cast<const uint4*>(p);
    } else {
      x.x = p[0];
      if (f + 1 < d) x.y = p[1];
      if (f + 2 < d) x.z = p[2];
      if (f + 3 < d) x.w = p[3];
    }
  }
  return x;
}

// A tile of kWideKeys rows into this thread's registers: the loads are
// issued here and waited for only where store_tile_f16 reads them.
template <int DQ, int XN>
__device__ __forceinline__ void load_tile(uint4 (&x)[XN], const uint32_t* src, int r0,
                                          int rows_total, int d, bool vec) {
#pragma unroll
  for (int i = 0; i < XN; ++i) {
    x[i] = load_chunk<DQ>(src, threadIdx.x + i * kWideThreads, r0, rows_total, d, vec);
  }
}

// The registers of load_tile as f16 rows dst[kWideKeys][DQ + 8].
template <bool kPacked, int DQ, int XN>
__device__ __forceinline__ void store_tile_f16(__half* dst, const uint4 (&x)[XN], int bit) {
#pragma unroll
  for (int i = 0; i < XN; ++i) {
    const int c = threadIdx.x + i * kWideThreads;
    *reinterpret_cast<uint2*>(dst + c / (DQ / 4) * (DQ + 8) + c % (DQ / 4) * 4) =
        f16x4<kPacked>(x[i], bit);
  }
}

// The block's kWideRows query rows as f16 rows dst[kWideRows][DQ + 8], in
// rounds of 16 chunks a thread: each round's loads are all issued before its
// first store, so that the block waits for a round trip per round, not per
// chunk.
template <bool kPacked, int DQ>
__device__ __forceinline__ void stage_q_wide(__half* dst, const uint32_t* src, int q0, int n,
                                             int d, bool vec, int bit) {
  constexpr int kIters = kWideRows * DQ / 4 / kWideThreads, kRound = kIters < 16 ? kIters : 16;
#pragma unroll
  for (int i0 = 0; i0 < kIters; i0 += kRound) {
    uint4 x[kRound];
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      x[i] = load_chunk<DQ>(src, threadIdx.x + (i0 + i) * kWideThreads, q0, n, d, vec);
    }
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      const int c = threadIdx.x + (i0 + i) * kWideThreads;
      *reinterpret_cast<uint2*>(dst + c / (DQ / 4) * (DQ + 8) + c % (DQ / 4) * 4) =
          f16x4<kPacked>(x[i], bit);
    }
  }
}

// One kernel for all three entry points at 128 < D <= DQ (the header's
// design).  A block: kWideRows query rows of one fold (and, kPacked, one
// plane) and every output feature, or 1 / groups of them.  Warp (rg, hf) =
// (warp % 4, warp / 4): query rows row0 = q0 + 16 rg ..; in the scores,
// features hf * DQ / 2 ..; in S V, output features fw0 .. fw0 + fwn - 1.
// kGated: a dead plane's block writes zeros.
template <int DQ, bool kPacked, bool kGated, bool kSplit>
__global__ void __launch_bounds__(kWideThreads, 1)
ssa_wide_tc_kernel(const void* __restrict__ qv, const void* __restrict__ kv,
                   const void* __restrict__ vv, const int* __restrict__ live,
                   float* __restrict__ out, int g_total, int n, int m, int d, int t_total,
                   int groups, int range, float scale, int causal, int vec, int pair) {
  constexpr int HALF = DQ / 2;          // features of a warp's score partial
  constexpr int LDQ = DQ + 8;           // halfs: q, k and v rows
  constexpr int LDS = kWideKeys + 8;    // halfs: score partial rows
  constexpr int NT = HALF / 8;          // n8 tiles of a warp's output, at most
  constexpr int XN = kWideKeys * DQ / 4 / kWideThreads;  // 16-byte chunks of a tile a thread
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __half* qs = reinterpret_cast<__half*>(tc_smem);  // [kWideRows][LDQ]
  __half* ks = qs + kWideRows * LDQ;                 // [kWideKeys][LDQ]
  __half* vs = ks + kWideKeys * LDQ;                 // [kWideKeys][LDQ]
  __half* sp = vs + kWideKeys * LDQ;                 // [2][kWideRows][LDS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, hf = warp >> 2;
  // Block order: query tile (the heaviest causal tile first), then fold, then
  // plane and feature group.
  const int qtiles = (n + kWideRows - 1) / kWideRows;
  const int inner = (kPacked ? t_total : 1) * groups;
  const long long lin = blockIdx.x;
  const int pz = static_cast<int>(lin % inner);
  const long long g = lin / inner % g_total;
  const int qt = qtiles - 1 - static_cast<int>(lin / inner / g_total);
  const int plane = pz / groups, grp = pz % groups;
  const int q0 = qt * kWideRows, row0 = q0 + 16 * rg;
  const int fwn = ((d + 2 * groups - 1) / (2 * groups) + 15) / 16 * 16;
  const int fw0 = (2 * grp + hf) * fwn;
  const long long base = kPacked ? static_cast<long long>(plane >> 5) * g_total + g : g;
  float* og = out + (static_cast<long long>(plane) * g_total + g) * n * d;

  if (kGated && live[g * t_total + plane] == 0) {  // a dead plane: the block's outputs are 0
    const int f0 = 2 * grp * fwn, rows = min(kWideRows, n - q0), cols = min(2 * fwn, d - f0);
    for (int e = threadIdx.x; e < rows * cols; e += kWideThreads) {
      og[static_cast<long long>(q0 + e / cols) * d + f0 + e % cols] = 0.0f;
    }
    return;
  }
  const int bit = plane & 31;
  const uint32_t* kg = static_cast<const uint32_t*>(kv) + base * m * d;
  const uint32_t* vg = static_cast<const uint32_t*>(vv) + base * m * d;
  const int kv_end = causal ? min(m, q0 + kWideRows) : m;
  const int tiles = (kv_end + kWideKeys - 1) / kWideKeys;

  uint4 xk[XN], xv[XN];  // the next k and v tiles, in flight
  load_tile<DQ>(xk, kg, 0, m, d, vec);
  load_tile<DQ>(xv, vg, 0, m, d, vec);
  stage_q_wide<kPacked, DQ>(qs, static_cast<const uint32_t*>(qv) + base * n * d, q0, n, d, vec,
                            bit);
  store_tile_f16<kPacked, DQ>(ks, xk, bit);
  store_tile_f16<kPacked, DQ>(vs, xv, bit);
  if (tiles > 1) {
    load_tile<DQ>(xk, kg, kWideKeys, m, d, vec);
    load_tile<DQ>(xv, vg, kWideKeys, m, d, vec);
  }
  __syncthreads();

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    const int kv0 = t * kWideKeys;
    // warp-uniform: the warp's rows exist and see a key of the tile
    const bool rows_live = row0 < n && !(causal && kv0 > row0 + 15);
    if (rows_live && HALF * hf < d) {  // the warp's partial scores over its half of D
      float s[2][2][4] = {};           // two sums over alternate k16 steps, for ILP
#pragma unroll
      for (int st = 0; st < HALF / 16; ++st) {
        const int f = HALF * hf + 16 * st;
        uint32_t a[4], b[4];  // a: rows 16rg + (0..15); b: keys (0..7 | 8..15); features f + (0..7 | 8..15)
        ldsm_x4(a, qs + (16 * rg + (lane & 15)) * LDQ + f + 8 * (lane >> 4));
        ldsm_x4(b, ks + ((lane & 7) + 8 * (lane >> 4)) * LDQ + f + 8 * ((lane >> 3) & 1));
        mma_16816(s[st & 1][0], a, b[0], b[1]);
        mma_16816(s[st & 1][1], a, b[2], b[3]);
      }
      __half* p = sp + (hf * kWideRows + 16 * rg + (lane >> 2)) * LDS + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // integers <= DQ / 2: the sums and f16 exact
        *reinterpret_cast<uint32_t*>(p + 8 * j) =
            pack_half2(s[0][j][0] + s[1][j][0], s[0][j][1] + s[1][j][1]);
        *reinterpret_cast<uint32_t*>(p + 8 * LDS + 8 * j) =
            pack_half2(s[0][j][2] + s[1][j][2], s[0][j][3] + s[1][j][3]);
      }
    }
    __syncthreads();  // the partials written; every warp done with k of tile t
    if (t + 1 < tiles) {
      store_tile_f16<kPacked, DQ>(ks, xk, bit);  // k of tile t + 1
      if (t + 2 < tiles) load_tile<DQ>(xk, kg, kv0 + 2 * kWideKeys, m, d, vec);
    }
    if (rows_live && fw0 < d) {
      float s[2][4] = {};  // the two partials of the warp's rows added in f32 (exact)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (HALF * p >= d) break;
        uint32_t r[4];  // the A fragment of partial p: r_i = (s[i / 2][2 (i % 2)], +1)
        ldsm_x4(r, sp + (p * kWideRows + 16 * rg + (lane & 15)) * LDS + 8 * (lane >> 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&r[i]));
          s[i >> 1][2 * (i & 1)] += x.x;
          s[i >> 1][2 * (i & 1) + 1] += x.y;
        }
      }
      uint32_t a[4];
      scores_to_a(a, s, causal, row0, kv0, lane);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (16 * j >= fwn) break;
        uint32_t b[4];  // V rows (0..7 | 8..15), features fw0 + 16j + (0..7 | 8..15)
        ldsm_x4_trans(b, vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDQ + fw0 + 16 * j +
                             8 * (lane >> 4));
        mma_16816(o[2 * j], a, b[0], b[1]);
        mma_16816(o[2 * j + 1], a, b[2], b[3]);
      }
    }
    const bool last = t + 1 == tiles;
    if (last || (kSplit && (kv0 + kWideKeys) % range == 0)) {  // the end of a key range
      store_tile<NT>(og, o, row0, n, d, last ? scale : 1.0f, pair, lane, fw0,
                     kSplit && kv0 >= range, fw0 + fwn);
#pragma unroll
      for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    }
    __syncthreads();  // every warp done with v of tile t and with the partials
    if (t + 1 < tiles) {
      store_tile_f16<kPacked, DQ>(vs, xv, bit);  // v of tile t + 1
      if (t + 2 < tiles) load_tile<DQ>(xv, vg, kv0 + 2 * kWideKeys, m, d, vec);
    }
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

// Past D = 128: ssa_wide_tc_kernel, D rounded up to 256 or 512 for the
// scores.  One block per (fold, 64 query rows[, plane]); where those blocks
// number at most a quarter (a half) of the SMs, four (two) groups of blocks
// each compute the scores and a quarter (a half) of the output features, so
// that a small grid still fills the card.  Above the SM count: one group.
template <bool kPacked, bool kGated, bool kSplit>
int launch_wide(const void* q, const void* k, const void* v, const int* live, float* out, int g,
                int n, int m, int d, int t_total, float scale, int causal, cudaStream_t stream) {
  const bool half = d <= 256;
  const auto kernel = half ? ssa_wide_tc_kernel<256, kPacked, kGated, kSplit>
                           : ssa_wide_tc_kernel<512, kPacked, kGated, kSplit>;
  const size_t smem = half ? wide_smem_bytes<256>() : wide_smem_bytes<512>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int sms = [] {  // the card's SM count, read once
    int device = 0, count = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      cudaGetLastError();
      return 0;  // unknown: one group
    }
    return count;
  }();
  const int vec = d % 4 == 0 && aligned(q, 16) && aligned(k, 16) && aligned(v, 16);
  const int pair = d % 2 == 0 && aligned(out, 8);
  const long long blocks = static_cast<long long>(g) * ((n + kWideRows - 1) / kWideRows) *
                           (kPacked ? t_total : 1);
  const int groups = 4 * blocks <= sms ? 4 : 2 * blocks <= sms ? 2 : 1;
  kernel<<<static_cast<unsigned>(blocks * groups), kWideThreads, smem, stream>>>(
      q, k, v, live, out, g, n, m, d, t_total, groups, key_range(m, d), scale, causal, vec, pair);
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
