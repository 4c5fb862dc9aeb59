// The spike GEMM on the tensor cores: (M, K) spikes x (K, C) f32 weights
// -> f32, in three entry points that share one tile body (gemm_tile) and differ
// only in how they stage and read their A operand:
//
//   spike_matmul_fwd                spike_matmul_tc_kernel
//     (M, K) f32 spikes or counts -> (M, C); T folded into M, so each weight
//     tile is read once for all time steps.
//     Replaces: src/repro/kernels/spike_matmul/kernel.py::spike_matmul_fwd
//               (body matmul_kernel).
//   packed_spike_matmul_fwd         packed_spike_matmul_tc_kernel<P>
//     (M, K) 32-bit spike words, bit t of word x[m, k] the spike of (m, k) at
//     time step t, T <= 32 -> (T, M, C).
//     Replaces: src/repro/kernels/spike_matmul/kernel.py::packed_spike_matmul_fwd
//               (body packed_matmul_kernel).
//   sparse_packed_spike_matmul_fwd  sparse_packed_spike_matmul_tc_kernel<P>
//     the packed GEMM with, beside the words, the int32 spike counts per
//     (64-row M tile, 128-feature K tile) of the word operand, (ceil(M/64),
//     ceil(K/128)); a tile whose count is 0 is skipped.
//     Replaces: src/repro/kernels/spike_matmul/kernel.py::
//               sparse_packed_spike_matmul_fwd (body sparse_packed_matmul_kernel).
//
// One GEMM serves every weight layer of the deploy plan, as the paper's one
// reconfigurable PE dataflow does: linears directly, 3x3 convs through an
// im2col gather done by the wrapper.
//
// Operand contract.  The A operand is integers of magnitude at most 256,
// which bf16 holds exactly.  The packed words are bits.  The dense GEMM gets
// LIF outputs in {0, 1} from engine/backend.py linear_apply and
// conv3x3_apply, the latter through the im2col gather, whose zero padding is
// 0; the rate head never reaches it.  In the residual='add' configs its
// linears also read the residual stream, a sum of spike trains: at most 2L + 1
// (17 at L = 8).  The TPU kernel computes any f32 x; this one computes the
// same function on the operands the system gives it.  An x that is not such
// an integer would be rounded to bf16 first: no caller may pass one.
//
// Arithmetic.  Each f32 weight is split into three bf16 pieces,
// hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid), and hi + mid + lo
// == w exactly: each residual is exact in f32, a piece keeps 8 significant
// bits, and bf16 has f32's exponent range, so small weights do not underflow as
// they would in f16 (two pieces keep only 16 bits, ~7.6e-6 relative).  An
// integer of at most 256 times a piece (8 x 8 significant bits) is exact, so
// the only rounding is the f32 accumulation.
// Inside an mma the tensor cores add in f32 but do not round to nearest (they
// truncate), and a truncation shrinks a long running sum in one direction.  So
// each pipeline stage of 32 features accumulates into a fresh partial sum --
// two k16 steps, each mma.sync.m16n8k16 bf16 x bf16 -> f32 issued for hi, mid
// and lo in that order -- and the partial is added to the output's f32
// accumulator with one round-to-nearest add.  The error of a partial is a few
// units in the last place of a sum of 32 terms, of either sign; across stages
// it behaves as a float32 sum of K/32 terms.
//
// One sum order, so the three entry points agree bit for bit.  The stages start
// at K = 0 and step by 32 in increasing K for every loader, and a stage's
// MMAs and its add are the same per output element whichever rows share its
// tile (an mma computes each output element from its own A row and B column).
// So the packed GEMM's plane t of row m equals the dense GEMM's row t*M + m on
// the unpacked operand: its bf16 A values are the same 0/1.  And the gated GEMM
// equals the packed one: a stage it skips has an all-zero A for the skipped
// rows, whose partial is exactly 0 and whose add leaves the accumulator as it
// is.  The 128-feature occupancy tile covers 4 whole stages, and a warp's rows
// lie in one 64-row occupancy tile, so a skip is uniform over a warp.
//
// Bound on this card: at the main path's shapes (8-384, slot batch 8) the
// work is 3 x 2*M*K*C bf16 tensor-core operations, 832 GFLOP per forward
// (0.84 ms at 989 TFLOP/s); the dense GEMM moves ~2.9 GB (f32 im2col
// operands of the tokenizer convs and f32 outputs; 0.86 ms at 3.35 TB/s), the
// packed ones ~1.4 GB, since a word carries T spikes.
//
// Design (gemm_tile): warp-specialized, 512 threads.  The 8 consumer warps
// (2 x 4) own 128 A rows x 96 output columns, a warp 64 A rows (four m16
// tiles) x 24 columns (three n8 tiles).  96 columns divide every layer width of
// the Table-I configs (96..1536): no idle columns in the 96- and 192-wide
// tokenizer layers, and 196 blocks for the 384-wide layers of a slot batch, a
// fuller second round on 132 SMs than 128 columns' 147.  A rows are the x rows
// for the dense loader, and (plane, word row) pairs for the packed ones: P = 1, 2 or 4
// consecutive time steps per block (blockIdx.z walks the groups), and a
// warp's m16 tile i holds plane i % P of word rows 16 (i / P) .. +15 of the
// warp's 64 / P rows, so that one word read serves all P planes.  The block
// walks K in stages of 32 features through two bf16 buffers in shared
// memory.  The two producer warpgroups load a stage's A rows (f32 spikes or
// words) and weights into registers (16-byte loads where the row length is a
// multiple of 4 and the base 16-byte aligned), wait until the consumers have
// released the buffer, then convert and store them -- the loaders are the
// only code that differs: f32 pairs to bf16x2 (cvt.rn, exact on the
// contract's integers), or word pairs merged,
// (w0 >> bit0) & 0xFFFF | (w1 >> bit0) << 16, so that plane p's
// register is ((merged >> p) & 0x00010001) * 0x3F80 (bf16 1.0), each plane to
// its own A row; each weight split once per block into hi, mid and lo rows --
// and hand the buffer over; their next stage's loads are in flight meanwhile.
// The consumers read every fragment with ldmatrix (A) and ldmatrix.trans (B)
// from rows padded by 8 bf16, so that the 8 rows of a phase fall on distinct
// banks, and issue per k16 step and piece 12 independent MMAs: their inner
// loop holds nothing but ldmatrix, mma and the partials' adds.  The hand-over
// is two named barriers per buffer (full: producers arrive, consumers wait;
// empty: the reverse), and setmaxnreg gives the consumers 184 registers a
// thread and the producers 72.  Ragged M, K and C are masked: loads outside
// the operands read zero, stores outside the output are skipped.  With
// kGated both roles skip a stage whose K tile is dead in all of the block's
// occupancy rows (no load, no MMA), and a consumer warp skips the MMAs of a
// live stage when its own occupancy tile is dead.  wgmma and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsM = 2, kWarpsN = 4;   // 2 x 4 consumer warps of 64 A rows x 8 kN8 columns
constexpr int kN8 = 3;              // n8 tiles per consumer warp
constexpr int kBM = 64 * kWarpsM;   // A rows per block
constexpr int kBN = 8 * kN8 * kWarpsN;   // output columns per block
constexpr int kBK = 32;       // features per pipeline stage (two k16 steps, one partial)
constexpr int kConsumers = 32 * kWarpsM * kWarpsN;   // threads of the consumer warps (MMAs)
constexpr int kProducers = kConsumers;   // threads of the producer warpgroups (loads, conversion)
constexpr int kThreads = kConsumers + kProducers;
constexpr int kLDA = kBK + 8;   // bf16 per staged A row: 80 bytes, conflict-free ldmatrix
constexpr int kLDB = kBN + 8;   // bf16 per staged weight row: 208 bytes, likewise
constexpr int kPieceHalfs = kBK * kLDB;
constexpr int kBufHalfs = kBM * kLDA + 3 * kPieceHalfs;   // A, then hi, mid, lo
constexpr int kBufs = 2;                                  // bf16 stages
constexpr int kSmemBytes = kBufs * kBufHalfs * 2;         // 60,416
// Registers per thread after the split (setmaxnreg): the producers hold one
// stage in flight, the consumers the accumulators and partials; 256 x 72 +
// 256 x 184 = the 512 x 128 the block is launched with.
constexpr int kProducerRegs = 72, kConsumerRegs = 184;
// The pieces each k16 step multiplies: 3.  Control builds only: chip_smoke.py
// compiles this file with SPIKE_MATMUL_PIECES=1 (hi) or 2 (hi, mid) too, a
// weaker GEMM that its checks must catch.
#ifndef SPIKE_MATMUL_PIECES
#define SPIKE_MATMUL_PIECES 3
#endif
constexpr int kPieces = SPIKE_MATMUL_PIECES;
static_assert(kPieces >= 1 && kPieces <= 3, "hi, mid and lo are the only pieces");
constexpr int kOccRows = 64, kOccTile = 128;   // the occupancy tile: word rows x features
static_assert(kOccTile % kBK == 0, "a stage never straddles two occupancy tiles");

// Register reallocation between warpgroups (sm_90a).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Named barriers between the producer and the consumer warps (id 0 is
// __syncthreads'): arrive signals without waiting, sync waits for all kThreads.
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kThreads) : "memory");
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

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[4], const void* p) {
  const auto s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as the bf16 lanes of one register, round to nearest (x0 low).
__device__ __forceinline__ uint32_t bf16x2(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The low and high bf16 lanes of a register as floats.
__device__ __forceinline__ float lane0(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float lane1(uint32_t r) { return __uint_as_float(r & 0xFFFF0000u); }

// w0, w1 as three bf16x2 registers with hi + mid + lo == w lane by lane.
__device__ __forceinline__ void split3(float w0, float w1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = bf16x2(w0, w1);
  const float r0 = w0 - lane0(hi), r1 = w1 - lane1(hi);
  mid = bf16x2(r0, r1);
  lo = bf16x2(r0 - lane0(mid), r1 - lane1(mid));
}

// The two bf16 lanes' words of a register, shifted to the group's first bit:
// plane p sits at bits p and 16 + p.
__device__ __forceinline__ uint32_t merge_words(uint32_t w0, uint32_t w1, int bit0) {
  return ((w0 >> bit0) & 0xFFFFu) | ((w1 >> bit0) << 16);
}

// Plane p of a merged register as bf16 lanes: 1.0 (0x3F80) where the bit is set.
__device__ __forceinline__ uint32_t plane_bf16x2(uint32_t merged, int p) {
  return ((merged >> p) & 0x00010001u) * 0x3F80u;
}

// The tile body.  a: (m, k) f32 spike bits (kPacked false, P 1) or words; w:
// (k, c) f32; tiles: the occupancy counts (kGated); out: (m, c), or (t_total,
// m, c) for the packed loaders.  Grid: x walks (row tile, column tile) with the
// column tile fastest (the blocks of one row tile share its A slab in L2), z the
// groups of P planes.
template <int P, bool kPacked, bool kGated>
__device__ __forceinline__ void gemm_tile(const uint32_t* __restrict__ a,
                                          const float* __restrict__ w,
                                          const int* __restrict__ tiles,
                                          float* __restrict__ out, int m, int k, int c,
                                          int t_total, int n_tiles, bool vec_a, bool vec_b,
                                          bool pair) {
  constexpr int kRows = kBM / P;                   // rows of a per block
  constexpr int kWarpRows = kRows / kWarpsM;       // rows of a per consumer warp
  constexpr int kAChunks = kRows * (kBK / 4) / kProducers;   // 16-byte chunks per producer
  constexpr int kBChunks = kBK * (kBN / 4) / kProducers;
  constexpr int kFull = 1, kEmpty = 1 + kBufs;     // named barrier ids, one per buffer
  extern __shared__ __align__(16) uint16_t bufs[];   // kBufs x (A, hi, mid, lo)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x / n_tiles) * kRows;
  const int col0 = (blockIdx.x % n_tiles) * kBN;
  const int p0 = kPacked ? blockIdx.z * P : 0;    // first time step (< 32)
  const int nk = (k + kBK - 1) / kBK;
  const int k_tiles = (k + kOccTile - 1) / kOccTile;

  // kGated: is stage s live for the block (any of its occupancy rows)?  The
  // producer and the consumers walk the same live stages; every thread reads
  // the same counts, so the branches are uniform.
  const long long last_row = min(row0 + kRows, static_cast<long long>(m)) - 1;
  const int* occ_first = kGated ? tiles + (row0 / kOccRows) * k_tiles : nullptr;
  const int* occ_last = kGated ? tiles + (last_row / kOccRows) * k_tiles : nullptr;
  auto next_live = [&](int s) {
    if (kGated) {
      while (s < nk && occ_first[s * kBK / kOccTile] == 0 && occ_last[s * kBK / kOccTile] == 0) {
        ++s;
      }
    }
    return s;
  };

  if (warp < kProducers / 32) {
    // ---- producer warpgroups: load stage s's chunks -- 4 features of an a
    // row, 4 columns of a w row -- into registers, zero outside the operands
    // (16-byte loads where the row length is a multiple of 4 and the base
    // 16-byte aligned); once the consumers have released the buffer (kEmpty),
    // convert and store them as bf16 -- a's rows (plane p of the consumer
    // warp's word row 16 g + r to its A row 16 (g P + p) + r), w's hi, mid and
    // lo rows -- and hand the buffer over (kFull).  The next stage's loads
    // are in flight while the producers wait for its buffer.
    regs_dec<kProducerRegs>();
    const int pt = tid;
    uint4 ra[kAChunks];
    float4 rb[kBChunks];
    auto load = [&](int s) {
      const int k0 = s * kBK;
#pragma unroll
      for (int l = 0; l < kAChunks; ++l) {
        const int e = pt + l * kProducers, r = e / (kBK / 4), f = k0 + (e % (kBK / 4)) * 4;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < m) {
          const uint32_t* src = a + (row0 + r) * k + f;
          if (vec_a) {
            if (f < k) v = *reinterpret_cast<const uint4*>(src);
          } else {
            if (f < k) v.x = src[0];
            if (f + 1 < k) v.y = src[1];
            if (f + 2 < k) v.z = src[2];
            if (f + 3 < k) v.w = src[3];
          }
        }
        ra[l] = v;
      }
#pragma unroll
      for (int l = 0; l < kBChunks; ++l) {
        const int e = pt + l * kProducers, r = k0 + e / (kBN / 4);
        const int f = col0 + (e % (kBN / 4)) * 4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < k) {
          const float* src = w + static_cast<long long>(r) * c + f;
          if (vec_b) {
            if (f < c) v = *reinterpret_cast<const float4*>(src);
          } else {
            if (f < c) v.x = src[0];
            if (f + 1 < c) v.y = src[1];
            if (f + 2 < c) v.z = src[2];
            if (f + 3 < c) v.w = src[3];
          }
        }
        rb[l] = v;
      }
    };
    auto store = [&](int buf) {
      uint16_t* as = bufs + buf * kBufHalfs;
      uint16_t* bs = as + kBM * kLDA;
#pragma unroll
      for (int l = 0; l < kAChunks; ++l) {
        const int e = pt + l * kProducers, r = e / (kBK / 4), f = (e % (kBK / 4)) * 4;
        const uint4 v = ra[l];
        if (kPacked) {
          const int rr = r % kWarpRows;
          const int arow = (r / kWarpRows) * 64 + (rr / 16) * P * 16 + rr % 16;
          const uint32_t m01 = merge_words(v.x, v.y, p0), m23 = merge_words(v.z, v.w, p0);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            *reinterpret_cast<uint2*>(as + (arow + 16 * p) * kLDA + f) =
                make_uint2(plane_bf16x2(m01, p), plane_bf16x2(m23, p));
          }
        } else {
          *reinterpret_cast<uint2*>(as + r * kLDA + f) =
              make_uint2(bf16x2(__uint_as_float(v.x), __uint_as_float(v.y)),
                         bf16x2(__uint_as_float(v.z), __uint_as_float(v.w)));
        }
      }
#pragma unroll
      for (int l = 0; l < kBChunks; ++l) {
        const int e = pt + l * kProducers, r = e / (kBN / 4), f = (e % (kBN / 4)) * 4;
        const float4 v = rb[l];
        uint32_t hi0, mid0, lo0, hi1, mid1, lo1;
        split3(v.x, v.y, hi0, mid0, lo0);
        split3(v.z, v.w, hi1, mid1, lo1);
        uint16_t* dst = bs + r * kLDB + f;
        *reinterpret_cast<uint2*>(dst) = make_uint2(hi0, hi1);
        *reinterpret_cast<uint2*>(dst + kPieceHalfs) = make_uint2(mid0, mid1);
        *reinterpret_cast<uint2*>(dst + 2 * kPieceHalfs) = make_uint2(lo0, lo1);
      }
    };

    int buf = 0;
    for (int s = next_live(0); s < nk; s = next_live(s + 1)) {
      load(s);
      bar_sync(kEmpty + buf);
      store(buf);
      bar_arrive(kFull + buf);
      buf = buf + 1 == kBufs ? 0 : buf + 1;
    }
    // match the consumers' last release of each buffer
#pragma unroll
    for (int b = 0; b < kBufs; ++b) bar_sync(kEmpty + b);
    return;
  }

  // ---- consumer warps: 2 x 4 of 64 A rows x 32 columns.  A row block of a
  // warp: the a rows for the dense loader; for the packed ones its m16 tile i
  // holds plane i % P of word rows 16 (i / P) .. +15 of its 64 / P rows.
  regs_inc<kConsumerRegs>();
  const int cw = warp - kProducers / 32;
  const int gid = lane >> 2, t4 = lane & 3;
  const int wm = cw / kWarpsN, wn = cw % kWarpsN;
  const long long wrow0 = row0 + wm * kWarpRows;  // the warp's first row of a
  const int* occ_warp = kGated ? tiles + (wrow0 / kOccRows) * k_tiles : nullptr;

  float acc[4][kN8][4];  // [m16 tile][n8 tile][c fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kN8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  // One stage's MMAs from buffer buf: per k16 step the four m16 A fragments
  // (ldmatrix), then per piece the kN8 n8 B fragments (ldmatrix.trans) and
  // 4 kN8 independent MMAs into the stage's fresh partials, added to acc at
  // the end of the stage.
  auto compute = [&](int buf) {
    const uint16_t* as = bufs + buf * kBufHalfs + (wm * 64 + (lane & 15)) * kLDA + 8 * (lane >> 4);
    const uint16_t* bs = bufs + buf * kBufHalfs + kBM * kLDA +
                         ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLDB + wn * 8 * kN8 + 8 * (lane >> 4);
    float part[4][kN8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kN8; ++j)
        part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldsm_x4(af[i], as + 16 * i * kLDA + 16 * ks);
#pragma unroll
      for (int piece = 0; piece < kPieces; ++piece) {
        // n8 tiles 2jp (b0, b1 = [0], [1]) and 2jp + 1 ([2], [3]); an odd last
        // tile from an x2 load
        uint32_t bf[(kN8 + 1) / 2][4];
#pragma unroll
        for (int jp = 0; jp < kN8 / 2; ++jp) {
          ldsm_x4_trans(bf[jp], bs + piece * kPieceHalfs + 16 * ks * kLDB + 16 * jp);
        }
        if (kN8 % 2) {
          ldsm_x2_trans(bf[kN8 / 2], bs + piece * kPieceHalfs + 16 * ks * kLDB + 16 * (kN8 / 2));
        }
#pragma unroll
        for (int j = 0; j < kN8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_bf16(part[i][j], af[i], bf[j / 2][2 * (j % 2)], bf[j / 2][2 * (j % 2) + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  };

#pragma unroll
  for (int b = 0; b < kBufs; ++b) bar_arrive(kEmpty + b);  // both buffers start free
  int buf = 0;
  for (int s = next_live(0); s < nk; s = next_live(s + 1)) {
    bar_sync(kFull + buf);
    // the MMAs of a stage dead in the warp's own occupancy tile are skipped
    if (wrow0 < m && (!kGated || occ_warp[s * kBK / kOccTile] != 0)) compute(buf);
    bar_arrive(kEmpty + buf);
    buf = buf + 1 == kBufs ? 0 : buf + 1;
  }

  // Epilogue: m16 tile i is plane i % P of the warp's 16-row group i / P; c0,
  // c1 at row gid, c2, c3 at row gid + 8, columns 2*t4, +1 of each n8 tile.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int plane = p0 + i % P;
    if (kPacked && plane >= t_total) continue;
    float* o = out + (kPacked ? static_cast<long long>(plane) * m * c : 0LL);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = wrow0 + 16 * (i / P) + gid + 8 * h;
      if (row >= m) continue;
      float* orow = o + row * c;
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
        const int col = col0 + wn * 8 * kN8 + 8 * j + 2 * t4;
        if (col >= c) continue;
        const float x0 = acc[i][j][2 * h], x1 = acc[i][j][2 * h + 1];
        if (pair) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
        } else {
          orow[col] = x0;
          if (col + 1 < c) orow[col + 1] = x1;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
spike_matmul_tc_kernel(const uint32_t* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ out, int m, int k, int c, int n_tiles, int vec_a,
                       int vec_b, int pair) {
  gemm_tile<1, false, false>(x, w, nullptr, out, m, k, c, 1, n_tiles, vec_a, vec_b, pair);
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
packed_spike_matmul_tc_kernel(const uint32_t* __restrict__ xw, const float* __restrict__ w,
                              float* __restrict__ out, int m, int k, int c, int t_total,
                              int n_tiles, int vec_a, int vec_b, int pair) {
  gemm_tile<P, true, false>(xw, w, nullptr, out, m, k, c, t_total, n_tiles, vec_a, vec_b,
                            pair);
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
sparse_packed_spike_matmul_tc_kernel(const uint32_t* __restrict__ xw,
                                     const float* __restrict__ w,
                                     const int* __restrict__ tiles, float* __restrict__ out,
                                     int m, int k, int c, int t_total, int n_tiles, int vec_a,
                                     int vec_b, int pair) {
  gemm_tile<P, true, true>(xw, w, tiles, out, m, k, c, t_total, n_tiles, vec_a, vec_b, pair);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The grid of an (m rows of a) x c launch with kRows rows of a per block, or
// 0 when it would not fit a 1-D grid.
unsigned grid_x(int m, int c, int rows) {
  const long long tiles = static_cast<long long>((m + rows - 1) / rows) * ((c + kBN - 1) / kBN);
  return tiles > 0x7FFFFFFFLL ? 0u : static_cast<unsigned>(tiles);
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

template <int P, bool kGated>
int launch_packed(const uint32_t* xw, const float* w, const int* tiles, float* out, int m,
                  int k, int c, int t_total, cudaStream_t stream) {
  const unsigned gx = grid_x(m, c, kBM / P);
  if (gx == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (c + kBN - 1) / kBN;
  const int vec_a = k % 4 == 0 && aligned(xw, 16);
  const int vec_b = c % 4 == 0 && aligned(w, 16);
  const int pair = c % 2 == 0 && aligned(out, 8);
  const dim3 grid(gx, 1, static_cast<unsigned>((t_total + P - 1) / P));
  cudaError_t err;
  if (kGated) {
    err = allow_smem(sparse_packed_spike_matmul_tc_kernel<P>);
    if (err != cudaSuccess) return static_cast<int>(err);
    sparse_packed_spike_matmul_tc_kernel<P><<<grid, kThreads, kSmemBytes, stream>>>(
        xw, w, tiles, out, m, k, c, t_total, n_tiles, vec_a, vec_b, pair);
  } else {
    err = allow_smem(packed_spike_matmul_tc_kernel<P>);
    if (err != cudaSuccess) return static_cast<int>(err);
    packed_spike_matmul_tc_kernel<P><<<grid, kThreads, kSmemBytes, stream>>>(
        xw, w, out, m, k, c, t_total, n_tiles, vec_a, vec_b, pair);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kGated>
int launch_packed_steps(const void* xw, const void* w, const void* tiles, void* out, int m,
                        int k, int c, int t_total, void* stream) {
  if (t_total < 1 || t_total > 32 || m < 1 || k < 1 || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* x = static_cast<const uint32_t*>(xw);
  const auto* wt = static_cast<const float*>(w);
  const auto* tl = static_cast<const int*>(tiles);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (t_total == 1) return launch_packed<1, kGated>(x, wt, tl, o, m, k, c, t_total, s);
  if (t_total == 2) return launch_packed<2, kGated>(x, wt, tl, o, m, k, c, t_total, s);
  return launch_packed<4, kGated>(x, wt, tl, o, m, k, c, t_total, s);
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
  const unsigned gx = grid_x(m, c, kBM);
  if (gx == 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(spike_matmul_tc_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_a = k % 4 == 0 && aligned(x, 16);
  const int vec_b = c % 4 == 0 && aligned(w, 16);
  const int pair = c % 2 == 0 && aligned(out, 8);
  spike_matmul_tc_kernel<<<gx, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const float*>(w), static_cast<float*>(out),
      m, k, c, (c + kBN - 1) / kBN, vec_a, vec_b, pair);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
