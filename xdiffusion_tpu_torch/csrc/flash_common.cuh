// Pieces shared by the attention kernels, K5 (flash_attention.cu), K6
// (flash_attention_bwd.cu) and K1/K2/K7 (bsc_attention*.cu): 64-row tiles
// copied into padded shared memory with cp.async, the bf16 operand plumbing
// of mma.sync m16n8k16, fp32 products in split TF32 on mma.sync m16n8k8
// (K5, K6), and the fp32 4 x 8 register tiles of the CUDA-core path (K2).
//
// Fragment layouts of m16n8k16 (g = lane / 4, t4 = lane % 4):
// - A (16x16, row-major): a0 = (row g, cols 2t4, 2t4+1), a1 = (row g+8, the
//   same cols), a2 = (row g, cols 2t4+8, +9), a3 = (row g+8, cols 2t4+8, +9);
// - B (16x8, k x n): b0 = (k 2t4, 2t4+1 of col g), b1 = (k 2t4+8, +9);
// - C (16x8, fp32): c0, c1 = (row g, cols 2t4, 2t4+1), c2, c3 = (row g+8).
// So the accumulators of two neighbouring 16x8 products (cols 0-7, 8-15)
// are, packed to bf16 pairs, the A operand of a product whose k runs over
// those 16 columns: a probability tile goes back to the tensor cores from
// registers.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace flash {

constexpr int kTile = 64;      // rows (queries or keys) of every tile
constexpr int kThreads = 128;  // 4 warps

using bf16 = __nv_bfloat16;

// Row padding (elements) of the shared tiles: rows stay 16-byte aligned for
// cp.async and ldmatrix, and consecutive rows start in different banks.
template <typename T>
struct Pad {
  static constexpr int value = std::is_same<T, float>::value ? 4 : 8;
};

template <typename T, int D>
struct Tile {
  static constexpr int ld = D + Pad<T>::value;  // elements per shared row
  static constexpr int elems = kTile * ld;      // elements of one tile
};

struct Strides {
  long long b, h, s;  // elements
};

constexpr int kLdp = kTile + 4;  // fp32 rows of a (64, 64) probability / ds tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts copying rows [row0, row0 + ROWS) of one (batch, head) slab with row
// stride `rs` into a padded shared tile, by the block's NT threads; rows at
// or past `nrows` are zeros.
template <typename T, int D, int ROWS = kTile, int NT = kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs,
                                          int row0, int nrows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kVec = D / V;
  for (int e = threadIdx.x; e < ROWS * kVec; e += NT) {
    const int r = e / kVec;
    const int c = (e - r * kVec) * V;
    const bool valid = row0 + r < nrows;
    const T* s = valid ? src + (long long)(row0 + r) * rs + c : src;
    cp_async16(dst + r * Tile<T, D>::ld + c, s, valid);
  }
}

// Two neighbouring values of a row into an fp32 or bf16 output (rounded to
// nearest even).
template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// 2^x on the SFU (relative error near 2^-22; results below 2^-126 flush to
// 0, as 2^-inf does): the exponentials of the kernels whose logits are
// already in base-2 units.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of rows [r, r + 16) and cols [c, c + 16) of a row-major
// shared tile with leading dimension ld; p = tile + (r + g) * ld + c + 2 * t4.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p, int ld) {
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// The A fragment (16 rows x 16 columns) made of two 16x8 accumulators, c0
// for columns 0-7 and c1 for columns 8-15, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed: lane i gives the address of row i % 8
// of matrix i / 8; register j receives matrix j's column-major fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// acc (16 x N, as N/8 accumulators of 16x8) += a (16 x 16) . B[k0:k0+16, :N],
// with B a row-major (k, D) shared tile (N columns from B, D by default)
// whose operands ldmatrix.trans reads.
template <int D, int N = D>
__device__ __forceinline__ void mma_a_times_tile(float (&acc)[N / 8][4],
                                                 const uint32_t (&a)[4], const bf16* B,
                                                 int k0, int lane) {
  constexpr int ld = Tile<bf16, D>::ld;
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n2 = 0; n2 < N / 16; ++n2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, B + r * ld + n2 * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * n2], a, b[0], b[1]);
    mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
  }
}

// ---- fp32 on the tensor cores by split TF32 (3xTF32), mma.sync m16n8k8 ----
//
// Fragment layouts of m16n8k8 .tf32 (g = lane / 4, t4 = lane % 4):
// - A (16x8, row-major): a0 = (row g, col t4), a1 = (row g+8, col t4),
//   a2 = (row g, col t4+4), a3 = (row g+8, col t4+4);
// - B (8x8, k x n): b0 = (k t4, col g), b1 = (k t4+4, col g);
// - C (16x8, fp32): c0, c1 = (row g, cols 2t4, 2t4+1), c2, c3 = (row g+8).
// C's columns 2t4 and 2t4+1 are not A's t4 and t4+4, but a product's k may
// run over the keys in any order both operands share: an accumulator tile
// (c0, c2, c1, c3) is the A fragment whose k = t4 stands for key 2t4 and
// k = t4+4 for key 2t4+1, and the B fragment then reads rows 2t4 and 2t4+1.
//
// Each fp32 operand x splits into hi = tf32(x), rounded to nearest, and
// lo = x - hi (exact in fp32), which the tensor cores read as a .tf32
// operand by dropping its low 13 bits; a product is lo.hi + hi.lo + hi.hi
// in fp32. What is lost, lo.lo and lo's dropped bits, is below 2^-21 of
// the product.

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a . b: the first product of a chain, from a zero accumulator (no
// instructions to clear c).
__device__ __forceinline__ void mma_tf32_first(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// An A fragment of fp32 values, split.
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2, float x3) {
    split_tf32(x0, hi[0], lo[0]);
    split_tf32(x1, hi[1], lo[1]);
    split_tf32(x2, hi[2], lo[2]);
    split_tf32(x3, hi[3], lo[3]);
  }
  // Rows r and r+8 of a row-major shared tile over 8 columns from c, with
  // k = t4 standing for column c + 2t4 and k = t4+4 for c + 2t4 + 1 (a
  // product may sum its k in any order both operands share): two 8-byte
  // loads; p = tile + (r + g) * ld + c + 2 * t4.
  __device__ __forceinline__ void load(const float* p, int ld) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    const float2 y = *reinterpret_cast<const float2*>(p + 8 * ld);
    set(x.x, y.x, x.y, y.y);
  }
  // The accumulator tile c (16 rows x 8 keys) as the A operand of a
  // product over those keys, in the key order noted above.
  __device__ __forceinline__ void from_acc(const float (&c)[4]) { set(c[0], c[2], c[1], c[3]); }
};

// A B fragment's two fp32 values, split.
struct SplitB {
  uint32_t h0, l0, h1, l1;
  __device__ __forceinline__ SplitB(float x0, float x1) {
    split_tf32(x0, h0, l0);
    split_tf32(x1, h1, l1);
  }
};

// c += a . b in split TF32 (kFirst: c = a . b).
template <bool kFirst = false>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const SplitA& a, const SplitB& b) {
  if (kFirst)
    mma_tf32_first(c, a.lo, b.h0, b.h1);
  else
    mma_tf32(c, a.lo, b.h0, b.h1);
  mma_tf32(c, a.hi, b.l0, b.l1);
  mma_tf32(c, a.hi, b.h0, b.h1);
}

// The tensor cores add an mma's products into its fp32 accumulator with
// truncation, not rounding to nearest: along a chain of n mmas the error
// grows as n ulps, not as sqrt(n). So no accumulator here takes more than
// 8 k steps (24 mmas) before its sum goes into the caller's by an fp32 add
// that rounds to nearest: a chain over thousands of keys (P.V, dq, dk, dv)
// or D 128 would otherwise leave errors near 1e-4 of the output.

// out[m][j] = A_m . T[8j + g, k0 : k0 + 64]^T for j < N/8: 8 k steps of the
// logits of MT row tiles of 16 (A_m at a + 16 m ld) against N rows of a
// (rows, D) shared tile T, both fp32 with leading dimension ld, in
// SplitA::load's order of k; a points at A + (r + g) * ld + 2 * t4. Each B
// fragment is loaded and split once for the MT row tiles.
template <int N, int MT>
__device__ __forceinline__ void dots_block(float (&out)[MT][N / 8][4], const float* a,
                                           const float* T, int ld, int k0, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    SplitA af[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) af[m].load(a + 16 * m * ld + k0 + kk * 8, ld);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 bv =
          *reinterpret_cast<const float2*>(T + (j * 8 + g) * ld + k0 + kk * 8 + 2 * t4);
      const SplitB bf(bv.x, bv.y);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (kk == 0)
          mma_3xtf32<true>(out[m][j], af[m], bf);
        else
          mma_3xtf32(out[m][j], af[m], bf);
      }
    }
  }
}

// s[m][j] = A_m . T[8j + g, :]^T over D (dots_block's operands), 64 columns
// of D a chain.
template <int D, int N, int MT>
__device__ __forceinline__ void dots_3xtf32(float (&s)[MT][N / 8][4], const float* a,
                                            const float* T, int ld, int lane) {
  dots_block<N, MT>(s, a, T, ld, 0, lane);
#pragma unroll
  for (int kb = 1; kb < D / 64; ++kb) {
    float part[MT][N / 8][4];
    dots_block<N, MT>(part, a, T, ld, 64 * kb, lane);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[m][j][e] += part[m][j][e];
  }
}
template <int D, int N>
__device__ __forceinline__ void dots_3xtf32(float (&s)[N / 8][4], const float* a, const float* T,
                                            int ld, int lane) {
  dots_3xtf32<D, N, 1>(reinterpret_cast<float(&)[1][N / 8][4]>(s), a, T, ld, lane);
}

// acc[m] (16 x D) += P_m (16 x N, accumulator tiles, N <= 64) . B[r0 : r0 +
// N, :] for MT row tiles, B a (rows, D) fp32 shared tile with leading
// dimension ld; 64 columns of D at a time, each B fragment split once.
template <int D, int N, int MT>
__device__ __forceinline__ void product_3xtf32(float (&acc)[MT][D / 8][4],
                                               const float (&p)[MT][N / 8][4], const float* B,
                                               int ld, int r0, int lane) {
  static_assert(N <= 64, "product_3xtf32: at most 8 k steps a chain");
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
    float part[MT][8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      SplitA af[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) af[m].from_acc(p[m][j]);
      const float* bp = B + (r0 + j * 8 + 2 * t4) * ld + cb * 64 + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const SplitB bf(bp[n * 8], bp[ld + n * 8]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (j == 0)
            mma_3xtf32<true>(part[m][n], af[m], bf);
          else
            mma_3xtf32(part[m][n], af[m], bf);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][cb * 8 + n][e] += part[m][n][e];
  }
}
template <int D, int N>
__device__ __forceinline__ void product_3xtf32(float (&acc)[D / 8][4], const float (&p)[N / 8][4],
                                               const float* B, int ld, int r0, int lane) {
  product_3xtf32<D, N, 1>(reinterpret_cast<float(&)[1][D / 8][4]>(acc),
                          reinterpret_cast<const float(&)[1][N / 8][4]>(p), B, ld, r0, lane);
}

// ---- head dims 256 and 576 (the "wide" variant of K5 and K6): warps split D --
//
// At D = 256 a warp's 16 x 256 fp32 accumulator takes 128 registers a lane,
// and 64-row tiles of fp32 no longer fit shared memory. So the warps of a
// block take one 16-row tile together, warp w owning columns [64w, 64w +
// 64) of D: its accumulators (P.V; dq; dk and dv) hold 16 x 64. A product
// over D (the logits, dP) is one partial a warp over its 64 columns (one
// split-TF32 chain of 8 k steps, or 4 bf16 k16 steps); the warps exchange
// the partials through shared memory and each adds them in warp order, as
// dots_3xtf32 adds its chains over D. Each warp then holds the whole 16 x
// kKeys tile and runs the softmax bookkeeping on it (the warps do the same
// arithmetic on the same values), and a product into D runs on its own
// columns.
//
// D 256 (WideFormer, AuraFlow): 4 warps, 32-row streamed tiles, double
// buffered. D 576 (Sana's 2 cross-attention heads of 576): 9 warps, and
// 16-row streamed tiles, still double buffered: with 32-row fp32 tiles the
// forward would need 334,080 bytes of shared memory, more than a block may
// hold (232,448). The backward's two exchanged tiles (S and dP) then go
// through one slot in turn, so its fp32 block takes 231,936 bytes.

namespace wide {
constexpr int kRows = 16;   // query rows (dk/dv: keys) a block
constexpr int kCols = 64;   // columns of D a warp owns

template <int D>
struct Cfg {
  static_assert(D == 256 || D == 576, "wide: head dim 256 or 576");
  static constexpr int kWarps = D / kCols;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kKeys = D == 256 ? 32 : 16;       // streamed rows (keys; dk/dv: queries)
  static constexpr int kXch = kWarps * kRows * kKeys;    // fp32 of one exchanged tile
  static constexpr int kBwdSlots = D == 256 ? 2 : 1;     // exchanged tiles K6 holds at once
};

template <typename T, int D>
struct Layout {
  using C = Cfg<D>;
  static constexpr int ld = Tile<T, D>::ld;
  static constexpr int tile = C::kKeys * ld;  // elements of a streamed tile
  // K5: the block's rows, two buffers of each streamed operand, one
  // exchange slot; K6: two fixed tiles of rows, two of each streamed one,
  // kBwdSlots exchange slots.
  static constexpr size_t fwd_bytes =
      sizeof(T) * (kRows + 4 * C::kKeys) * ld + sizeof(float) * C::kXch;
  static constexpr size_t bwd_bytes =
      sizeof(T) * (2 * kRows + 4 * C::kKeys) * ld + sizeof(float) * C::kBwdSlots * C::kXch;
};

// part[j] = (the 16 rows at A) . (rows 8j .. 8j + 7 of the kKeys-row tile
// B)^T over columns [c0, c0 + 64), in the accumulator layout of m16n8: one
// warp's partial. A and B are shared tiles with leading dimension ld.
template <typename T, int D>
__device__ __forceinline__ void partial(float (&part)[Cfg<D>::kKeys / 8][4], const T* A,
                                        const T* B, int ld, int c0, int lane) {
  constexpr int N = Cfg<D>::kKeys;
  const int g = lane >> 2, t4 = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    dots_block<N, 1>(reinterpret_cast<float(&)[1][N / 8][4]>(part), A + g * ld + 2 * t4, B, ld,
                     c0, lane);
  } else {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      uint32_t af[4];
      load_a(af, A + g * ld + c0 + kk * 16 + 2 * t4, ld);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int off = (j * 8 + g) * ld + c0 + kk * 16 + 2 * t4;
        mma_bf16(part[j], af, lds32(B + off), lds32(B + off + 8));
      }
    }
  }
}

// The warps' NT partial tiles through X (SLOTS exchanged tiles of kXch
// floats), SLOTS tiles at a time: their writes, a block barrier, then each
// lane's sums over the warps, in warp order, in place (the lanes keep their
// fragment positions), and a barrier before the next round's writes. The
// caller puts a barrier between the last reads and X's next writes.
template <int D, int NT, int SLOTS = NT>
__device__ __forceinline__ void exchange(float (&s)[NT][Cfg<D>::kKeys / 8][4], float* X,
                                         int warp, int lane) {
  using C = Cfg<D>;
  constexpr int N = C::kKeys;
  constexpr int kWarp = N / 8 * 4 * 32;  // one warp's partial
#pragma unroll
  for (int t0 = 0; t0 < NT; t0 += SLOTS) {
    if (t0 > 0) __syncthreads();  // the last round's reads are done
#pragma unroll
    for (int t = t0; t < t0 + SLOTS; ++t)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          X[(t - t0) * C::kXch + warp * kWarp + (j * 4 + e) * 32 + lane] = s[t][j][e];
    __syncthreads();
#pragma unroll
    for (int t = t0; t < t0 + SLOTS; ++t)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* x = X + (t - t0) * C::kXch + (j * 4 + e) * 32 + lane;
          float v = x[0];
#pragma unroll
          for (int w = 1; w < C::kWarps; ++w) v += x[w * kWarp];
          s[t][j][e] = v;
        }
  }
}

// acc (16 x 64) += p (16 x kKeys, accumulator tiles) . B[:, 64 columns from
// B]: split TF32 in one chain of kKeys / 8 k steps (fp32), or p rounded to
// bf16 (the A fragments of kKeys / 16 k16 steps).
template <typename T, int D>
__device__ __forceinline__ void product(float (&acc)[kCols / 8][4],
                                        const float (&p)[Cfg<D>::kKeys / 8][4], const T* B,
                                        int lane) {
  constexpr int N = Cfg<D>::kKeys;
  if constexpr (std::is_same<T, float>::value) {
    product_3xtf32<kCols, N>(acc, p, B, Tile<float, D>::ld, 0, lane);
  } else {
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t pa[4];
      pack_a(pa, p[2 * ks], p[2 * ks + 1]);
      mma_a_times_tile<D, kCols>(acc, pa, B, ks * 16, lane);
    }
  }
}
}  // namespace wide

// ---- fp32 on the CUDA cores: 128 threads, each a 4 x 8 block of a 64 x 64
// tile (rows rg + 16i, columns kg + 8j; rg = thread / 8, kg = thread % 8)

// acc[i][c] += sum over the 64 streamed rows r of P[rg + 16i][r] * B[r][kg + 8c]:
// P the fp32 (64, kLdp) shared tile, B a (64, D) shared tile.
template <int D>
__device__ __forceinline__ void tile_product(float (&acc)[4][D / 8], const float* P,
                                             const float* B, int rg, int kg) {
  constexpr int ld = Tile<float, D>::ld;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = P[(rg + 16 * i) * kLdp + r];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const float bv = B[r * ld + kg + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], bv, acc[i][c]);
    }
  }
}

// s[i][j] = A[rg + 16i] . B[kg + 8j] over D: two (64, D) shared tiles.
template <int D>
__device__ __forceinline__ void tile_dots(float (&s)[4][8], const float* A, const float* B,
                                          int rg, int kg) {
  constexpr int ld = Tile<float, D>::ld;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(rg + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = B[(kg + 8 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* out, const Strides& st, int b, int h,
                                           int row0, int nrows, const float (&acc)[4][D / 8],
                                           int rg, int kg) {
  float* base = out + b * st.b + h * st.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + rg + 16 * i;
    if (r < nrows) {
#pragma unroll
      for (int c = 0; c < D / 8; ++c) base[(long long)r * st.s + kg + 8 * c] = acc[i][c];
    }
  }
}

}  // namespace flash
