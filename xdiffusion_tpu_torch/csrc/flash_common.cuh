// Pieces shared by the attention kernels, K5 (flash_attention.cu), K6
// (flash_attention_bwd.cu) and K1/K2/K7 (bsc_attention*.cu): 64-row tiles
// copied into padded shared memory with cp.async, the bf16 operand plumbing
// of mma.sync m16n8k16, and the fp32 4 x 8 register tiles of the CUDA-core
// path.
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

// Starts copying rows [row0, row0 + 64) of one (batch, head) slab with row
// stride `rs` into a padded shared tile; rows at or past `nrows` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs,
                                          int row0, int nrows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kVec = D / V;
  for (int e = threadIdx.x; e < kTile * kVec; e += kThreads) {
    const int r = e / kVec;
    const int c = (e - r * kVec) * V;
    const bool valid = row0 + r < nrows;
    const T* s = valid ? src + (long long)(row0 + r) * rs + c : src;
    cp_async16(dst + r * Tile<T, D>::ld + c, s, valid);
  }
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

// acc (16 x D, as D/8 accumulators of 16x8) += a (16 x 16) . B[k0:k0+16, :],
// with B a row-major (k, D) shared tile whose operands ldmatrix.trans reads.
template <int D>
__device__ __forceinline__ void mma_a_times_tile(float (&acc)[D / 8][4],
                                                 const uint32_t (&a)[4], const bf16* B,
                                                 int k0, int lane) {
  constexpr int ld = Tile<bf16, D>::ld;
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n2 = 0; n2 < D / 16; ++n2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, B + r * ld + n2 * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * n2], a, b[0], b[1]);
    mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
  }
}

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
