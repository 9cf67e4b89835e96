// K1's device code, shared by K1 (bsc_attention.cu: heads as column slices
// of (B, S, C = H*D) rows, a head stride of D) and K7 (short_attention.cu:
// one head over the merged B*H axis of head-major tensors). See
// bsc_attention.cu for the numerics, the bound and the design.
//
// Three variants, one per range of the key count Sk; `bsc_plan` in
// ops/flash_attention.py picks one and its launch geometry, and the entry
// points launch exactly that (after checking that it covers the shape):
//
// - packed (Sq, Sk <= 16, or <= 32 for D <= 64): one warp per whole (batch,
//   head) slice, several slices a block. The slice's q, k and v land in the
//   warp's own shared tiles by cp.async; each lane computes a 2 (or 4) x 4
//   (or 8) block of the logits on the CUDA cores in fp32, the quad of lanes
//   that shares a row reduces its max and sum by shuffles, and p goes
//   through a small fp32 tile to the P.V product. No row or key is padded
//   beyond the next multiple of 16.
// - row (Sk <= ROW_MAX_KEYS = 512): a block takes 16 query rows per warp of
//   one (batch, head) and walks the keys once: each 64-key tile of K and
//   then of V is loaded once for all of the block's rows, through a ring of
//   kFwdStages tiles filled by cp.async ahead of the math. Each warp
//   computes its rows' logits once and keeps them, scaled and masked, until
//   the exact row max and sum are known; then it forms p, rounds it once and
//   multiplies P.V. The division p = e / l is Markstein's: one correctly
//   rounded reciprocal a row and three instructions an element.
//   - bf16, D <= 64, Sk <= 256 (the flagship UNet's 16x16 maps): the logits
//     stay in registers (mma.sync m16n8k16 accumulators, 32 floats a lane
//     per 64 keys) and go back to the tensor cores as P from registers.
//   - otherwise the logits go to a per-warp fp32 strip of shared memory:
//     bf16 in the accumulator's fragment order, fp32 (full-fp32 CUDA-core
//     math, each lane a 4 x 8 block: rows r, r+4, r+8, r+12 of the warp's 16,
//     keys k, k+8, ..., k+56) in padded rows.
//   The threshold: at 512 keys the row variant is still as fast as the
//   stream one or faster in both dtypes and both directions on the H100
//   (chip_smoke.py, phase 2, times the two at 256, 384 and 512 keys), and
//   its shared memory fits up to there with 1 to 4 warps a block.
// - stream (longer Sk): the two-pass template below, 64 rows a block.
#pragma once

#include <mma.h>

#include <type_traits>

#include "flash_common.cuh"

// Everything here has internal linkage: the K1, K2 and K7 libraries each
// compile this header, and a function-local static of a template in a named
// namespace would be one object across all three once loaded (the flag that
// a kernel's shared-memory limit was raised, for one).
namespace {

// ---- stream: two passes over 64-key tiles ------------------------------------
//
// Each block takes one (batch, head, 64-row query tile) and walks the keys in
// tiles of 64, twice: the first pass finds each row's max and sum, the second
// forms p = exp(s - max) / sum, rounds it to v's dtype and accumulates P.V;
// Q.K^T is computed twice. Each of the 4 warps owns 16 query rows; bf16 runs
// the products on wmma, fp32 on the CUDA cores.
namespace bsc_stream {


using namespace nvcuda;

constexpr int kRows = 64;   // query rows per block, 16 per warp
constexpr int kKeys = 64;   // keys per tile
constexpr int kThreads = 128;

// Row padding (elements) of the shared tiles: 16 bytes keeps wmma's ldm a
// multiple of 8 for bf16; one element spreads the fp32 rows over the banks.
template <typename T>
struct Pad {
  static constexpr int value = std::is_same<T, float>::value ? 1 : 8;
};

template <typename T, int D>
struct Layout {
  static constexpr int ld = D + Pad<T>::value;             // Q, K, V rows
  static constexpr int ldp = kKeys + Pad<T>::value;        // P rows
  static constexpr int lds = (D > kKeys ? D : kKeys) + 4;  // S / O staging (fp32)
  static constexpr size_t s_bytes = sizeof(float) * kRows * lds;
  static constexpr size_t bytes =
      s_bytes + sizeof(T) * (3 * kRows * ld + kRows * ldp);
};

// Copies rows [row0, row0 + 64) of a (rows, D) slab with row stride `rs`
// into shared memory, 16 bytes per load; rows at or past `nrows` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long rs,
                                          int row0, int nrows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kVecPerRow = D / V;
  constexpr int ld = Layout<T, D>::ld;
  for (int e = threadIdx.x; e < kRows * kVecPerRow; e += kThreads) {
    const int r = e / kVecPerRow;
    const int c = (e - r * kVecPerRow) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * rs + c);
    const T* pv = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * ld + c + i] = pv[i];
  }
}

// S[warp rows, 0:64] = Q[warp rows] . K_tile^T (raw dot products, fp32).
template <typename T, int D>
__device__ __forceinline__ void scores(const T* Qs, const T* Ks, float* S,
                                       int warp, int lane) {
  constexpr int ld = Layout<T, D>::ld;
  constexpr int lds = Layout<T, D>::lds;
  if constexpr (std::is_same<T, float>::value) {
    const int r = warp * 16 + (lane >> 1);
    const int j0 = (lane & 1) * 32;
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * ld + d];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = fmaf(qv, Ks[(j0 + j) * ld + d], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) S[r * lds + j0 + j] = acc[j];
  } else {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[kKeys / 16];
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) wmma::fill_fragment(c[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + warp * 16 * ld + kk * 16, ld);
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        // K^T (d, key) is K (key, d) read column-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(b, Ks + j * 16 * ld + kk * 16, ld);
        wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j)
      wmma::store_matrix_sync(S + warp * 16 * lds + j * 16, c[j], lds,
                              wmma::mem_row_major);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bsc_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, int sq,
                         int sk, long long q_bs, long long q_rs, long long k_bs,
                         long long k_rs, long long v_bs, long long v_rs,
                         long long o_bs, long long o_rs, float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);
  T* Qs = reinterpret_cast<T*>(smem + L::s_bytes);
  T* Ks = Qs + kRows * L::ld;
  T* Vs = Ks + kRows * L::ld;
  T* Ps = Vs + kRows * L::ld;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = q + b * q_bs + (long long)h * D;
  const T* kb = k + b * k_bs + (long long)h * D;
  const T* vb = v + b * v_bs + (long long)h * D;
  T* ob = out + b * o_bs + (long long)h * D;

  load_rows<T, D>(Qs, qb, q_rs, q0, sq);

  // Each lane pair owns one query row; each lane half of its columns.
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const float* srow = S + row * L::lds + half * 32;
  const int ntiles = (sk + kKeys - 1) / kKeys;

  // Pass 1: row max and sum of exp over all keys (online over tiles).
  float m = -INFINITY, l = 0.0f;
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();  // Q is loaded; the previous K tile is consumed
    load_rows<T, D>(Ks, kb, k_rs, t * kKeys, sk);
    __syncthreads();
    scores<T, D>(Qs, Ks, S, warp, lane);
    __syncwarp();
    const int key0 = t * kKeys + half * 32;
    float tm = -INFINITY;
    for (int j = 0; j < 32; ++j)
      if (key0 + j < sk) tm = fmaxf(tm, srow[j] * scale);
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    const float mn = fmaxf(m, tm);  // finite: every tile holds a valid key
    float ts = 0.0f;
    for (int j = 0; j < 32; ++j)
      if (key0 + j < sk) ts += expf(srow[j] * scale - mn);
    ts += __shfl_xor_sync(0xffffffffu, ts, 1);
    l = l * expf(m - mn) + ts;
    m = mn;
    __syncwarp();  // S is read before the next tile's scores overwrite it
  }

  // Pass 2: P = exp(s - m) / l rounded to T, O += P . V.
  constexpr int kHalfD = D / 2;
  float o_simt[std::is_same<T, float>::value ? kHalfD : 1];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_frag[D / 16];
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int c = 0; c < kHalfD; ++c) o_simt[c] = 0.0f;
  } else {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(o_frag[j], 0.0f);
  }
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    load_rows<T, D>(Ks, kb, k_rs, t * kKeys, sk);
    load_rows<T, D>(Vs, vb, v_rs, t * kKeys, sk);
    __syncthreads();
    scores<T, D>(Qs, Ks, S, warp, lane);
    __syncwarp();
    const int key0 = t * kKeys + half * 32;
    T* prow = Ps + row * L::ldp + half * 32;
    for (int j = 0; j < 32; ++j) {
      const float p = key0 + j < sk ? expf(srow[j] * scale - m) / l : 0.0f;
      prow[j] = from_f<T>(p);
    }
    __syncwarp();
    if constexpr (std::is_same<T, float>::value) {
      const float* pr = Ps + row * L::ldp;
      for (int j = 0; j < kKeys; ++j) {
        const float p = pr[j];
#pragma unroll
        for (int c = 0; c < kHalfD; ++c)
          o_simt[c] = fmaf(p, Vs[j * L::ld + half * kHalfD + c], o_simt[c]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + warp * 16 * L::ldp + kk * 16, L::ldp);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, Vs + kk * 16 * L::ld + j * 16, L::ld);
          wmma::mma_sync(o_frag[j], a, bf, o_frag[j]);
        }
      }
    }
  }

  const int qi = q0 + row;
  if constexpr (std::is_same<T, float>::value) {
    if (qi < sq) {
#pragma unroll
      for (int c = 0; c < kHalfD; ++c)
        ob[(long long)qi * o_rs + half * kHalfD + c] = o_simt[c];
    }
  } else {
    // Stage the warp's 16 x D accumulator through S (its own rows only).
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::store_matrix_sync(S + warp * 16 * L::lds + j * 16, o_frag[j], L::lds,
                              wmma::mem_row_major);
    __syncwarp();
    if (qi < sq) {
      const float* orow = S + row * L::lds + half * kHalfD;
      for (int c = 0; c < kHalfD; ++c)
        ob[(long long)qi * o_rs + half * kHalfD + c] = from_f<T>(orow[c]);
    }
  }
}

}  // namespace bsc_stream

namespace bsc {

using flash::bf16;

constexpr int kKeyTile = 64;        // keys per tile of the row variant
constexpr int kFwdStages = 4;       // K1 row variant: 64-key tiles in the cp.async ring
constexpr int kDqStages = 2;        // K2 row dq launch: (K, V) tile pairs in the ring
constexpr int kRegKeys = 256;       // bf16, D <= 64: longest Sk whose logits stay in registers
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may opt into
enum { kPacked = 0, kRow = 1, kStream = 2 };

// The plan of `bsc_plan` (ops/flash_attention.py), as 13 ints: the variant,
// slices (packed) or warps (row) per block, the padded slice length (packed)
// or strip length (row), then grid x, y, z, threads and shared bytes of up
// to two launches.
struct Launch {
  int gx, gy, gz, threads, smem;
};
struct Plan {
  int variant, per_block, tile;
  Launch launch[2];
};

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// A staged shared row: D elements and 16 bytes of padding, so rows stay
// 16-byte aligned for cp.async and consecutive rows start in other banks.
template <typename T, int D>
struct Row {
  static constexpr int ld = D + 16 / (int)sizeof(T);
  static constexpr int bytes = ld * (int)sizeof(T);
};

// Starts copying rows [row0, row0 + nrows) of a (rows, D) slab with row
// stride `rs` into a shared tile of Row<T, D>::ld; rows at or past `valid`
// are zero-filled. Thread `id` of `count` issues every count-th copy.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long rs, int row0,
                                           int nrows, int valid, int id, int count) {
  constexpr int V = 16 / sizeof(T), kVec = D / V;
  for (int e = id; e < nrows * kVec; e += count) {
    const int r = e / kVec, c = (e - r * kVec) * V;
    const bool ok = row0 + r < valid;
    flash::cp_async16(dst + r * Row<T, D>::ld + c, ok ? src + (long long)(row0 + r) * rs + c : src,
                      ok);
  }
}

// Four consecutive elements as floats, and back.
__device__ __forceinline__ void ld4(float (&o)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void ld4(float (&o)[4], const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void st4(bf16* p, const float (&o)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(flash::pack_bf16(o[0], o[1]),
                                            flash::pack_bf16(o[2], o[3]));
}

// a / b rounded to nearest from rb = __frcp_rn(b): Markstein's correction of
// a * rb, which gives the correctly rounded quotient (normal range), in three
// instructions where a division takes about ten. Used for p = e / l.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = a * rb;
  return fmaf(fmaf(-q, b, a), rb, q);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// Over the 8 lanes lane ^ {1, 2, 4} (a row group of the fp32 row variant).
__device__ __forceinline__ float oct_max(float v) {
  v = quad_max(v);
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ float oct_sum(float v) {
  v = quad_sum(v);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// ---- packed: one warp per (batch, head) slice of at most NS rows and keys ----
//
// Lane (g = lane / 4, t4 = lane % 4) owns rows g + 8i (i < NS / 8) and keys
// t4 + 4j (j < NS / 4) of the logits; for the products it owns rows (or keys)
// g + 8i and the column chunks 4 * (t4 + 4c) (c < D / 16) of the output.

template <typename T, int D, int NS>
struct Packed {
  static constexpr int ld = Row<T, D>::ld;
  static constexpr int ldm = NS + 4;  // fp32 p / ds tile rows
  // The slice's q, k, v (and g) tiles and the p (and ds) tile(s) of a warp.
  __host__ __device__ static constexpr int warp_bytes(bool backward) {
    return (backward ? 4 : 3) * NS * Row<T, D>::bytes + (backward ? 2 : 1) * NS * ldm * 4;
  }
};

// s[i][j] = A[g + 8i] . B[t4 + 4j] over D, for two (NS, ld) shared tiles.
template <typename T, int D, int NS>
__device__ __forceinline__ void quad_dots(float (&s)[NS / 8][NS / 4], const T* A, const T* B,
                                          int g, int t4) {
  constexpr int ld = Row<T, D>::ld;
#pragma unroll
  for (int i = 0; i < NS / 8; ++i)
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float a[NS / 8][4], b[NS / 4][4];
#pragma unroll
    for (int i = 0; i < NS / 8; ++i) ld4(a[i], A + (g + 8 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) ld4(b[j], B + (t4 + 4 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < NS / 8; ++i)
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
  }
}

// In place: raw dots s -> p = exp(s * scale - max) / sum rounded to T; keys
// at or past sk and rows at or past sq get 0.
template <typename T, int NS>
__device__ __forceinline__ void quad_softmax(float (&s)[NS / 8][NS / 4], int sq, int sk,
                                             float scale, int g, int t4) {
#pragma unroll
  for (int i = 0; i < NS / 8; ++i) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      s[i][j] = t4 + 4 * j < sk ? s[i][j] * scale : -INFINITY;
      m = fmaxf(m, s[i][j]);
    }
    m = quad_max(m);  // finite: key 0 is valid
    float l = 0.0f;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      s[i][j] = expf(s[i][j] - m);
      l += s[i][j];
    }
    l = quad_sum(l);
    const bool row_ok = g + 8 * i < sq;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) s[i][j] = row_ok ? round_to<T>(s[i][j] / l) : 0.0f;
  }
}

// acc[i][c][e] += sum over r < n of M(g + 8i, r) * B[r][4 * (t4 + 4c) + e],
// M an fp32 (NS, NS + 4) shared tile read as M[row][r], or as M[r][row]
// (kTrans), B an (NS, ld) shared tile.
template <typename T, int D, int NS, bool kTrans>
__device__ __forceinline__ void quad_product(float (&acc)[NS / 8][D / 16][4], const float* M,
                                             const T* B, int n, int g, int t4) {
  constexpr int ld = Row<T, D>::ld, ldm = Packed<T, D, NS>::ldm;
#pragma unroll
  for (int i = 0; i < NS / 8; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    float m[NS / 8];
#pragma unroll
    for (int i = 0; i < NS / 8; ++i)
      m[i] = kTrans ? M[r * ldm + g + 8 * i] : M[(g + 8 * i) * ldm + r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      float b[4];
      ld4(b, B + r * ld + 4 * (t4 + 4 * c));
#pragma unroll
      for (int i = 0; i < NS / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = fmaf(m[i], b[e], acc[i][c][e]);
    }
  }
}

// Rows g + 8i (those < nrows) of acc to out (row stride rs), rounded to T.
template <typename T, int D, int NS>
__device__ __forceinline__ void quad_store(T* out, long long rs,
                                           const float (&acc)[NS / 8][D / 16][4], int nrows,
                                           int g, int t4) {
#pragma unroll
  for (int i = 0; i < NS / 8; ++i) {
    const int r = g + 8 * i;
    if (r < nrows) {
#pragma unroll
      for (int c = 0; c < D / 16; ++c) st4(out + (long long)r * rs + 4 * (t4 + 4 * c), acc[i][c]);
    }
  }
}

struct Fwd {
  const void *q, *k, *v;
  void* out;
  int b, sq, sk, heads;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  float scale;
};

template <typename T, int D, int NS>
__global__ void __launch_bounds__(128) packed_fwd(const Fwd a) {
  using P = Packed<T, D, NS>;
  constexpr int ld = P::ld;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slice = blockIdx.x * (blockDim.x >> 5) + warp;
  if (slice >= a.b * a.heads) return;  // no block barrier follows
  const int b = slice / a.heads, h = slice - b * a.heads;
  T* Qs = reinterpret_cast<T*>(smem + warp * P::warp_bytes(false));
  T* Ks = Qs + NS * ld;
  T* Vs = Ks + NS * ld;
  float* Ps = reinterpret_cast<float*>(Vs + NS * ld);
  const long long hd = (long long)h * D;
  stage_rows<T, D>(Qs, static_cast<const T*>(a.q) + b * a.q_bs + hd, a.q_rs, 0, NS, a.sq, lane, 32);
  stage_rows<T, D>(Ks, static_cast<const T*>(a.k) + b * a.k_bs + hd, a.k_rs, 0, NS, a.sk, lane, 32);
  stage_rows<T, D>(Vs, static_cast<const T*>(a.v) + b * a.v_bs + hd, a.v_rs, 0, NS, a.sk, lane, 32);
  flash::cp_async_commit();
  flash::cp_async_wait<0>();
  __syncwarp();

  const int g = lane >> 2, t4 = lane & 3;
  float s[NS / 8][NS / 4];
  quad_dots<T, D, NS>(s, Qs, Ks, g, t4);
  quad_softmax<T, NS>(s, a.sq, a.sk, a.scale, g, t4);
#pragma unroll
  for (int i = 0; i < NS / 8; ++i)
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) Ps[(g + 8 * i) * P::ldm + t4 + 4 * j] = s[i][j];
  __syncwarp();
  float acc[NS / 8][D / 16][4];
  quad_product<T, D, NS, false>(acc, Ps, Vs, a.sk, g, t4);
  quad_store<T, D, NS>(static_cast<T*>(a.out) + b * a.o_bs + hd, a.o_rs, acc, a.sq, g, t4);
}

// ---- row: 16 query rows a warp, the logit row held in a shared strip --------

// Block layout: the block's query rows (`row_tiles` of them: q, and g in
// K2), then a ring of `stages` stages of `tiles_per_stage` 64-row tiles,
// then the strips (`strips` per warp) of fp32 values.
template <typename T, int D>
__host__ __device__ constexpr int row_block_bytes(int warps, int keys, int stages,
                                                  int tiles_per_stage, int strips,
                                                  int row_tiles) {
  return row_tiles * 16 * warps * Row<T, D>::bytes +
         stages * tiles_per_stage * kKeyTile * Row<T, D>::bytes +
         strips * warps * 16 * (is_f32<T>() ? keys + 8 : keys) * 4;
}

// Step u of K1's row walk: K tile u for u < nt, then V tile u - nt, into
// ring slot u % kFwdStages.
template <typename T, int D>
__device__ __forceinline__ void fwd_step(T* ring, const T* kb, const T* vb, const Fwd& a,
                                         int u, int nt) {
  const bool is_k = u < nt;
  stage_rows<T, D>(ring + (u % kFwdStages) * kKeyTile * Row<T, D>::ld, is_k ? kb : vb,
                   is_k ? a.k_rs : a.v_rs, (is_k ? u : u - nt) * kKeyTile, kKeyTile, a.sk,
                   threadIdx.x, blockDim.x);
}

// The fp32 strip of a warp: 16 rows of `lds` = keys + 8 floats. Lane
// (rg = lane / 8, kg = lane % 8) owns rows rg + 4i and, of each 64-key
// tile, keys kg + 8j. s[i][j] = A[rg + 4i] . B[kg + 8j] over D (float4 along
// D), A the warp's 16 rows and B a 64-row tile.
template <int D>
__device__ __forceinline__ void warp_dots(float (&s)[4][8], const float* A, const float* B,
                                          int rg, int kg) {
  constexpr int ld = Row<float, D>::ld;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float a[4][4], b[8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld4(a[i], A + (rg + 4 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) ld4(b[j], B + (kg + 8 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
  }
}

// acc[i][c] += sum over the tile's 64 keys k of M[rg + 4i][k] * B[k][kg + 8c]:
// M the warp's strip at the tile's first key (row stride lds), B a 64-row tile.
template <int D>
__device__ __forceinline__ void warp_product(float (&acc)[4][D / 8], const float* M, int lds,
                                             const float* B, int rg, int kg) {
  constexpr int ld = Row<float, D>::ld;
#pragma unroll 4
  for (int k = 0; k < kKeyTile; ++k) {
    float m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = M[(rg + 4 * i) * lds + k];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const float b = B[k * ld + kg + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(m[i], b, acc[i][c]);
    }
  }
}

template <int D>
__device__ __forceinline__ void warp_store(float* out, long long rs, int row0, int nrows,
                                           const float (&acc)[4][D / 8], int rg, int kg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + rg + 4 * i;
    if (r < nrows) {
#pragma unroll
      for (int c = 0; c < D / 8; ++c) out[(long long)r * rs + kg + 8 * c] = acc[i][c];
    }
  }
}

// bf16 accumulator rows r0 = g and r1 = g + 8 of a warp's 16 (D / 8 blocks of
// 16 x 8) to out, those < nrows.
template <int D>
__device__ __forceinline__ void frag_store(bf16* out, long long rs, int r0, int nrows,
                                           const float (&acc)[D / 8][4], int t4) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (r0 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)r0 * rs + col) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (r0 + 8 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)(r0 + 8) * rs + col) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

// One 16 x 8 block of a bf16 warp's logits: c = A-rows . (8 rows of a tile)^T
// from the A fragments af and the tile's rows n0 .. n0 + 7.
template <int D>
__device__ __forceinline__ void frag_dots(float (&c)[4], const uint32_t (&af)[D / 16][4],
                                          const bf16* tile, int n0, int g, int t4) {
  constexpr int ld = Row<bf16, D>::ld;
  c[0] = c[1] = c[2] = c[3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (n0 + g) * ld + kk * 16 + 2 * t4;
    flash::mma_bf16(c, af[kk], flash::lds32(tile + off), flash::lds32(tile + off + 8));
  }
}

// Scales and masks one 16 x 8 logit block (keys key0, key0 + 1 per lane);
// `full`: the whole 64-key tile is valid (a branch the warp takes as one).
__device__ __forceinline__ void scale_mask(float (&c)[4], int key0, int sk, float scale,
                                           bool full = false) {
  if (full) {
    c[0] *= scale, c[1] *= scale, c[2] *= scale, c[3] *= scale;
    return;
  }
  const bool v0 = key0 < sk, v1 = key0 + 1 < sk;
  c[0] = v0 ? c[0] * scale : -INFINITY;
  c[1] = v1 ? c[1] * scale : -INFINITY;
  c[2] = v0 ? c[2] * scale : -INFINITY;
  c[3] = v1 ? c[3] * scale : -INFINITY;
}

// The bf16 strip of a warp: nt * 8 blocks of 16 x 8 in fragment order, a
// float4 per lane per block (rows g: .x .y; row g + 8: .z .w).
__device__ __forceinline__ float4* frag_at(float* strip, int blk, int lane) {
  return reinterpret_cast<float4*>(strip) + blk * 32 + lane;
}

template <int D>
__global__ void __launch_bounds__(128) row_fwd_bf16(const Fwd a, int nt) {
  constexpr int ld = Row<bf16, D>::ld, tile = kKeyTile * ld;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * 16 * nw, h = blockIdx.y, b = blockIdx.z;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + 16 * nw * ld;
  float* strip = reinterpret_cast<float*>(ring + kFwdStages * tile) + (size_t)warp * nt * 8 * 128;
  const long long hd = (long long)h * D;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_bs + hd;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_bs + hd;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_bs + hd;

  stage_rows<bf16, D>(Qs, qb, a.q_rs, q0, 16 * nw, a.sq, threadIdx.x, blockDim.x);
  for (int u = 0; u < kFwdStages - 1; ++u) {  // Q joins the first group
    if (u < 2 * nt) fwd_step<bf16, D>(ring, kb, vb, a, u, nt);
    flash::cp_async_commit();
  }

  const float scale = a.scale;
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, r0 = 1.0f, r1 = 1.0f;

  // Steps 0 .. nt-1 walk the K tiles, nt .. 2nt-1 the V tiles; the next
  // kFwdStages - 1 steps' tiles load while this one computes.
  for (int u = 0; u < 2 * nt; ++u) {
    flash::cp_async_wait<kFwdStages - 2>();
    __syncthreads();  // step u's tile has landed; step u - 1's slot is free
    if (u + kFwdStages - 1 < 2 * nt) fwd_step<bf16, D>(ring, kb, vb, a, u + kFwdStages - 1, nt);
    flash::cp_async_commit();
    const bf16* Tt = ring + (u % kFwdStages) * tile;
    if (u == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        flash::load_a(qf[kk], Qs + (warp * 16 + g) * ld + kk * 16 + 2 * t4, ld);
    }
    if (u < nt) {
#pragma unroll
      for (int n8 = 0; n8 < kKeyTile / 8; ++n8) {
        float c[4];
        frag_dots<D>(c, qf, Tt, n8 * 8, g, t4);
        scale_mask(c, u * kKeyTile + n8 * 8 + 2 * t4, a.sk, scale);
        m0 = fmaxf(m0, fmaxf(c[0], c[1]));
        m1 = fmaxf(m1, fmaxf(c[2], c[3]));
        *frag_at(strip, u * 8 + n8, lane) = make_float4(c[0], c[1], c[2], c[3]);
      }
    } else {
      if (u == nt) {  // the exact row max, then e = exp(s - max) and its sum
        m0 = quad_max(m0);
        m1 = quad_max(m1);
        for (int blk = 0; blk < nt * 8; ++blk) {
          float4 x = *frag_at(strip, blk, lane);
          x.x = expf(x.x - m0), x.y = expf(x.y - m0);
          x.z = expf(x.z - m1), x.w = expf(x.w - m1);
          l0 += x.x + x.y;
          l1 += x.z + x.w;
          *frag_at(strip, blk, lane) = x;
        }
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        r0 = __frcp_rn(l0);
        r1 = __frcp_rn(l1);
      }
      const int t = u - nt;
#pragma unroll
      for (int ks = 0; ks < kKeyTile / 16; ++ks) {
        const float4 x0 = *frag_at(strip, t * 8 + 2 * ks, lane);
        const float4 x1 = *frag_at(strip, t * 8 + 2 * ks + 1, lane);
        const float c0[4] = {div_rn(x0.x, l0, r0), div_rn(x0.y, l0, r0), div_rn(x0.z, l1, r1),
                             div_rn(x0.w, l1, r1)};
        const float c1[4] = {div_rn(x1.x, l0, r0), div_rn(x1.y, l0, r0), div_rn(x1.z, l1, r1),
                             div_rn(x1.w, l1, r1)};
        uint32_t pa[4];
        flash::pack_a(pa, c0, c1);  // p rounded to bf16 once
        flash::mma_a_times_tile<D>(acc, pa, Tt, ks * 16, lane);
      }
    }
  }
  frag_store<D>(static_cast<bf16*>(a.out) + b * a.o_bs + hd, a.o_rs, q0 + warp * 16 + g,
                a.sq, acc, t4);
}

// bf16, D <= 64, Sk <= kRegKeys: the same walk with the warp's logits held in
// registers (NT tiles of 16 x 64, 32 floats a lane each) instead of a strip.
template <int D, int NT>
__global__ void __launch_bounds__(128, 3) row_fwd_bf16_regs(const Fwd a) {
  constexpr int ld = Row<bf16, D>::ld, tile = kKeyTile * ld;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * 16 * nw, h = blockIdx.y, b = blockIdx.z;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + 16 * nw * ld;
  const long long hd = (long long)h * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_bs + hd;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_bs + hd;

  stage_rows<bf16, D>(Qs, static_cast<const bf16*>(a.q) + b * a.q_bs + hd, a.q_rs, q0,
                      16 * nw, a.sq, threadIdx.x, blockDim.x);
#pragma unroll
  for (int u = 0; u < kFwdStages - 1; ++u) {  // Q joins the first group
    if (u < 2 * NT) fwd_step<bf16, D>(ring, kb, vb, a, u, NT);
    flash::cp_async_commit();
  }

  const float scale = a.scale;
  uint32_t qf[D / 16][4];
  float s[NT][kKeyTile / 8][4], acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, r0 = 1.0f, r1 = 1.0f;

#pragma unroll
  for (int u = 0; u < 2 * NT; ++u) {
    flash::cp_async_wait<kFwdStages - 2>();
    __syncthreads();  // step u's tile has landed; step u - 1's slot is free
    if (u + kFwdStages - 1 < 2 * NT) fwd_step<bf16, D>(ring, kb, vb, a, u + kFwdStages - 1, NT);
    flash::cp_async_commit();
    const bf16* Tt = ring + (u % kFwdStages) * tile;
    if (u == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        flash::load_a(qf[kk], Qs + (warp * 16 + g) * ld + kk * 16 + 2 * t4, ld);
    }
    if (u < NT) {
#pragma unroll
      for (int n8 = 0; n8 < kKeyTile / 8; ++n8) {
        float* c = s[u][n8];
        frag_dots<D>(s[u][n8], qf, Tt, n8 * 8, g, t4);
        scale_mask(s[u][n8], u * kKeyTile + n8 * 8 + 2 * t4, a.sk, scale,
                   (u + 1) * kKeyTile <= a.sk);
        m0 = fmaxf(m0, fmaxf(c[0], c[1]));
        m1 = fmaxf(m1, fmaxf(c[2], c[3]));
      }
    } else {
      if (u == NT) {  // the exact row max, then e = exp(s - max) and its sum
        m0 = quad_max(m0);
        m1 = quad_max(m1);
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int n8 = 0; n8 < kKeyTile / 8; ++n8) {
            float* c = s[t][n8];
            c[0] = expf(c[0] - m0), c[1] = expf(c[1] - m0);
            c[2] = expf(c[2] - m1), c[3] = expf(c[3] - m1);
            l0 += c[0] + c[1];
            l1 += c[2] + c[3];
          }
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        r0 = __frcp_rn(l0);
        r1 = __frcp_rn(l1);
      }
      const int t = u - NT;
#pragma unroll
      for (int ks = 0; ks < kKeyTile / 16; ++ks) {
        float c[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* x = s[t][2 * ks + half];
          c[half][0] = div_rn(x[0], l0, r0), c[half][1] = div_rn(x[1], l0, r0);
          c[half][2] = div_rn(x[2], l1, r1), c[half][3] = div_rn(x[3], l1, r1);
        }
        uint32_t pa[4];
        flash::pack_a(pa, c[0], c[1]);  // p rounded to bf16 once
        flash::mma_a_times_tile<D>(acc, pa, Tt, ks * 16, lane);
      }
    }
  }
  frag_store<D>(static_cast<bf16*>(a.out) + b * a.o_bs + hd, a.o_rs, q0 + warp * 16 + g,
                a.sq, acc, t4);
}

template <int D>
__global__ void __launch_bounds__(128) row_fwd_f32(const Fwd a, int nt) {
  constexpr int ld = Row<float, D>::ld, tile = kKeyTile * ld;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, kg = lane & 7;
  const int q0 = blockIdx.x * 16 * nw, h = blockIdx.y, b = blockIdx.z;
  const int lds = nt * kKeyTile + 8;
  float* Qs = reinterpret_cast<float*>(smem);
  float* ring = Qs + 16 * nw * ld;
  float* strip = ring + kFwdStages * tile + (size_t)warp * 16 * lds;
  const float* Qw = Qs + warp * 16 * ld;
  const long long hd = (long long)h * D;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_bs + hd;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_bs + hd;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_bs + hd;

  stage_rows<float, D>(Qs, qb, a.q_rs, q0, 16 * nw, a.sq, threadIdx.x, blockDim.x);
  for (int u = 0; u < kFwdStages - 1; ++u) {  // Q joins the first group
    if (u < 2 * nt) fwd_step<float, D>(ring, kb, vb, a, u, nt);
    flash::cp_async_commit();
  }

  const float scale = a.scale;
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY}, acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.0f;

  for (int u = 0; u < 2 * nt; ++u) {
    flash::cp_async_wait<kFwdStages - 2>();
    __syncthreads();  // step u's tile has landed; step u - 1's slot is free
    if (u + kFwdStages - 1 < 2 * nt) fwd_step<float, D>(ring, kb, vb, a, u + kFwdStages - 1, nt);
    flash::cp_async_commit();
    const float* Tt = ring + (u % kFwdStages) * tile;
    if (u < nt) {
      float s[4][8];
      warp_dots<D>(s, Qw, Tt, rg, kg);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = u * kKeyTile + kg + 8 * j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = key < a.sk ? s[i][j] * scale : -INFINITY;
          m[i] = fmaxf(m[i], x);
          strip[(rg + 4 * i) * lds + key] = x;
        }
      }
    } else {
      if (u == nt) {  // p = exp(s - max) / sum over the lane's own keys
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* row = strip + (rg + 4 * i) * lds;
          const float mi = oct_max(m[i]);
          float l = 0.0f;
          for (int key = kg; key < nt * kKeyTile; key += 8) {
            row[key] = expf(row[key] - mi);
            l += row[key];
          }
          l = oct_sum(l);
          const float rl = __frcp_rn(l);
          for (int key = kg; key < nt * kKeyTile; key += 8) row[key] = div_rn(row[key], l, rl);
        }
        __syncwarp();  // the product reads the other lanes' keys
      }
      warp_product<D>(acc, strip + (u - nt) * kKeyTile, lds, Tt, rg, kg);
    }
  }
  warp_store<D>(static_cast<float*>(a.out) + b * a.o_bs + hd, a.o_rs, q0 + warp * 16, a.sq,
                acc, rg, kg);
}

// ---- launch ------------------------------------------------------------------

// Opens `kernel` to all the dynamic shared memory its static share leaves
// once, then launches it with the plan's geometry.
template <typename K, typename... Args>
int launch(K kernel, bool* ready, const Launch& l, cudaStream_t st, Args... args) {
  if (!*ready) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit - (int)attr.sharedSizeBytes);
    if (e != cudaSuccess) return (int)e;
    *ready = true;
  }
  kernel<<<dim3(l.gx, l.gy, l.gz), l.threads, l.smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// Whether launch l of a plan covers (b, heads) slices, or rows [0, n) of an
// axis in blocks of `per_block` over (heads, b), with `threads` threads and
// at least `bytes` of shared memory.
inline bool covers_slices(const Launch& l, int per_block, int slices, int bytes) {
  return l.gy == 1 && l.gz == 1 && l.threads == 32 * per_block &&
         (long long)l.gx * per_block >= slices && l.smem >= bytes && l.smem <= kSmemLimit;
}
inline bool covers_rows(const Launch& l, int per_block, int n, int heads, int b, int threads,
                        int bytes) {
  return l.gy == heads && l.gz == b && l.threads == threads &&
         (long long)l.gx * per_block >= n && l.smem >= bytes && l.smem <= kSmemLimit;
}

inline bool packed_fits(const Plan& p, int sq, int sk, int d) {
  return (p.tile == 16 || (p.tile == 32 && d <= 64)) && sq <= p.tile && sk <= p.tile &&
         p.per_block >= 1 && p.per_block <= 4;
}
inline bool row_fits(const Plan& p, int sk) {
  return p.tile % kKeyTile == 0 && p.tile >= sk && (p.per_block == 1 || p.per_block == 2 ||
                                                    p.per_block == 4);
}

template <typename T, int D, int NS>
int forward_packed(const Fwd& a, const Plan& p, cudaStream_t st) {
  static bool ready = false;
  if (!covers_slices(p.launch[0], p.per_block, a.b * a.heads,
                     p.per_block * Packed<T, D, NS>::warp_bytes(false)))
    return XD_ERR_SHAPE;
  return launch(packed_fwd<T, D, NS>, &ready, p.launch[0], st, a);
}

template <typename T, int D>
int forward(const Fwd& a, const Plan& p, cudaStream_t st) {
  if (p.variant == kPacked) {
    if (!packed_fits(p, a.sq, a.sk, D)) return XD_ERR_SHAPE;
    if (p.tile == 16) return forward_packed<T, D, 16>(a, p, st);
    if constexpr (D <= 64) return forward_packed<T, D, 32>(a, p, st);
    return XD_ERR_SHAPE;
  }
  if (p.variant == kRow) {
    const int nw = p.per_block, nt = p.tile / kKeyTile;
    const bool regs = !is_f32<T>() && D <= 64 && p.tile <= kRegKeys;
    if (!row_fits(p, a.sk) ||
        !covers_rows(p.launch[0], 16 * nw, a.sq, a.heads, a.b, 32 * nw,
                     row_block_bytes<T, D>(nw, p.tile, kFwdStages, 1, regs ? 0 : 1, 1)))
      return XD_ERR_SHAPE;
    if constexpr (is_f32<T>()) {
      static bool ready = false;
      return launch(row_fwd_f32<D>, &ready, p.launch[0], st, a, nt);
    } else {
      if constexpr (D <= 64) {
        static bool ready[kRegKeys / kKeyTile] = {};
        switch (regs ? nt : 0) {
          case 1: return launch(row_fwd_bf16_regs<D, 1>, &ready[0], p.launch[0], st, a);
          case 2: return launch(row_fwd_bf16_regs<D, 2>, &ready[1], p.launch[0], st, a);
          case 3: return launch(row_fwd_bf16_regs<D, 3>, &ready[2], p.launch[0], st, a);
          case 4: return launch(row_fwd_bf16_regs<D, 4>, &ready[3], p.launch[0], st, a);
          default: break;
        }
      }
      static bool ready = false;
      return launch(row_fwd_bf16<D>, &ready, p.launch[0], st, a, nt);
    }
  }
  if (p.variant == kStream) {
    static bool ready = false;
    if (!covers_rows(p.launch[0], bsc_stream::kRows, a.sq, a.heads, a.b, bsc_stream::kThreads,
                     (int)bsc_stream::Layout<T, D>::bytes))
      return XD_ERR_SHAPE;
    return launch(bsc_stream::bsc_attention_kernel<T, D>, &ready, p.launch[0], st,
                  static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                  static_cast<const T*>(a.v), static_cast<T*>(a.out), a.sq, a.sk, a.q_bs,
                  a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs, a.o_bs, a.o_rs, a.scale);
  }
  return XD_ERR_SHAPE;
}

// The forward on dtype code `dtype` and head dim d (a template, so that only
// the libraries that call it compile K1's kernels).
template <typename = void>
int forward(const Fwd& a, const Plan& p, int d, int dtype, cudaStream_t st) {
  if (a.b <= 0 || a.sq <= 0 || a.sk <= 0 || a.heads <= 0) return XD_ERR_SHAPE;
  if (dtype != XD_F32 && dtype != XD_BF16) return XD_ERR_DTYPE;
  const bool f32 = dtype == XD_F32;
  switch (d) {
    case 16: return f32 ? forward<float, 16>(a, p, st) : forward<bf16, 16>(a, p, st);
    case 32: return f32 ? forward<float, 32>(a, p, st) : forward<bf16, 32>(a, p, st);
    case 64: return f32 ? forward<float, 64>(a, p, st) : forward<bf16, 64>(a, p, st);
    case 128: return f32 ? forward<float, 128>(a, p, st) : forward<bf16, 128>(a, p, st);
    default: return XD_ERR_SHAPE;
  }
}

inline Plan read_plan(const int* v) {
  return Plan{v[0], v[1], v[2], {{v[3], v[4], v[5], v[6], v[7]}, {v[8], v[9], v[10], v[11], v[12]}}};
}

}  // namespace bsc

}  // namespace
