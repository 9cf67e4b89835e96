// K1's device code: the two-pass attention template over (B, S, C=H*D)
// rows with a head stride of D, shared by K1 (bsc_attention.cu, heads as
// column slices) and K7 (short_attention.cu, one head over the merged
// B*H axis of head-major tensors). See bsc_attention.cu for the numerics
// and the design.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq,
           int sk, int heads, const long long* strides, float scale,
           cudaStream_t st) {
  auto kernel = bsc_attention_kernel<T, D>;
  constexpr size_t bytes = Layout<T, D>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((sq + kRows - 1) / kRows, heads, b);
  kernel<<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, sk, strides[0],
      strides[1], strides[2], strides[3], strides[4], strides[5], strides[6],
      strides[7], scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int b,
               int sq, int sk, int heads, int d, const long long* strides,
               float scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, b, sq, sk, heads, strides, scale, st);
    case 32: return launch<T, 32>(q, k, v, out, b, sq, sk, heads, strides, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, b, sq, sk, heads, strides, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, b, sq, sk, heads, strides, scale, st);
    default: return XD_ERR_SHAPE;
  }
}

}  // namespace
