// K2: backward of the non-causal multi-head attention K1, read straight from
// the (B, S, C=H*D) qkv-projection layout.
//
// Replaces the Pallas kernel xdiffusion_tpu/ops/flash_attention.py:350
// (`_bsc_bwd_kernel`, launched by `_bsc_backward` :402, vjp :433-442). Same
// numerics: the probabilities are recomputed from fp32 logits and rounded to
// v's dtype as the forward rounds them (:374); dv = p^T g; dp = g v^T in
// fp32; ds = p (dp - rowsum(dp * p)) * scale rounded to q's dtype (:387-389);
// dq = ds k; dk = ds^T q; every product accumulates in fp32.
//
// Bound on the H100: 10*S*S*D flops per (batch, head) against 7*S*D*2
// bytes; at the UNet's S=256, D=64 that is ~180 flops per byte, below the
// card's ~295 bf16 flops per byte, so bytes bound it; the (S, S) logits,
// probabilities and their gradients never leave the SM.
//
// Design: the TPU kernel holds one head's whole (Sq, Sk) problem on chip; at
// S=256 one fp32 (S, S) tile is 256 KB, more than the 227 KB of shared
// memory a block may use. So the backward splits as the flash backward does
// (dq apart from dk/dv), in two launches with no atomics, so results repeat
// exactly from run to run:
//
//   Pass A, one block per (batch, head, 64-row query tile), three walks over
//   64-key tiles: (1) the row max m and sum l, online, as K1 finds them;
//   (2) delta = rowsum(dp * p), with p = exp(s - m) / l rounded as in the
//   forward; (3) ds and dq += ds . k. It writes m, l and delta to an fp32
//   (3, B, H, Sq) scratch.
//
//   Pass B, one block per (batch, head, 64-key tile), one walk over the
//   64-row query tiles with the stored m, l and delta: p and ds for the
//   tile, dv += p^T . g, dk += ds^T . q.
//
// Q.K^T is recomputed four times and G.V^T three times: half again the
// flops of a single pass, traded for shared memory that fits and exactly the
// TPU kernel's rounding. Each of the 4 warps owns 16 rows of every product.
// bf16 runs the products on the tensor cores (wmma, fp32 accumulation); fp32
// runs them on the CUDA cores in full fp32 (no TF32), as K1 does.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kRows = 64;   // query rows (pass A) or keys (pass B) per block
constexpr int kKeys = 64;   // keys (pass A) or query rows (pass B) per tile
constexpr int kThreads = 128;

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// Shared-memory layout. Q, K, V and G tiles in T; the S (logits) and DP
// (g v^T) tiles in fp32. In bf16 the rounded P and dS tiles get their own
// bf16 buffers (the tensor cores read them); in fp32 they overwrite S and DP
// in place.
template <typename T, int D>
struct Layout {
  static constexpr int ld = D + (is_f32<T>() ? 1 : 8);           // Q/K/V/G rows
  static constexpr int lds = (is_f32<T>() ? kKeys : (D > kKeys ? D : kKeys)) + 4;
  static constexpr int ldp = is_f32<T>() ? lds : kKeys + 8;       // P / dS rows
  static constexpr size_t tile_bytes = sizeof(T) * kRows * ld;
  static constexpr size_t s_bytes = sizeof(float) * kRows * lds;
  static constexpr size_t p_bytes = is_f32<T>() ? 0 : sizeof(T) * kRows * ldp;
  static constexpr size_t bytes = 4 * tile_bytes + 2 * s_bytes + 2 * p_bytes;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // (3, B, H, Sq): row max, row sum, rowsum(dp * p)
  int b, sq, sk, heads;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, g_bs, g_rs;
  long long dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;
  float scale;
};

template <typename T, int D>
struct Smem {
  T *Qs, *Ks, *Vs, *Gs, *Ps, *DSs;
  float *S, *DP;
  __device__ explicit Smem(unsigned char* base) {
    using L = Layout<T, D>;
    Qs = reinterpret_cast<T*>(base);
    Ks = Qs + kRows * L::ld;
    Vs = Ks + kRows * L::ld;
    Gs = Vs + kRows * L::ld;
    S = reinterpret_cast<float*>(base + 4 * L::tile_bytes);
    DP = S + kRows * L::lds;
    if constexpr (is_f32<T>()) {
      Ps = reinterpret_cast<T*>(S);
      DSs = reinterpret_cast<T*>(DP);
    } else {
      Ps = reinterpret_cast<T*>(base + 4 * L::tile_bytes + 2 * L::s_bytes);
      DSs = Ps + kRows * L::ldp;
    }
  }
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

// C[warp rows, 0:64] = A[warp rows] . B_tile^T, raw fp32 dot products of
// two (64, D) tiles.
template <typename T, int D>
__device__ __forceinline__ void dots(const T* A, const T* B, float* C, int warp,
                                     int lane) {
  constexpr int ld = Layout<T, D>::ld;
  constexpr int lds = Layout<T, D>::lds;
  if constexpr (is_f32<T>()) {
    const int r = warp * 16 + (lane >> 1);
    const int j0 = (lane & 1) * 32;
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float a = A[r * ld + d];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = fmaf(a, B[(j0 + j) * ld + d], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) C[r * lds + j0 + j] = acc[j];
  } else {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[kKeys / 16];
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) wmma::fill_fragment(c[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + warp * 16 * ld + kk * 16, ld);
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        // B^T (d, row) is B (row, d) read column-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, B + j * 16 * ld + kk * 16, ld);
        wmma::mma_sync(c[j], a, bf, c[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j)
      wmma::store_matrix_sync(C + warp * 16 * lds + j * 16, c[j], lds,
                              wmma::mem_row_major);
  }
}

// A warp's 16 x D fp32 accumulator: rows warp*16 .. warp*16+15 of a
// (64, D) product. fp32: each lane pair owns one row, each lane half of its
// columns; bf16: D/16 wmma fragments.
template <typename T, int D>
struct Acc {
  float simt[is_f32<T>() ? D / 2 : 1];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> frag[is_f32<T>() ? 1 : D / 16];

  __device__ __forceinline__ void zero() {
    if constexpr (is_f32<T>()) {
#pragma unroll
      for (int c = 0; c < D / 2; ++c) simt[c] = 0.0f;
    } else {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(frag[j], 0.0f);
    }
  }

  // += A[warp rows, 0:64] . B[0:64, 0:D], with A a (64, 64) tile of leading
  // dimension lda (kTransA: A is stored transposed, A[m][k] at A[k * lda + m])
  // and B a (64, D) tile of leading dimension ldb.
  template <bool kTransA>
  __device__ __forceinline__ void mma(const T* A, int lda, const T* B, int ldb,
                                      int warp, int lane) {
    if constexpr (is_f32<T>()) {
      const int r = warp * 16 + (lane >> 1);
      const int c0 = (lane & 1) * (D / 2);
      for (int k = 0; k < kKeys; ++k) {
        const float a = kTransA ? A[k * lda + r] : A[r * lda + k];
#pragma unroll
        for (int c = 0; c < D / 2; ++c) simt[c] = fmaf(a, B[k * ldb + c0 + c], simt[c]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        if constexpr (kTransA) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a;
          wmma::load_matrix_sync(a, A + kk * 16 * lda + warp * 16, lda);
          mma_row(a, B, ldb, kk);
        } else {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
          wmma::load_matrix_sync(a, A + warp * 16 * lda + kk * 16, lda);
          mma_row(a, B, ldb, kk);
        }
      }
    }
  }

  template <typename FragA>
  __device__ __forceinline__ void mma_row(const FragA& a, const T* B, int ldb, int kk) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, B + kk * 16 * ldb + j * 16, ldb);
      wmma::mma_sync(frag[j], a, bf, frag[j]);
    }
  }

  // Writes rows row0 + warp*16 + i (those < nrows) to out (row stride rs),
  // rounded to T. bf16 stages the fragments through `stage` (fp32, leading
  // dimension lds, the warp's own 16 rows).
  __device__ __forceinline__ void store(T* out, long long rs, int row0, int nrows,
                                        float* stage, int lds, int warp, int lane) {
    const int r = warp * 16 + (lane >> 1);
    const int c0 = (lane & 1) * (D / 2);
    const int row = row0 + r;
    if constexpr (is_f32<T>()) {
      if (row < nrows) {
#pragma unroll
        for (int c = 0; c < D / 2; ++c) out[(long long)row * rs + c0 + c] = simt[c];
      }
    } else {
      __syncwarp();
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        wmma::store_matrix_sync(stage + warp * 16 * lds + j * 16, frag[j], lds,
                                wmma::mem_row_major);
      __syncwarp();
      if (row < nrows) {
        const float* srow = stage + r * lds + c0;
        for (int c = 0; c < D / 2; ++c)
          out[(long long)row * rs + c0 + c] = from_f<T>(srow[c]);
      }
    }
  }
};

// Pass A: row statistics, delta and dq for one 64-row query tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(const Args a) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<T, D> sm(smem);

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_bs + (long long)h * D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_bs + (long long)h * D;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_bs + (long long)h * D;
  const T* gb = static_cast<const T*>(a.g) + b * a.g_bs + (long long)h * D;
  T* dqb = static_cast<T*>(a.dq) + b * a.dq_bs + (long long)h * D;

  load_rows<T, D>(sm.Qs, qb, a.q_rs, q0, a.sq);
  load_rows<T, D>(sm.Gs, gb, a.g_rs, q0, a.sq);

  // Each lane pair owns one query row; each lane half of the tile's keys.
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const float* srow = sm.S + row * L::lds + half * 32;
  const float* dprow = sm.DP + row * L::lds + half * 32;
  const int ntiles = (a.sk + kKeys - 1) / kKeys;
  const float scale = a.scale;

  // Walk 1: row max and sum of exp over all keys (online, as K1).
  float m = -INFINITY, l = 0.0f;
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    load_rows<T, D>(sm.Ks, kb, a.k_rs, t * kKeys, a.sk);
    __syncthreads();
    dots<T, D>(sm.Qs, sm.Ks, sm.S, warp, lane);
    __syncwarp();
    const int key0 = t * kKeys + half * 32;
    float tm = -INFINITY;
    for (int j = 0; j < 32; ++j)
      if (key0 + j < a.sk) tm = fmaxf(tm, srow[j] * scale);
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    const float mn = fmaxf(m, tm);  // finite: every tile holds a valid key
    float ts = 0.0f;
    for (int j = 0; j < 32; ++j)
      if (key0 + j < a.sk) ts += expf(srow[j] * scale - mn);
    ts += __shfl_xor_sync(0xffffffffu, ts, 1);
    l = l * expf(m - mn) + ts;
    m = mn;
    __syncwarp();
  }

  // Walk 2: delta = rowsum(dp * p), p rounded to T as the forward rounds it.
  float delta = 0.0f;
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    load_rows<T, D>(sm.Ks, kb, a.k_rs, t * kKeys, a.sk);
    load_rows<T, D>(sm.Vs, vb, a.v_rs, t * kKeys, a.sk);
    __syncthreads();
    dots<T, D>(sm.Qs, sm.Ks, sm.S, warp, lane);
    dots<T, D>(sm.Gs, sm.Vs, sm.DP, warp, lane);
    __syncwarp();
    const int key0 = t * kKeys + half * 32;
    for (int j = 0; j < 32; ++j)
      if (key0 + j < a.sk) delta += dprow[j] * round_to<T>(expf(srow[j] * scale - m) / l);
    __syncwarp();
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);

  // Walk 3: ds = p (dp - delta) * scale rounded to T; dq += ds . k.
  Acc<T, D> acc;
  acc.zero();
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    load_rows<T, D>(sm.Ks, kb, a.k_rs, t * kKeys, a.sk);
    load_rows<T, D>(sm.Vs, vb, a.v_rs, t * kKeys, a.sk);
    __syncthreads();
    dots<T, D>(sm.Qs, sm.Ks, sm.S, warp, lane);
    dots<T, D>(sm.Gs, sm.Vs, sm.DP, warp, lane);
    __syncwarp();
    const int key0 = t * kKeys + half * 32;
    T* dsrow = sm.DSs + row * L::ldp + half * 32;
    for (int j = 0; j < 32; ++j) {
      float ds = 0.0f;
      if (key0 + j < a.sk) {
        const float p = round_to<T>(expf(srow[j] * scale - m) / l);
        ds = p * (dprow[j] - delta) * scale;
      }
      dsrow[j] = from_f<T>(ds);  // in fp32 this overwrites dprow[j] itself
    }
    __syncwarp();  // the warp's product reads only its own dS rows
    acc.template mma<false>(sm.DSs, L::ldp, sm.Ks, L::ld, warp, lane);
  }
  __syncthreads();
  acc.store(dqb, a.dq_rs, q0, a.sq, sm.S, L::lds, warp, lane);

  const int qi = q0 + row;
  if (half == 0 && qi < a.sq) {
    const long long plane = (long long)a.b * a.heads * a.sq;
    const long long at = ((long long)b * a.heads + h) * a.sq + qi;
    a.stats[at] = m;
    a.stats[plane + at] = l;
    a.stats[2 * plane + at] = delta;
  }
}

// Pass B: dk and dv for one 64-key tile, over every query tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(const Args a) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<T, D> sm(smem);

  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_bs + (long long)h * D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_bs + (long long)h * D;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_bs + (long long)h * D;
  const T* gb = static_cast<const T*>(a.g) + b * a.g_bs + (long long)h * D;
  T* dkb = static_cast<T*>(a.dk) + b * a.dk_bs + (long long)h * D;
  T* dvb = static_cast<T*>(a.dv) + b * a.dv_bs + (long long)h * D;

  load_rows<T, D>(sm.Ks, kb, a.k_rs, k0, a.sk);
  load_rows<T, D>(sm.Vs, vb, a.v_rs, k0, a.sk);

  // For the elementwise step each lane pair owns one query row of the tile
  // and each lane half of its 64 keys; for the products each warp owns 16
  // keys.
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const float* srow = sm.S + row * L::lds + half * 32;
  const float* dprow = sm.DP + row * L::lds + half * 32;
  const int key0 = k0 + half * 32;
  const int ntiles = (a.sq + kKeys - 1) / kKeys;
  const long long plane = (long long)a.b * a.heads * a.sq;
  const float* stats = a.stats + ((long long)b * a.heads + h) * a.sq;
  const float scale = a.scale;

  Acc<T, D> acc_v, acc_k;
  acc_v.zero();
  acc_k.zero();
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();  // the previous tile's products are done
    load_rows<T, D>(sm.Qs, qb, a.q_rs, t * kKeys, a.sq);
    load_rows<T, D>(sm.Gs, gb, a.g_rs, t * kKeys, a.sq);
    __syncthreads();
    dots<T, D>(sm.Qs, sm.Ks, sm.S, warp, lane);
    dots<T, D>(sm.Gs, sm.Vs, sm.DP, warp, lane);
    __syncwarp();
    const int qi = t * kKeys + row;
    const bool row_ok = qi < a.sq;
    const float m = row_ok ? stats[qi] : 0.0f;
    const float l = row_ok ? stats[plane + qi] : 1.0f;
    const float delta = row_ok ? stats[2 * plane + qi] : 0.0f;
    T* prow = sm.Ps + row * L::ldp + half * 32;
    T* dsrow = sm.DSs + row * L::ldp + half * 32;
    for (int j = 0; j < 32; ++j) {
      float p = 0.0f, ds = 0.0f;
      if (row_ok && key0 + j < a.sk) {
        p = round_to<T>(expf(srow[j] * scale - m) / l);
        ds = p * (dprow[j] - delta) * scale;
      }
      // In fp32 these overwrite srow[j] and dprow[j] themselves.
      prow[j] = from_f<T>(p);
      dsrow[j] = from_f<T>(ds);
    }
    __syncthreads();  // the products read every query row of P and dS
    acc_v.template mma<true>(sm.Ps, L::ldp, sm.Gs, L::ld, warp, lane);
    acc_k.template mma<true>(sm.DSs, L::ldp, sm.Qs, L::ld, warp, lane);
  }
  __syncthreads();
  acc_v.store(dvb, a.dv_rs, k0, a.sk, sm.S, L::lds, warp, lane);
  acc_k.store(dkb, a.dk_rs, k0, a.sk, sm.DP, L::lds, warp, lane);
}

template <typename K>
int configure(K kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  *done = true;
  return 0;
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t st) {
  constexpr size_t bytes = Layout<T, D>::bytes;
  static bool done_a = false, done_b = false;
  int rc = configure(bwd_dq_kernel<T, D>, bytes, &done_a);
  if (rc) return rc;
  rc = configure(bwd_dkv_kernel<T, D>, bytes, &done_b);
  if (rc) return rc;
  const dim3 grid_a((a.sq + kRows - 1) / kRows, a.heads, a.b);
  bwd_dq_kernel<T, D><<<grid_a, kThreads, bytes, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const dim3 grid_b((a.sk + kRows - 1) / kRows, a.heads, a.b);
  bwd_dkv_kernel<T, D><<<grid_b, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a, int d, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(a, st);
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 128: return launch<T, 128>(a, st);
    default: return XD_ERR_SHAPE;
  }
}

}  // namespace

// q/g/dq: (B, Sq, heads*d), k/v/dk/dv: (B, Sk, heads*d), each with unit
// stride on the last axis and the batch / row strides (elements) given in
// `strides` as {q, k, v, g, dq, dk, dv} x {batch, row}. Rows must start on
// 16-byte boundaries (checked by the Python wrapper). `stats` is fp32
// scratch of 3 * B * heads * Sq floats.
XD_EXPORT int xd_bsc_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* g, void* dq, void* dk, void* dv,
                                   void* stats, int b, int sq, int sk, int heads,
                                   int d, const long long* strides, float scale,
                                   int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || heads <= 0) return XD_ERR_SHAPE;
  const Args a{q, k, v, g, dq, dk, dv, static_cast<float*>(stats), b, sq, sk, heads,
               strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8], strides[9],
               strides[10], strides[11], strides[12], strides[13], scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == XD_F32) return dispatch_d<float>(a, d, st);
  if (dtype == XD_BF16) return dispatch_d<__nv_bfloat16>(a, d, st);
  return XD_ERR_DTYPE;
}
