// K2: backward of the non-causal multi-head attention K1, read straight from
// the (B, S, C=H*D) qkv-projection layout.
//
// Replaces the Pallas kernel xdiffusion_tpu/ops/flash_attention.py:350
// (`_bsc_bwd_kernel`, launched by `_bsc_backward` :402, `pallas_call` :415,
// vjp :433-442). Same numerics: the probabilities are recomputed from fp32
// logits with the exact row max and sum and rounded to v's dtype as the
// forward rounds them (:374); dv = p^T g; dp = g v^T in fp32; delta =
// rowsum(dp * p); ds = p (dp - delta) * scale rounded to q's dtype
// (:387-389); dq = ds k; dk = ds^T q; every product accumulates in fp32.
// Every sum runs in a fixed order, with no atomics, so dq, dk and dv repeat
// bit for bit from run to run.
//
// Bound on the H100, per (batch, head): 10*Sq*Sk*D flops against
// (4*Sq + 3*Sk)*D elements moved. At the flagship UNet's (128, 256, C=256,
// 4 heads) in bf16 that is ~180 flops per byte, under the card's ~295, so
// bytes bound it; at S = 16 (the DiT's (128, 16, 384), 6 heads, fp32, and
// the UNet's middle block) 40 flops per element: bytes, by far. As in K1,
// latency holds it back in practice.
//
// Design, by the variant `bsc_plan` picks (bsc_attention.cuh for the
// layouts):
// - packed (S <= 32): one launch, one pass. A warp takes a whole (batch,
//   head) slice: it computes S and dP once on the CUDA cores, holds p, dp,
//   delta and ds in registers, and forms dq from ds.K and dk, dv from the
//   transposed products through two small fp32 tiles. No statistics
//   scratch.
// - row (Sk <= ROW_MAX_KEYS): the flash split into a dq launch and a dk/dv
//   launch, which needs no atomics. The dq launch holds its rows' logits
//   and dP over all keys and finds m, l and delta in one walk over the K
//   and V tiles; a second walk over the K tiles forms ds and dq += ds.K. In
//   bf16 up to 256 keys (D <= 64) the logits stay in registers and only dP
//   goes to a per-warp strip; otherwise both go to strips. It writes m, l,
//   delta and 1 / l to an fp32 (4, B, H, Sq) scratch. The dk/dv launch, one
//   block per 64 keys, walks the 64-row query tiles once with their
//   statistics staged in shared memory: S^T = K.Q^T and dP^T = V.G^T, p^T
//   and ds^T from the stored statistics, dv += p^T.G, dk += ds^T.Q. Q.K^T and
//   G.V^T are computed twice each. bf16 runs on mma.sync m16n8k16 with p and
//   ds fed back from registers; fp32 on the CUDA cores in full fp32.
// - stream (longer Sk): the dq launch below walks 64-key tiles three times
//   (statistics, delta, ds and dq), holding only one tile of S and dP; the
//   dk/dv launch is the row variant's.
#include "bsc_attention.cuh"

namespace {  // internal linkage, as in bsc_attention.cuh

// ---- stream: the three-walk dq launch ----------------------------------------
namespace bsc_stream_bwd {


using namespace nvcuda;

constexpr int kRows = 64;   // query rows per block
constexpr int kKeys = 64;   // keys per tile
constexpr int kThreads = 128;

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// Shared-memory layout. Q, K, V and G tiles in T; the S (logits) and DP
// (g v^T) tiles in fp32. In bf16 the rounded dS tile gets its own bf16
// buffer (the tensor cores read it); in fp32 it overwrites DP in place.
template <typename T, int D>
struct Layout {
  static constexpr int ld = D + (is_f32<T>() ? 1 : 8);           // Q/K/V/G rows
  static constexpr int lds = (is_f32<T>() ? kKeys : (D > kKeys ? D : kKeys)) + 4;
  static constexpr int ldp = is_f32<T>() ? lds : kKeys + 8;       // dS rows
  static constexpr size_t tile_bytes = sizeof(T) * kRows * ld;
  static constexpr size_t s_bytes = sizeof(float) * kRows * lds;
  static constexpr size_t p_bytes = is_f32<T>() ? 0 : sizeof(T) * kRows * ldp;
  static constexpr size_t bytes = 4 * tile_bytes + 2 * s_bytes + p_bytes;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // (4, B, H, Sq): row max m, row sum l, rowsum(dp * p), 1 / l
  int b, sq, sk, heads;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, g_bs, g_rs;
  long long dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;
  float scale;
};

template <typename T, int D>
struct Smem {
  T *Qs, *Ks, *Vs, *Gs, *DSs;
  float *S, *DP;
  __device__ explicit Smem(unsigned char* base) {
    using L = Layout<T, D>;
    Qs = reinterpret_cast<T*>(base);
    Ks = Qs + kRows * L::ld;
    Vs = Ks + kRows * L::ld;
    Gs = Vs + kRows * L::ld;
    S = reinterpret_cast<float*>(base + 4 * L::tile_bytes);
    DP = S + kRows * L::lds;
    if constexpr (is_f32<T>())
      DSs = reinterpret_cast<T*>(DP);
    else
      DSs = reinterpret_cast<T*>(base + 4 * L::tile_bytes + 2 * L::s_bytes);
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
  // dimension lda and B a (64, D) tile of leading dimension ldb.
  __device__ __forceinline__ void mma(const T* A, int lda, const T* B, int ldb, int warp,
                                      int lane) {
    if constexpr (is_f32<T>()) {
      const int r = warp * 16 + (lane >> 1);
      const int c0 = (lane & 1) * (D / 2);
      for (int k = 0; k < kKeys; ++k) {
        const float a = A[r * lda + k];
#pragma unroll
        for (int c = 0; c < D / 2; ++c) simt[c] = fmaf(a, B[k * ldb + c0 + c], simt[c]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + warp * 16 * lda + kk * 16, lda);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, B + kk * 16 * ldb + j * 16, ldb);
          wmma::mma_sync(frag[j], a, bf, frag[j]);
        }
      }
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
    acc.mma(sm.DSs, L::ldp, sm.Ks, L::ld, warp, lane);
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
    a.stats[3 * plane + at] = __frcp_rn(l);
  }
}

}  // namespace bsc_stream_bwd

namespace bsc {

using Bwd = bsc_stream_bwd::Args;

template <typename T>
__device__ __forceinline__ const T* at(const void* p, long long bs, int b, int h, int d) {
  return static_cast<const T*>(p) + b * bs + (long long)h * d;
}
template <typename T>
__device__ __forceinline__ T* at(void* p, long long bs, int b, int h, int d) {
  return static_cast<T*>(p) + b * bs + (long long)h * d;
}

// ---- packed: one warp per (batch, head) slice, one pass ---------------------

template <typename T, int D, int NS>
__global__ void __launch_bounds__(128) packed_bwd(const Bwd a) {
  using P = Packed<T, D, NS>;
  constexpr int ld = P::ld, ldm = P::ldm;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slice = blockIdx.x * (blockDim.x >> 5) + warp;
  if (slice >= a.b * a.heads) return;  // no block barrier follows
  const int b = slice / a.heads, h = slice - b * a.heads;
  T* Qs = reinterpret_cast<T*>(smem + warp * P::warp_bytes(true));
  T* Ks = Qs + NS * ld;
  T* Vs = Ks + NS * ld;
  T* Gs = Vs + NS * ld;
  float* Ps = reinterpret_cast<float*>(Gs + NS * ld);
  float* DSs = Ps + NS * ldm;
  stage_rows<T, D>(Qs, at<T>(a.q, a.q_bs, b, h, D), a.q_rs, 0, NS, a.sq, lane, 32);
  stage_rows<T, D>(Ks, at<T>(a.k, a.k_bs, b, h, D), a.k_rs, 0, NS, a.sk, lane, 32);
  stage_rows<T, D>(Vs, at<T>(a.v, a.v_bs, b, h, D), a.v_rs, 0, NS, a.sk, lane, 32);
  stage_rows<T, D>(Gs, at<T>(a.g, a.g_bs, b, h, D), a.g_rs, 0, NS, a.sq, lane, 32);
  flash::cp_async_commit();
  flash::cp_async_wait<0>();
  __syncwarp();

  const int g = lane >> 2, t4 = lane & 3;
  const float scale = a.scale;
  float s[NS / 8][NS / 4], dp[NS / 8][NS / 4];
  quad_dots<T, D, NS>(s, Qs, Ks, g, t4);
  quad_softmax<T, NS>(s, a.sq, a.sk, scale, g, t4);  // p, rounded; 0 off the slice
  quad_dots<T, D, NS>(dp, Gs, Vs, g, t4);
#pragma unroll
  for (int i = 0; i < NS / 8; ++i) {
    float delta = 0.0f;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) delta += dp[i][j] * s[i][j];
    delta = quad_sum(delta);
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      const int e = (g + 8 * i) * ldm + t4 + 4 * j;
      Ps[e] = s[i][j];
      DSs[e] = round_to<T>(s[i][j] * (dp[i][j] - delta) * scale);
    }
  }
  __syncwarp();
  float acc[NS / 8][D / 16][4];
  quad_product<T, D, NS, false>(acc, DSs, Ks, a.sk, g, t4);  // dq = ds . k
  quad_store<T, D, NS>(at<T>(a.dq, a.dq_bs, b, h, D), a.dq_rs, acc, a.sq, g, t4);
  quad_product<T, D, NS, true>(acc, DSs, Qs, a.sq, g, t4);   // dk = ds^T . q
  quad_store<T, D, NS>(at<T>(a.dk, a.dk_bs, b, h, D), a.dk_rs, acc, a.sk, g, t4);
  quad_product<T, D, NS, true>(acc, Ps, Gs, a.sq, g, t4);    // dv = p^T . g
  quad_store<T, D, NS>(at<T>(a.dv, a.dv_bs, b, h, D), a.dv_rs, acc, a.sk, g, t4);
}

// ---- row: the dq launch, logits and dP held in per-warp strips --------------

// m, l, delta and 1 / l (rounded) of a query row to the (4, B, H, Sq) scratch.
__device__ __forceinline__ void put_stats(const Bwd& a, int b, int h, int row, float m, float l,
                                          float delta, float rl) {
  if (row >= a.sq) return;
  const long long plane = (long long)a.b * a.heads * a.sq;
  const long long e = ((long long)b * a.heads + h) * a.sq + row;
  a.stats[e] = m;
  a.stats[plane + e] = l;
  a.stats[2 * plane + e] = delta;
  a.stats[3 * plane + e] = rl;
}

// Steps 0 .. nt-1 walk the K and V tiles together, steps nt .. 2nt-1 the K
// tiles again; stage s holds K at ring + 2s * tile and V after it. Starts the
// copies of step u into stage u % kDqStages.
template <typename T, int D>
__device__ __forceinline__ void stage_step(T* ring, const T* kb, const T* vb, const Bwd& a,
                                           int u, int nt) {
  constexpr int tile = kKeyTile * Row<T, D>::ld;
  T* dst = ring + 2 * (u % kDqStages) * tile;
  const int t = u < nt ? u : u - nt;
  stage_rows<T, D>(dst, kb, a.k_rs, t * kKeyTile, kKeyTile, a.sk, threadIdx.x, blockDim.x);
  if (u < nt)
    stage_rows<T, D>(dst + tile, vb, a.v_rs, t * kKeyTile, kKeyTile, a.sk, threadIdx.x,
                     blockDim.x);
}

template <int D>
__global__ void __launch_bounds__(128) row_dq_bf16(const Bwd a, int nt) {
  constexpr int ld = Row<bf16, D>::ld, tile = kKeyTile * ld;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * 16 * nw, h = blockIdx.y, b = blockIdx.z;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + 16 * nw * ld;
  bf16* ring = Gs + 16 * nw * ld;
  float* strips = reinterpret_cast<float*>(ring + 2 * kDqStages * tile);
  float* S = strips + (size_t)warp * nt * 8 * 128;
  float* DP = strips + (size_t)(nw + warp) * nt * 8 * 128;
  const bf16* kb = at<bf16>(a.k, a.k_bs, b, h, D);
  const bf16* vb = at<bf16>(a.v, a.v_bs, b, h, D);

  stage_rows<bf16, D>(Qs, at<bf16>(a.q, a.q_bs, b, h, D), a.q_rs, q0, 16 * nw, a.sq,
                      threadIdx.x, blockDim.x);
  stage_rows<bf16, D>(Gs, at<bf16>(a.g, a.g_bs, b, h, D), a.g_rs, q0, 16 * nw, a.sq,
                      threadIdx.x, blockDim.x);
  for (int u = 0; u < kDqStages - 1; ++u) {  // Q and G join the first group
    if (u < 2 * nt) stage_step<bf16, D>(ring, kb, vb, a, u, nt);
    flash::cp_async_commit();
  }

  const float scale = a.scale;
  uint32_t qf[D / 16][4], gf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, dl0 = 0.0f, dl1 = 0.0f;

  for (int u = 0; u < 2 * nt; ++u) {
    flash::cp_async_wait<kDqStages - 2>();
    __syncthreads();  // step u's tiles have landed; step u - 1's stage is free
    if (u + kDqStages - 1 < 2 * nt) stage_step<bf16, D>(ring, kb, vb, a, u + kDqStages - 1, nt);
    flash::cp_async_commit();
    const bf16* Kt = ring + 2 * (u % kDqStages) * tile;
    const bf16* Vt = Kt + tile;
    if (u == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        flash::load_a(qf[kk], Qs + (warp * 16 + g) * ld + kk * 16 + 2 * t4, ld);
        flash::load_a(gf[kk], Gs + (warp * 16 + g) * ld + kk * 16 + 2 * t4, ld);
      }
    }
    if (u < nt) {
#pragma unroll
      for (int n8 = 0; n8 < kKeyTile / 8; ++n8) {
        float c[4], d[4];
        frag_dots<D>(c, qf, Kt, n8 * 8, g, t4);
        scale_mask(c, u * kKeyTile + n8 * 8 + 2 * t4, a.sk, scale);
        m0 = fmaxf(m0, fmaxf(c[0], c[1]));
        m1 = fmaxf(m1, fmaxf(c[2], c[3]));
        *frag_at(S, u * 8 + n8, lane) = make_float4(c[0], c[1], c[2], c[3]);
        frag_dots<D>(d, gf, Vt, n8 * 8, g, t4);
        *frag_at(DP, u * 8 + n8, lane) = make_float4(d[0], d[1], d[2], d[3]);
      }
    } else {
      if (u == nt) {  // m, l, p rounded to bf16 (in S) and delta, per row
        m0 = quad_max(m0);
        m1 = quad_max(m1);
        float l0 = 0.0f, l1 = 0.0f;
        for (int blk = 0; blk < nt * 8; ++blk) {
          float4 x = *frag_at(S, blk, lane);
          x.x = expf(x.x - m0), x.y = expf(x.y - m0);
          x.z = expf(x.z - m1), x.w = expf(x.w - m1);
          l0 += x.x + x.y;
          l1 += x.z + x.w;
          *frag_at(S, blk, lane) = x;
        }
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
        for (int blk = 0; blk < nt * 8; ++blk) {
          float4 x = *frag_at(S, blk, lane);
          const float4 y = *frag_at(DP, blk, lane);
          x.x = round_to<bf16>(div_rn(x.x, l0, r0)), x.y = round_to<bf16>(div_rn(x.y, l0, r0));
          x.z = round_to<bf16>(div_rn(x.z, l1, r1)), x.w = round_to<bf16>(div_rn(x.w, l1, r1));
          dl0 += y.x * x.x + y.y * x.y;
          dl1 += y.z * x.z + y.w * x.w;
          *frag_at(S, blk, lane) = x;
        }
        dl0 = quad_sum(dl0);
        dl1 = quad_sum(dl1);
        if (t4 == 0) {
          put_stats(a, b, h, q0 + warp * 16 + g, m0, l0, dl0, r0);
          put_stats(a, b, h, q0 + warp * 16 + g + 8, m1, l1, dl1, r1);
        }
      }
      const int t = u - nt;
#pragma unroll
      for (int ks = 0; ks < kKeyTile / 16; ++ks) {
        float c[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 x = *frag_at(S, t * 8 + 2 * ks + half, lane);
          const float4 y = *frag_at(DP, t * 8 + 2 * ks + half, lane);
          c[half][0] = x.x * (y.x - dl0) * scale;
          c[half][1] = x.y * (y.y - dl0) * scale;
          c[half][2] = x.z * (y.z - dl1) * scale;
          c[half][3] = x.w * (y.w - dl1) * scale;
        }
        uint32_t da[4];
        flash::pack_a(da, c[0], c[1]);  // ds rounded to bf16
        flash::mma_a_times_tile<D>(acc, da, Kt, ks * 16, lane);
      }
    }
  }
  frag_store<D>(at<bf16>(a.dq, a.dq_bs, b, h, D), a.dq_rs, q0 + warp * 16 + g, a.sq, acc, t4);
}

// bf16, D <= 64, Sk <= kRegKeys: the warp's logits (then p) stay in
// registers and only dP goes to a strip, so the block needs a third of the
// shared memory and two fit an SM. Steps 0 .. 2NT-1 alternate the K and V
// tiles (K_t at 2t, V_t at 2t + 1), steps 2NT .. 3NT-1 walk the K tiles
// again, through a ring of kDqRegStages single tiles.
constexpr int kDqRegStages = 3;

template <int D>
__device__ __forceinline__ void dq_reg_step(bf16* ring, const bf16* kb, const bf16* vb,
                                            const Bwd& a, int u, int nt) {
  const bool is_v = u < 2 * nt && (u & 1);
  const int t = u < 2 * nt ? u >> 1 : u - 2 * nt;
  stage_rows<bf16, D>(ring + (u % kDqRegStages) * kKeyTile * Row<bf16, D>::ld, is_v ? vb : kb,
                      is_v ? a.v_rs : a.k_rs, t * kKeyTile, kKeyTile, a.sk, threadIdx.x,
                      blockDim.x);
}

template <int D, int NT>
__global__ void __launch_bounds__(128) row_dq_bf16_regs(const Bwd a) {
  constexpr int ld = Row<bf16, D>::ld, tile = kKeyTile * ld;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * 16 * nw, h = blockIdx.y, b = blockIdx.z;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + 16 * nw * ld;
  bf16* ring = Gs + 16 * nw * ld;
  float* DP = reinterpret_cast<float*>(ring + kDqRegStages * tile) + (size_t)warp * NT * 8 * 128;
  const bf16* kb = at<bf16>(a.k, a.k_bs, b, h, D);
  const bf16* vb = at<bf16>(a.v, a.v_bs, b, h, D);

  stage_rows<bf16, D>(Qs, at<bf16>(a.q, a.q_bs, b, h, D), a.q_rs, q0, 16 * nw, a.sq,
                      threadIdx.x, blockDim.x);
  stage_rows<bf16, D>(Gs, at<bf16>(a.g, a.g_bs, b, h, D), a.g_rs, q0, 16 * nw, a.sq,
                      threadIdx.x, blockDim.x);
#pragma unroll
  for (int u = 0; u < kDqRegStages - 1; ++u) {  // Q and G join the first group
    if (u < 3 * NT) dq_reg_step<D>(ring, kb, vb, a, u, NT);
    flash::cp_async_commit();
  }

  const float scale = a.scale;
  uint32_t qf[D / 16][4], gf[D / 16][4];
  float s[NT][kKeyTile / 8][4], acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, dl0 = 0.0f, dl1 = 0.0f;

#pragma unroll
  for (int u = 0; u < 3 * NT; ++u) {
    flash::cp_async_wait<kDqRegStages - 2>();
    __syncthreads();  // step u's tile has landed; step u - 1's slot is free
    if (u + kDqRegStages - 1 < 3 * NT) dq_reg_step<D>(ring, kb, vb, a, u + kDqRegStages - 1, NT);
    flash::cp_async_commit();
    const bf16* Tt = ring + (u % kDqRegStages) * tile;
    if (u == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        flash::load_a(qf[kk], Qs + (warp * 16 + g) * ld + kk * 16 + 2 * t4, ld);
        flash::load_a(gf[kk], Gs + (warp * 16 + g) * ld + kk * 16 + 2 * t4, ld);
      }
    }
    if (u < 2 * NT) {
      const int t = u >> 1;
#pragma unroll
      for (int n8 = 0; n8 < kKeyTile / 8; ++n8) {
        if ((u & 1) == 0) {  // S = Q.K^T, scaled and masked, kept
          float* c = s[t][n8];
          frag_dots<D>(s[t][n8], qf, Tt, n8 * 8, g, t4);
          scale_mask(s[t][n8], t * kKeyTile + n8 * 8 + 2 * t4, a.sk, scale);
          m0 = fmaxf(m0, fmaxf(c[0], c[1]));
          m1 = fmaxf(m1, fmaxf(c[2], c[3]));
        } else {  // dP = G.V^T to the strip
          float d[4];
          frag_dots<D>(d, gf, Tt, n8 * 8, g, t4);
          *frag_at(DP, t * 8 + n8, lane) = make_float4(d[0], d[1], d[2], d[3]);
        }
      }
    } else {
      if (u == 2 * NT) {  // m, l, p rounded to bf16 (in s) and delta, per row
        m0 = quad_max(m0);
        m1 = quad_max(m1);
        float l0 = 0.0f, l1 = 0.0f;
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
        const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int n8 = 0; n8 < kKeyTile / 8; ++n8) {
            float* c = s[t][n8];
            const float4 y = *frag_at(DP, t * 8 + n8, lane);
            c[0] = round_to<bf16>(div_rn(c[0], l0, r0));
            c[1] = round_to<bf16>(div_rn(c[1], l0, r0));
            c[2] = round_to<bf16>(div_rn(c[2], l1, r1));
            c[3] = round_to<bf16>(div_rn(c[3], l1, r1));
            dl0 += y.x * c[0] + y.y * c[1];
            dl1 += y.z * c[2] + y.w * c[3];
          }
        dl0 = quad_sum(dl0);
        dl1 = quad_sum(dl1);
        if (t4 == 0) {
          put_stats(a, b, h, q0 + warp * 16 + g, m0, l0, dl0, r0);
          put_stats(a, b, h, q0 + warp * 16 + g + 8, m1, l1, dl1, r1);
        }
      }
      const int t = u - 2 * NT;
#pragma unroll
      for (int ks = 0; ks < kKeyTile / 16; ++ks) {
        float c[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* x = s[t][2 * ks + half];
          const float4 y = *frag_at(DP, t * 8 + 2 * ks + half, lane);
          c[half][0] = x[0] * (y.x - dl0) * scale;
          c[half][1] = x[1] * (y.y - dl0) * scale;
          c[half][2] = x[2] * (y.z - dl1) * scale;
          c[half][3] = x[3] * (y.w - dl1) * scale;
        }
        uint32_t da[4];
        flash::pack_a(da, c[0], c[1]);  // ds rounded to bf16
        flash::mma_a_times_tile<D>(acc, da, Tt, ks * 16, lane);
      }
    }
  }
  frag_store<D>(at<bf16>(a.dq, a.dq_bs, b, h, D), a.dq_rs, q0 + warp * 16 + g, a.sq, acc, t4);
}

template <int D>
__global__ void __launch_bounds__(128) row_dq_f32(const Bwd a, int nt) {
  constexpr int ld = Row<float, D>::ld, tile = kKeyTile * ld;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, kg = lane & 7;
  const int q0 = blockIdx.x * 16 * nw, h = blockIdx.y, b = blockIdx.z;
  const int lds = nt * kKeyTile + 8;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + 16 * nw * ld;
  float* ring = Gs + 16 * nw * ld;
  float* S = ring + 2 * kDqStages * tile + (size_t)warp * 16 * lds;
  float* DP = ring + 2 * kDqStages * tile + (size_t)(nw + warp) * 16 * lds;
  const float* Qw = Qs + warp * 16 * ld;
  const float* Gw = Gs + warp * 16 * ld;
  const float* kb = at<float>(a.k, a.k_bs, b, h, D);
  const float* vb = at<float>(a.v, a.v_bs, b, h, D);

  stage_rows<float, D>(Qs, at<float>(a.q, a.q_bs, b, h, D), a.q_rs, q0, 16 * nw, a.sq,
                       threadIdx.x, blockDim.x);
  stage_rows<float, D>(Gs, at<float>(a.g, a.g_bs, b, h, D), a.g_rs, q0, 16 * nw, a.sq,
                       threadIdx.x, blockDim.x);
  for (int u = 0; u < kDqStages - 1; ++u) {  // Q and G join the first group
    if (u < 2 * nt) stage_step<float, D>(ring, kb, vb, a, u, nt);
    flash::cp_async_commit();
  }

  const float scale = a.scale;
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY}, acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.0f;

  for (int u = 0; u < 2 * nt; ++u) {
    flash::cp_async_wait<kDqStages - 2>();
    __syncthreads();  // step u's tiles have landed; step u - 1's stage is free
    if (u + kDqStages - 1 < 2 * nt) stage_step<float, D>(ring, kb, vb, a, u + kDqStages - 1, nt);
    flash::cp_async_commit();
    const float* Kt = ring + 2 * (u % kDqStages) * tile;
    const float* Vt = Kt + tile;
    if (u < nt) {
      float s[4][8];
      warp_dots<D>(s, Qw, Kt, rg, kg);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = u * kKeyTile + kg + 8 * j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = key < a.sk ? s[i][j] * scale : -INFINITY;
          m[i] = fmaxf(m[i], x);
          S[(rg + 4 * i) * lds + key] = x;
        }
      }
      warp_dots<D>(s, Gw, Vt, rg, kg);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) DP[(rg + 4 * i) * lds + u * kKeyTile + kg + 8 * j] = s[i][j];
    } else {
      if (u == nt) {  // per row over the lane's own keys: p (in S), then ds (in DP)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* srow = S + (rg + 4 * i) * lds;
          float* drow = DP + (rg + 4 * i) * lds;
          const float mi = oct_max(m[i]);
          float l = 0.0f, delta = 0.0f;
          for (int key = kg; key < nt * kKeyTile; key += 8) {
            srow[key] = expf(srow[key] - mi);
            l += srow[key];
          }
          l = oct_sum(l);
          const float rl = __frcp_rn(l);
          for (int key = kg; key < nt * kKeyTile; key += 8) {
            srow[key] = div_rn(srow[key], l, rl);
            delta += drow[key] * srow[key];
          }
          delta = oct_sum(delta);
          for (int key = kg; key < nt * kKeyTile; key += 8)
            drow[key] = srow[key] * (drow[key] - delta) * scale;
          if (kg == 0) put_stats(a, b, h, q0 + warp * 16 + rg + 4 * i, mi, l, delta, rl);
        }
        __syncwarp();  // the product reads the other lanes' keys
      }
      warp_product<D>(acc, DP + (u - nt) * kKeyTile, lds, Kt, rg, kg);  // dq += ds . K
    }
  }
  warp_store<D>(at<float>(a.dq, a.dq_bs, b, h, D), a.dq_rs, q0 + warp * 16, a.sq, acc, rg, kg);
}

// ---- the dk/dv launch (row and stream): one block per 64 keys ---------------
//
// As K6's dk/dv pass (flash_attention_bwd.cu), with K1's probabilities: p =
// exp(s * scale - m) / l from the stored row max m and sum l, rounded to T;
// ds = p (dp - delta) * scale with the stored delta. Each query tile's
// statistics are staged in shared memory with its rows.

// m, l, delta and 1 / l of query rows [q0, q0 + 64) into dst[4][64] (rows past
// Sq: m = delta = 0, l = 1 / l = 1).
__device__ __forceinline__ void stage_stats(float (*dst)[flash::kTile], const Bwd& a, int b,
                                            int h, int q0) {
  const long long plane = (long long)a.b * a.heads * a.sq;
  const float* src = a.stats + ((long long)b * a.heads + h) * a.sq;
  for (int i = threadIdx.x; i < 4 * flash::kTile; i += blockDim.x) {
    const int k = i / flash::kTile, j = i - k * flash::kTile, qi = q0 + j;
    dst[k][j] = qi < a.sq ? src[k * plane + qi] : (k & 1 ? 1.0f : 0.0f);
  }
}

template <int D>
__global__ void __launch_bounds__(flash::kThreads) dkv_bf16(const Bwd a) {
  using namespace flash;
  constexpr int ld = Tile<bf16, D>::ld, tile = Tile<bf16, D>::elems, kChunk = 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + tile;
  bf16* Qs = Vs + tile;      // two buffers
  bf16* Gs = Qs + 2 * tile;  // two buffers

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = at<bf16>(a.q, a.q_bs, b, h, D);
  const bf16* gb = at<bf16>(a.g, a.g_bs, b, h, D);

  load_tile<bf16, D>(Ks, at<bf16>(a.k, a.k_bs, b, h, D), a.k_rs, k0, a.sk);
  load_tile<bf16, D>(Vs, at<bf16>(a.v, a.v_bs, b, h, D), a.v_rs, k0, a.sk);
  load_tile<bf16, D>(Qs, qb, a.q_rs, 0, a.sq);
  load_tile<bf16, D>(Gs, gb, a.g_rs, 0, a.sq);
  cp_async_commit();

  __shared__ float stat_s[2][4][kTile];  // this and the next query tile's m, l, delta, 1 / l
  const bf16* ka = Ks + (warp * 16 + g) * ld + 2 * t4;
  const bf16* va = Vs + (warp * 16 + g) * ld + 2 * t4;
  const float scale = a.scale;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  const int ntiles = (a.sq + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      load_tile<bf16, D>(Qs + nb * tile, qb, a.q_rs, (t + 1) * kTile, a.sq);
      load_tile<bf16, D>(Gs + nb * tile, gb, a.g_rs, (t + 1) * kTile, a.sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    stage_stats(stat_s[t & 1], a, b, h, t * kTile);
    __syncthreads();
    const bf16* Qt = Qs + (t & 1) * tile;
    const bf16* Gt = Gs + (t & 1) * tile;
    const float(*st_m)[kTile] = stat_s[t & 1];

#pragma unroll
    for (int c = 0; c < kTile / kChunk; ++c) {
      // st[j]: queries c*32 + 8j + 2*t4 + {0, 1}, keys g ([0], [1]) and g+8
      // of the warp's 16.
      float st[kChunk / 8][4], dpt[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4], vf[4];
        load_a(kf, ka + kk * 16, ld);
        load_a(vf, va + kk * 16, ld);
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) {
          const int off = (c * kChunk + j * 8 + g) * ld + kk * 16 + 2 * t4;
          mma_bf16(st[j], kf, lds32(Qt + off), lds32(Qt + off + 8));
          mma_bf16(dpt[j], vf, lds32(Gt + off), lds32(Gt + off + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = c * kChunk + 8 * j + 2 * t4 + e;  // the query, in the tile
          const bool valid = t * kTile + ql < a.sq;
          const float m = st_m[0][ql], l = st_m[1][ql], dl = st_m[2][ql], rl = st_m[3][ql];
#pragma unroll
          for (int r = 0; r < 4; r += 2) {
            const float p =
                valid ? round_to<bf16>(div_rn(expf(st[j][r + e] * scale - m), l, rl)) : 0.0f;
            st[j][r + e] = p;
            dpt[j][r + e] = p * (dpt[j][r + e] - dl) * scale;
          }
        }
      // dv += p^T . G and dk += bf16(ds^T) . Q, 16 queries per step.
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        uint32_t pa[4], da[4];
        pack_a(pa, st[2 * ks], st[2 * ks + 1]);
        mma_a_times_tile<D>(dv, pa, Gt, c * kChunk + ks * 16, lane);
        pack_a(da, dpt[2 * ks], dpt[2 * ks + 1]);
        mma_a_times_tile<D>(dk, da, Qt, c * kChunk + ks * 16, lane);
      }
    }
    __syncthreads();  // this tile's buffers are free for the load after next
  }
  const int r0 = k0 + warp * 16 + g;
  frag_store<D>(at<bf16>(a.dk, a.dk_bs, b, h, D), a.dk_rs, r0, a.sk, dk, t4);
  frag_store<D>(at<bf16>(a.dv, a.dv_bs, b, h, D), a.dv_rs, r0, a.sk, dv, t4);
}

template <int D>
__global__ void __launch_bounds__(flash::kThreads) dkv_f32(const Bwd a) {
  using namespace flash;
  constexpr int tile = Tile<float, D>::elems;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + tile;
  float* Qs = Vs + tile;      // two buffers
  float* Gs = Qs + 2 * tile;  // two buffers
  float* P = Gs + 2 * tile;   // p^T, then ds^T in place

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  // Keys rg + 16i (i < 4), queries kg + 8j of the streamed tile.
  const int rg = threadIdx.x >> 3, kg = threadIdx.x & 7;
  const float* qb = at<float>(a.q, a.q_bs, b, h, D);
  const float* gb = at<float>(a.g, a.g_bs, b, h, D);

  load_tile<float, D>(Ks, at<float>(a.k, a.k_bs, b, h, D), a.k_rs, k0, a.sk);
  load_tile<float, D>(Vs, at<float>(a.v, a.v_bs, b, h, D), a.v_rs, k0, a.sk);
  load_tile<float, D>(Qs, qb, a.q_rs, 0, a.sq);
  load_tile<float, D>(Gs, gb, a.g_rs, 0, a.sq);
  cp_async_commit();

  __shared__ float stat_s[2][4][kTile];  // this and the next query tile's m, l, delta, 1 / l
  const float scale = a.scale;
  float dk[4][D / 8], dv[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk[i][c] = dv[i][c] = 0.0f;

  const int ntiles = (a.sq + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      load_tile<float, D>(Qs + nb * tile, qb, a.q_rs, (t + 1) * kTile, a.sq);
      load_tile<float, D>(Gs + nb * tile, gb, a.g_rs, (t + 1) * kTile, a.sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    stage_stats(stat_s[t & 1], a, b, h, t * kTile);
    __syncthreads();
    const float* Qt = Qs + (t & 1) * tile;
    const float* Gt = Gs + (t & 1) * tile;
    const float(*st_m)[kTile] = stat_s[t & 1];

    float s[4][8];
    tile_dots<D>(s, Ks, Qt, rg, kg);  // S^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ql = kg + 8 * j;
      const bool valid = t * kTile + ql < a.sq;
      const float m = st_m[0][ql], l = st_m[1][ql], rl = st_m[3][ql];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        P[(rg + 16 * i) * kLdp + ql] = valid ? div_rn(expf(s[i][j] * scale - m), l, rl) : 0.0f;
    }
    __syncwarp();
    tile_product<D>(dv, P, Gt, rg, kg);  // dv += p^T . G
    tile_dots<D>(s, Vs, Gt, rg, kg);     // dP^T
    __syncwarp();  // every lane has read p^T for dv
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float dl = st_m[2][kg + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* pp = P + (rg + 16 * i) * kLdp + kg + 8 * j;
        *pp = *pp * (s[i][j] - dl) * scale;
      }
    }
    __syncwarp();
    tile_product<D>(dk, P, Qt, rg, kg);  // dk += ds^T . Q
    __syncthreads();  // Q, G and P are free for the next tile
  }
  store_rows<D>(static_cast<float*>(a.dk), Strides{a.dk_bs, D, a.dk_rs}, b, h, k0, a.sk, dk,
                rg, kg);
  store_rows<D>(static_cast<float*>(a.dv), Strides{a.dv_bs, D, a.dv_rs}, b, h, k0, a.sk, dv,
                rg, kg);
}

// ---- launch ------------------------------------------------------------------

template <typename T, int D>
constexpr int dkv_bytes() {
  return 6 * flash::kTile * Row<T, D>::bytes +
         (is_f32<T>() ? flash::kTile * flash::kLdp * 4 : 0);
}

template <typename T, int D, int NS>
int backward_packed(const Bwd& a, const Plan& p, cudaStream_t st) {
  static bool ready = false;
  if (!covers_slices(p.launch[0], p.per_block, a.b * a.heads,
                     p.per_block * Packed<T, D, NS>::warp_bytes(true)))
    return XD_ERR_SHAPE;
  return launch(packed_bwd<T, D, NS>, &ready, p.launch[0], st, a);
}

template <typename T, int D>
int backward(const Bwd& a, const Plan& p, cudaStream_t st) {
  if (p.variant == kPacked) {
    if (!packed_fits(p, a.sq, a.sk, D)) return XD_ERR_SHAPE;
    if (p.tile == 16) return backward_packed<T, D, 16>(a, p, st);
    if constexpr (D <= 64) return backward_packed<T, D, 32>(a, p, st);
    return XD_ERR_SHAPE;
  }
  // row and stream: a dq launch that writes the row statistics, then the
  // dk/dv launch that reads them (same stream, in order).
  if (!covers_rows(p.launch[1], flash::kTile, a.sk, a.heads, a.b, flash::kThreads,
                   dkv_bytes<T, D>()))
    return XD_ERR_SHAPE;
  int rc;
  if (p.variant == kRow) {
    const int nw = p.per_block, nt = p.tile / kKeyTile;
    const bool regs = !is_f32<T>() && D <= 64 && p.tile <= kRegKeys;
    const int bytes = regs ? row_block_bytes<T, D>(nw, p.tile, kDqRegStages, 1, 1, 2)
                           : row_block_bytes<T, D>(nw, p.tile, kDqStages, 2, 2, 2);
    if (!row_fits(p, a.sk) || !covers_rows(p.launch[0], 16 * nw, a.sq, a.heads, a.b, 32 * nw, bytes))
      return XD_ERR_SHAPE;
    rc = -1;
    if constexpr (is_f32<T>()) {
      static bool ready = false;
      rc = launch(row_dq_f32<D>, &ready, p.launch[0], st, a, nt);
    } else {
      if constexpr (D <= 64) {
        static bool ready[kRegKeys / kKeyTile] = {};
        switch (regs ? nt : 0) {
          case 1: rc = launch(row_dq_bf16_regs<D, 1>, &ready[0], p.launch[0], st, a); break;
          case 2: rc = launch(row_dq_bf16_regs<D, 2>, &ready[1], p.launch[0], st, a); break;
          case 3: rc = launch(row_dq_bf16_regs<D, 3>, &ready[2], p.launch[0], st, a); break;
          case 4: rc = launch(row_dq_bf16_regs<D, 4>, &ready[3], p.launch[0], st, a); break;
          default: break;
        }
      }
      if (rc < 0) {
        static bool ready = false;
        rc = launch(row_dq_bf16<D>, &ready, p.launch[0], st, a, nt);
      }
    }
  } else if (p.variant == kStream) {
    static bool ready = false;
    if (!covers_rows(p.launch[0], bsc_stream_bwd::kRows, a.sq, a.heads, a.b,
                     bsc_stream_bwd::kThreads, (int)bsc_stream_bwd::Layout<T, D>::bytes))
      return XD_ERR_SHAPE;
    rc = launch(bsc_stream_bwd::bwd_dq_kernel<T, D>, &ready, p.launch[0], st, a);
  } else {
    return XD_ERR_SHAPE;
  }
  if (rc) return rc;
  static bool ready_kv = false;
  if constexpr (is_f32<T>())
    return launch(dkv_f32<D>, &ready_kv, p.launch[1], st, a);
  else
    return launch(dkv_bf16<D>, &ready_kv, p.launch[1], st, a);
}

}  // namespace bsc

}  // namespace

// q/g/dq: (B, Sq, heads*d), k/v/dk/dv: (B, Sk, heads*d), each with unit
// stride on the last axis and the batch / row strides (elements) given in
// `strides` as {q, k, v, g, dq, dk, dv} x {batch, row}. Rows must start on
// 16-byte boundaries (checked by the Python wrapper). `stats` is fp32
// scratch of 4 * B * heads * Sq floats for the row and stream variants
// (unused by the packed one). `plan`: the 13 ints of `bsc_plan(...,
// backward=True)` (ops/flash_attention.py).
XD_EXPORT int xd_bsc_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* g, void* dq, void* dk, void* dv,
                                   void* stats, int b, int sq, int sk, int heads,
                                   int d, const long long* strides, float scale,
                                   int dtype, const int* plan, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || heads <= 0) return XD_ERR_SHAPE;
  if (dtype != XD_F32 && dtype != XD_BF16) return XD_ERR_DTYPE;
  const bsc::Bwd a{q, k, v, g, dq, dk, dv, static_cast<float*>(stats), b, sq, sk, heads,
                   strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8], strides[9],
                   strides[10], strides[11], strides[12], strides[13], scale};
  const bsc::Plan p = bsc::read_plan(plan);
  cudaStream_t st = (cudaStream_t)stream;
  const bool f32 = dtype == XD_F32;
  using bsc::bf16;
  switch (d) {
    case 16: return f32 ? bsc::backward<float, 16>(a, p, st) : bsc::backward<bf16, 16>(a, p, st);
    case 32: return f32 ? bsc::backward<float, 32>(a, p, st) : bsc::backward<bf16, 32>(a, p, st);
    case 64: return f32 ? bsc::backward<float, 64>(a, p, st) : bsc::backward<bf16, 64>(a, p, st);
    case 128:
      return f32 ? bsc::backward<float, 128>(a, p, st) : bsc::backward<bf16, 128>(a, p, st);
    default: return XD_ERR_SHAPE;
  }
}
