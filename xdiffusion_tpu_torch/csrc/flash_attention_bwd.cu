// K6: backward of the streamed attention K5 on (B, H, S, D), from the saved
// output o and per-row logsumexp lse.
//
// Replaces the Pallas kernels xdiffusion_tpu/ops/flash_attention.py:445
// (`_flash_dq_kernel`, `pallas_call` :572) and :489 (`_flash_dkv_kernel`,
// `pallas_call` :603), driven by `_flash_bwd` :544. Same numerics: the
// probabilities come back from the saved lse as p = exp(logits * scale -
// lse) in fp32, never from a new softmax; dp = g . v^T in fp32; ds = p (dp -
// delta) * scale rounded to q's dtype before both ds . k and ds^T . q; the
// p of dv = p^T . g is rounded to g's dtype; every product accumulates in
// fp32. delta = rowsum(g * o) in fp32 (computed outside the TPU kernels,
// :552) is formed here by the dq pass from o and g in their own dtype.
//
// Bound on the H100: five products of 2*Sq*Sk*D flops each per (batch, head)
// against (4*Sq + 4*Sk)*D elements of traffic: at the LTX shapes (D = 64,
// Sq = 512 or 16,384, Sk = 128 to 16,384) operations bound it (in fp32,
// three TF32 products per product); only the 128-key caption
// cross-attention comes near the bytes.
//
// Design: two launches with no atomics, as the TPU splits it, so results
// repeat exactly from run to run:
//
//   dq pass, one block per (batch, head, query tile): delta for its rows
//   (also stored for the other pass), then a walk over the key tiles:
//   S = Q.K^T, dP = G.V^T, p, ds, dq += ds . K.
//
//   dk/dv pass, one block per (batch, head, key tile, split): a walk over
//   the query tiles of its split on the transposed tiles S^T = K.Q^T and
//   dP^T = V.G^T, so p^T and ds^T come out with one key per row, the rows
//   dv and dk accumulate; dv += p^T . G, dk += ds^T . Q. Where the key
//   tiles alone would give the card too few blocks (`flash_plan`: fewer
//   than about twice the SMs, e.g. 128 caption keys), each key tile's query
//   walk is cut into `splits` contiguous ranges of `tiles_per_split` 64-row
//   tiles; each block writes fp32 partials of dk and dv, and a third launch
//   sums them in split order, so the result does not depend on timing.
//
// The dk/dv pass recomputes S and dP: 14 products of Sq*Sk*D where 10 are
// needed, traded for no (Sq, Sk) tensor in device memory. Rows past Sq and
// keys past Sk load as zeros and their p is set to 0; they are not stored.
// q, k, v, o and g are read, and dq, dk and dv written, through their
// (batch, head, row) strides with unit stride on D.
//
// Variants (named by `flash_plan` by dtype and head dim):
// - "tf32", fp32, D 64 or 128: split TF32 (lo.hi + hi.lo + hi.hi) on
//   mma.sync m16n8k8, 4 warps of 16 rows, the streamed tiles double
//   buffered by cp.async, in chunks of 32 streamed rows; ds (p^T, ds^T)
//   goes back to the tensor cores from the accumulators in the key order
//   of flash_common.cuh, its B operand from plain shared loads (K in ds.K,
//   G in p^T.G and Q in ds^T.Q are N-major, which wgmma refuses for tf32).
// - "wgmma", bf16, D 64: consumer warpgroups of 64 rows, three a dq block
//   (192 query rows) and two a dk/dv block (128 keys: its four accumulators
//   leave registers for no more), and a producer warp that loads
//   the block's two fixed tiles once and streams 64-row tiles of the other
//   two by TMA through a ring of kStages stages (in the dk/dv pass with each
//   query tile's lse and delta). The logit and dP products (Q.K^T, G.V^T;
//   K.Q^T, V.G^T) read both operands K-major from shared memory, as two
//   wgmma groups, so that p's exponentials run while dP's product does;
//   ds (p^T, ds^T) goes from their accumulators, rounded to bf16, into the
//   register A operand of dq += ds.K (dv += p^T.G, dk += ds^T.Q), whose B
//   is the same swizzled tile read N-major. More warpgroups an SM keep the
//   tensor cores fed while each waits on its own chain of products.
// - "mma", bf16, D 128: 4 warps of 16 rows on mma.sync m16n8k16, B from
//   ldmatrix.trans.
// - "wide", fp32 or bf16, D 256 or 576: 16 query rows (dq) or keys (dk/dv)
//   a block, its 4 or 9 warps each owning 64 columns of D; S and dP (S^T
//   and dP^T) are D / 64 partials over D exchanged through shared memory;
//   32-row streamed tiles (16 at D 576). At WideFormer's cross-attention
//   site (16 queries, 77 keys) and Sana's (16 against 300) the bound is
//   bytes.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

enum { kTf32 = 0, kMma = 1, kWgmma = 2, kWide = 3 };
constexpr int kChunk = 32;  // streamed rows per step (tf32, mma)
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Layout {
  // Two fixed tiles and two double-buffered streamed ones: fixed tiles of
  // 64 rows a row tile a warp (MT in the fp32 dq pass), streamed ones of 64
  // rows in bf16 and of 32 in fp32 (three blocks an SM at D 64).
  template <int MT>
  static constexpr size_t dq_bytes =
      std::is_same<T, float>::value
          ? sizeof(float) * (2 * 64 * MT + 4 * kChunk) * Tile<float, D>::ld
          : sizeof(T) * 6 * Tile<T, D>::elems;
  static constexpr size_t dkv_bytes =
      sizeof(T) * (std::is_same<T, float>::value ? 2 * kTile + 4 * kChunk : 6 * kTile) *
      Tile<T, D>::ld;
};

struct Args {
  const void *q, *k, *v, *o, *g;
  const float* lse;  // (B, H, Sq), contiguous
  float* delta;      // (B, H, Sq), written by the dq pass
  void *dq, *dk, *dv;
  float* part;       // (2, splits, B, H, Sk, D) fp32 partials of dk and dv
  int nb, heads, sq, sk, splits, tps;  // tps: 64-row query tiles a split walks
  Strides qs, ks, vs, os, gs, dqs, dks, dvs;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* slab(const void* p, const Strides& s, int b, int h) {
  return static_cast<const T*>(p) + b * s.b + h * s.h;
}
template <typename T>
__device__ __forceinline__ T* slab(void* p, const Strides& s, int b, int h) {
  return static_cast<T*>(p) + b * s.b + h * s.h;
}

// The dk/dv pass's block: (batch, split) from blockIdx.z, and its range of
// query tiles [t0, t1).
struct Walk {
  int b, split, t0, t1;
  __device__ __forceinline__ Walk(const Args& a) {
    b = blockIdx.z / a.splits;
    split = blockIdx.z - b * a.splits;
    t0 = split * a.tps;
    t1 = min(t0 + a.tps, (a.sq + kTile - 1) / kTile);
  }
};

// Columns (col, col + 1) of key row `key` of dk (which = 0) or dv (1):
// into the output in its dtype with one split, else into the split's fp32
// partial.
template <typename T, int D>
__device__ __forceinline__ void store_dkv(const Args& a, const Walk& w, int which, int h, int key,
                                          int col, float x0, float x1) {
  if (key >= a.sk) return;
  if (a.splits == 1) {
    T* base = which ? slab<T>(a.dv, a.dvs, w.b, h) : slab<T>(a.dk, a.dks, w.b, h);
    const long long rs = which ? a.dvs.s : a.dks.s;
    store2<T>(base + (long long)key * rs + col, x0, x1);
  } else {
    const long long slice = ((long long)(which * a.splits + w.split) * a.nb + w.b) * a.heads + h;
    store2<float>(a.part + (slice * a.sk + key) * D + col, x0, x1);
  }
}

// delta = rowsum(g * o) in fp32 for row q0 + thread / 2 of (b, h), read
// from device memory, two threads a row; into `out` (0 past Sq) and
// a.delta.
template <typename T, int D>
__device__ __forceinline__ void row_delta(const Args& a, int b, int h, int q0, float* out,
                                          int thread) {
  const int r = thread >> 1, half = thread & 1;
  const int row = q0 + r;
  float s = 0.0f;
  if (row < a.sq) {
    const T* gr = slab<T>(a.g, a.gs, b, h) + (long long)row * a.gs.s + half * (D / 2);
    const T* orow = slab<T>(a.o, a.os, b, h) + (long long)row * a.os.s + half * (D / 2);
#pragma unroll 8
    for (int d = 0; d < D / 2; ++d) s = fmaf(to_f<T>(gr[d]), to_f<T>(orow[d]), s);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (half == 0) {
    out[r] = s;
    if (row < a.sq) a.delta[((long long)b * a.heads + h) * a.sq + row] = s;
  }
}

// ---- "tf32": fp32, split TF32 on mma.sync --------------------------------

// MT row tiles of 16 a warp: 64 * MT query rows a block. With two (the
// plan's choice at D 64 where the grid stays large), each K and V fragment
// is loaded and split once for both.
template <int D, int MT>
__global__ void __launch_bounds__(kThreads) flash_dq_tf32(const Args a) {
  constexpr int kRows = 64 * MT;  // query rows a block
  constexpr int ld = Tile<float, D>::ld, fixed = kRows * ld, half = kChunk * ld;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float delta_s[kRows];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + fixed;
  float* Ks = Gs + fixed;     // two 32-key buffers
  float* Vs = Ks + 2 * half;  // two 32-key buffers

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float* kb = slab<float>(a.k, a.ks, b, h);
  const float* vb = slab<float>(a.v, a.vs, b, h);

  load_tile<float, D, kRows>(Qs, slab<float>(a.q, a.qs, b, h), a.qs.s, q0, a.sq);
  load_tile<float, D, kRows>(Gs, slab<float>(a.g, a.gs, b, h), a.gs.s, q0, a.sq);
  load_tile<float, D, kChunk>(Ks, kb, a.ks.s, 0, a.sk);
  load_tile<float, D, kChunk>(Vs, vb, a.vs.s, 0, a.sk);
  cp_async_commit();
#pragma unroll
  for (int m = 0; m < MT; ++m)
    row_delta<float, D>(a, b, h, q0 + 64 * m, delta_s + 64 * m, threadIdx.x);
  __syncthreads();

  // This warp's rows: 16 * MT from wr; row tile m holds rows wr + 16m + g
  // and + 8.
  const int wr = warp * 16 * MT;
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.sq;
  float lse2[MT][2], dl[MT][2];  // lse in base-2 units, delta
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + wr + 16 * m + 8 * i + g;
      lse2[m][i] = r < a.sq ? lse[r] * kLog2e : 0.0f;
      dl[m][i] = delta_s[wr + 16 * m + 8 * i + g];
    }
  const float* qa = Qs + (wr + g) * ld + 2 * t4;  // A fragments, k order of dots_3xtf32
  const float* ga = Gs + (wr + g) * ld + 2 * t4;
  const float scale = a.scale, c = a.scale * kLog2e;

  float acc[MT][D / 8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;

  // 32-key tiles, double buffered.
  const int ntiles = (a.sk + kChunk - 1) / kChunk;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      load_tile<float, D, kChunk>(Ks + nb * half, kb, a.ks.s, (t + 1) * kChunk, a.sk);
      load_tile<float, D, kChunk>(Vs + nb * half, vb, a.vs.s, (t + 1) * kChunk, a.sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + (t & 1) * half;
    const float* Vt = Vs + (t & 1) * half;

    // s[m][j], dp[m][j]: keys t*32 + 8j + 2*t4 + {0, 1}, rows wr + 16m + g
    // ([0], [1]) and + 8.
    float s[MT][kChunk / 8][4], dp[MT][kChunk / 8][4];
    dots_3xtf32<D, kChunk, MT>(s, qa, Kt, ld, lane);
    dots_3xtf32<D, kChunk, MT>(dp, ga, Vt, ld, lane);
    const int key0 = t * kChunk + 2 * t4;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = key0 + 8 * j + (e & 1) < a.sk;
          const float p = valid ? ex2(fmaf(s[m][j][e], c, -lse2[m][e >> 1])) : 0.0f;
          s[m][j][e] = p * (dp[m][j][e] - dl[m][e >> 1]) * scale;
        }
    product_3xtf32<D, kChunk, MT>(acc, s, Kt, ld, 0, lane);  // dq += ds . K
    __syncthreads();  // this tile's buffers are free for the load after next
  }

  float* dqb = slab<float>(a.dq, a.dqs, b, h);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = q0 + wr + 16 * m + g, r1 = r0 + 8;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if (r0 < a.sq)
        store2<float>(dqb + (long long)r0 * a.dqs.s + col, acc[m][n][0], acc[m][n][1]);
      if (r1 < a.sq)
        store2<float>(dqb + (long long)r1 * a.dqs.s + col, acc[m][n][2], acc[m][n][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1) flash_dkv_tf32(const Args a) {
  constexpr int R = kChunk;  // streamed query rows a step
  constexpr int ld = Tile<float, D>::ld, tile = Tile<float, D>::elems, half = R * ld;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + tile;
  float* Qs = Vs + tile;      // two R-query buffers
  float* Gs = Qs + 2 * half;  // two R-query buffers

  const Walk w(a);
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = w.b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float* qb = slab<float>(a.q, a.qs, b, h);
  const float* gb = slab<float>(a.g, a.gs, b, h);
  // The split's 64-row query tiles [t0, t1) as R-row tiles [c0, c1).
  const int c0 = w.t0 * (kTile / R), c1 = min(w.t1 * (kTile / R), (a.sq + R - 1) / R);

  load_tile<float, D>(Ks, slab<float>(a.k, a.ks, b, h), a.ks.s, k0, a.sk);
  load_tile<float, D>(Vs, slab<float>(a.v, a.vs, b, h), a.vs.s, k0, a.sk);
  load_tile<float, D, R>(Qs, qb, a.qs.s, c0 * R, a.sq);
  load_tile<float, D, R>(Gs, gb, a.gs.s, c0 * R, a.sq);
  cp_async_commit();

  const long long row_base = ((long long)b * a.heads + h) * a.sq;
  const float* lse = a.lse + row_base;
  const float* delta = a.delta + row_base;
  const float* ka = Ks + (warp * 16 + g) * ld + 2 * t4;  // A fragments, k order of dots_3xtf32
  const float* va = Vs + (warp * 16 + g) * ld + 2 * t4;
  const float scale = a.scale, cl = a.scale * kLog2e;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  for (int c = c0; c < c1; ++c) {
    const int i = c - c0;
    if (c + 1 < c1) {
      const int nb = (i + 1) & 1;
      load_tile<float, D, R>(Qs + nb * half, qb, a.qs.s, (c + 1) * R, a.sq);
      load_tile<float, D, R>(Gs + nb * half, gb, a.gs.s, (c + 1) * R, a.sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + (i & 1) * half;
    const float* Gt = Gs + (i & 1) * half;

    // st[j]: queries c*32 + 8j + 2*t4 + {0, 1}, keys g ([0], [1]) and g+8
    // of the warp's 16.
    float st[R / 8][4], dpt[R / 8][4];
    dots_3xtf32<D, R>(st, ka, Qt, ld, lane);
    const int qi0 = c * R + 2 * t4;
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = qi0 + 8 * j + e;
        const bool valid = qi < a.sq;
        const float l = valid ? lse[qi] * kLog2e : 0.0f;
        st[j][e] = valid ? ex2(fmaf(st[j][e], cl, -l)) : 0.0f;
        st[j][2 + e] = valid ? ex2(fmaf(st[j][2 + e], cl, -l)) : 0.0f;
      }
    product_3xtf32<D, R>(dv, st, Gt, ld, 0, lane);  // dv += p^T . G
    dots_3xtf32<D, R>(dpt, va, Gt, ld, lane);       // dP^T
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = qi0 + 8 * j + e;
        const float dl = qi < a.sq ? delta[qi] : 0.0f;
        st[j][e] = st[j][e] * (dpt[j][e] - dl) * scale;
        st[j][2 + e] = st[j][2 + e] * (dpt[j][2 + e] - dl) * scale;
      }
    product_3xtf32<D, R>(dk, st, Qt, ld, 0, lane);  // dk += ds^T . Q
    __syncthreads();  // this tile's buffers are free for the load after next
  }

  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    store_dkv<float, D>(a, w, 0, h, r0, col, dk[n][0], dk[n][1]);
    store_dkv<float, D>(a, w, 0, h, r1, col, dk[n][2], dk[n][3]);
    store_dkv<float, D>(a, w, 1, h, r0, col, dv[n][0], dv[n][1]);
    store_dkv<float, D>(a, w, 1, h, r1, col, dv[n][2], dv[n][3]);
  }
}

// ---- "mma": bf16, mma.sync m16n8k16 (D 128) --------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_mma(const Args a) {
  constexpr int ld = Tile<bf16, D>::ld, tile = Tile<bf16, D>::elems;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float delta_s[kTile];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + tile;
  bf16* Ks = Gs + tile;      // two buffers
  bf16* Vs = Ks + 2 * tile;  // two buffers

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* kb = slab<bf16>(a.k, a.ks, b, h);
  const bf16* vb = slab<bf16>(a.v, a.vs, b, h);

  load_tile<bf16, D>(Qs, slab<bf16>(a.q, a.qs, b, h), a.qs.s, q0, a.sq);
  load_tile<bf16, D>(Gs, slab<bf16>(a.g, a.gs, b, h), a.gs.s, q0, a.sq);
  load_tile<bf16, D>(Ks, kb, a.ks.s, 0, a.sk);
  load_tile<bf16, D>(Vs, vb, a.vs.s, 0, a.sk);
  cp_async_commit();
  row_delta<bf16, D>(a, b, h, q0, delta_s, threadIdx.x);
  __syncthreads();

  // This thread's rows of the warp's 16: r0 = g and r1 = g + 8.
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.sq;
  const float lse0 = r0 < a.sq ? lse[r0] : 0.0f, lse1 = r1 < a.sq ? lse[r1] : 0.0f;
  const float dl0 = delta_s[warp * 16 + g], dl1 = delta_s[warp * 16 + g + 8];
  const bf16* qa = Qs + (warp * 16 + g) * ld + 2 * t4;
  const bf16* ga = Gs + (warp * 16 + g) * ld + 2 * t4;
  const float scale = a.scale;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const int ntiles = (a.sk + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      load_tile<bf16, D>(Ks + nb * tile, kb, a.ks.s, (t + 1) * kTile, a.sk);
      load_tile<bf16, D>(Vs + nb * tile, vb, a.vs.s, (t + 1) * kTile, a.sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + (t & 1) * tile;
    const bf16* Vt = Vs + (t & 1) * tile;

#pragma unroll
    for (int c = 0; c < kTile / kChunk; ++c) {
      // s[j], dp[j]: keys c*32 + 8j + 2*t4 + {0, 1}, rows r0 ([0], [1]) and r1.
      float s[kChunk / 8][4], dp[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qf[4], gf[4];
        load_a(qf, qa + kk * 16, ld);
        load_a(gf, ga + kk * 16, ld);
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) {
          const int off = (c * kChunk + j * 8 + g) * ld + kk * 16 + 2 * t4;
          mma_bf16(s[j], qf, lds32(Kt + off), lds32(Kt + off + 8));
          mma_bf16(dp[j], gf, lds32(Vt + off), lds32(Vt + off + 8));
        }
      }
      const int key0 = t * kTile + c * kChunk + 2 * t4;
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = key0 + 8 * j + e < a.sk;
          const float p0 = valid ? expf(s[j][e] * scale - lse0) : 0.0f;
          const float p1 = valid ? expf(s[j][2 + e] * scale - lse1) : 0.0f;
          s[j][e] = p0 * (dp[j][e] - dl0) * scale;
          s[j][2 + e] = p1 * (dp[j][2 + e] - dl1) * scale;
        }
      // dq += bf16(ds) . K, 16 keys per step.
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        uint32_t da[4];
        pack_a(da, s[2 * ks], s[2 * ks + 1]);
        mma_a_times_tile<D>(acc, da, Kt, c * kChunk + ks * 16, lane);
      }
    }
    __syncthreads();  // this tile's buffers are free for the load after next
  }

  bf16* dqb = slab<bf16>(a.dq, a.dqs, b, h);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (r0 < a.sq) store2<bf16>(dqb + (long long)r0 * a.dqs.s + col, acc[n][0], acc[n][1]);
    if (r1 < a.sq) store2<bf16>(dqb + (long long)r1 * a.dqs.s + col, acc[n][2], acc[n][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_mma(const Args a) {
  constexpr int ld = Tile<bf16, D>::ld, tile = Tile<bf16, D>::elems;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + tile;
  bf16* Qs = Vs + tile;      // two buffers
  bf16* Gs = Qs + 2 * tile;  // two buffers

  const Walk w(a);
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = w.b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = slab<bf16>(a.q, a.qs, b, h);
  const bf16* gb = slab<bf16>(a.g, a.gs, b, h);

  load_tile<bf16, D>(Ks, slab<bf16>(a.k, a.ks, b, h), a.ks.s, k0, a.sk);
  load_tile<bf16, D>(Vs, slab<bf16>(a.v, a.vs, b, h), a.vs.s, k0, a.sk);
  load_tile<bf16, D>(Qs, qb, a.qs.s, w.t0 * kTile, a.sq);
  load_tile<bf16, D>(Gs, gb, a.gs.s, w.t0 * kTile, a.sq);
  cp_async_commit();

  const long long row_base = ((long long)b * a.heads + h) * a.sq;
  const float* lse = a.lse + row_base;
  const float* delta = a.delta + row_base;
  const bf16* ka = Ks + (warp * 16 + g) * ld + 2 * t4;
  const bf16* va = Vs + (warp * 16 + g) * ld + 2 * t4;
  const float scale = a.scale;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  for (int t = w.t0; t < w.t1; ++t) {
    const int i = t - w.t0;
    if (t + 1 < w.t1) {
      const int nb = (i + 1) & 1;
      load_tile<bf16, D>(Qs + nb * tile, qb, a.qs.s, (t + 1) * kTile, a.sq);
      load_tile<bf16, D>(Gs + nb * tile, gb, a.gs.s, (t + 1) * kTile, a.sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + (i & 1) * tile;
    const bf16* Gt = Gs + (i & 1) * tile;

#pragma unroll
    for (int c = 0; c < kTile / kChunk; ++c) {
      // st[j]: queries c*32 + 8j + 2*t4 + {0, 1}, keys g ([0], [1]) and g+8
      // of the warp's 16.
      float st[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4];
        load_a(kf, ka + kk * 16, ld);
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) {
          const int off = (c * kChunk + j * 8 + g) * ld + kk * 16 + 2 * t4;
          mma_bf16(st[j], kf, lds32(Qt + off), lds32(Qt + off + 8));
        }
      }
      const int qi0 = t * kTile + c * kChunk + 2 * t4;
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = qi0 + 8 * j + e;
          const bool valid = qi < a.sq;
          const float l = valid ? lse[qi] : 0.0f;
          st[j][e] = valid ? expf(st[j][e] * scale - l) : 0.0f;
          st[j][2 + e] = valid ? expf(st[j][2 + e] * scale - l) : 0.0f;
        }
      // dv += bf16(p^T) . G, 16 queries per step.
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        uint32_t pa[4];
        pack_a(pa, st[2 * ks], st[2 * ks + 1]);
        mma_a_times_tile<D>(dv, pa, Gt, c * kChunk + ks * 16, lane);
      }
      // dP^T = V . G^T, then ds^T = p^T (dP^T - delta) * scale in place.
      float dpt[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t vf[4];
        load_a(vf, va + kk * 16, ld);
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) {
          const int off = (c * kChunk + j * 8 + g) * ld + kk * 16 + 2 * t4;
          mma_bf16(dpt[j], vf, lds32(Gt + off), lds32(Gt + off + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = qi0 + 8 * j + e;
          const float dl = qi < a.sq ? delta[qi] : 0.0f;
          st[j][e] = st[j][e] * (dpt[j][e] - dl) * scale;
          st[j][2 + e] = st[j][2 + e] * (dpt[j][2 + e] - dl) * scale;
        }
      // dk += bf16(ds^T) . Q.
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        uint32_t da[4];
        pack_a(da, st[2 * ks], st[2 * ks + 1]);
        mma_a_times_tile<D>(dk, da, Qt, c * kChunk + ks * 16, lane);
      }
    }
    __syncthreads();  // this tile's buffers are free for the load after next
  }

  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    store_dkv<bf16, D>(a, w, 0, h, r0, col, dk[n][0], dk[n][1]);
    store_dkv<bf16, D>(a, w, 0, h, r1, col, dk[n][2], dk[n][3]);
    store_dkv<bf16, D>(a, w, 1, h, r0, col, dv[n][0], dv[n][1]);
    store_dkv<bf16, D>(a, w, 1, h, r1, col, dv[n][2], dv[n][3]);
  }
}

// ---- "wide": D 256 or 576, fp32 (split TF32) or bf16 (mma.sync) -------------
//
// 16 rows a block (queries in the dq pass, keys in the dk/dv pass), its warps
// splitting D (flash_common.cuh, namespace wide): the logits and dP (S^T and
// dP^T) are D / 64 partials over 64 columns each, exchanged and summed in
// warp order (at D 576 S's round, then dP's, through one slot); each warp
// then forms p and ds for the whole 16 x kKeys tile and accumulates dq (dk
// and dv) into its own 64 columns. The streamed operands come in kKeys-row
// tiles (32 at D 256, 16 at D 576), double buffered by cp.async. fp32 keeps
// the tf32 variant's arithmetic, bf16 the mma variant's.

template <typename T, int D>
__global__ void __launch_bounds__(wide::Cfg<D>::kThreads) flash_dq_wide(const Args a) {
  using L = wide::Layout<T, D>;
  using C = wide::Cfg<D>;
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int R = wide::kRows, N = C::kKeys, NT = C::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float delta_s[R];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = Qs + R * L::ld;
  T* Ks = Gs + R * L::ld;     // two buffers
  T* Vs = Ks + 2 * L::tile;   // two buffers
  float* X = reinterpret_cast<float*>(Vs + 2 * L::tile);

  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, c0 = warp * wide::kCols;
  const T* kb = slab<T>(a.k, a.ks, b, h);
  const T* vb = slab<T>(a.v, a.vs, b, h);

  load_tile<T, D, R, NT>(Qs, slab<T>(a.q, a.qs, b, h), a.qs.s, q0, a.sq);
  load_tile<T, D, R, NT>(Gs, slab<T>(a.g, a.gs, b, h), a.gs.s, q0, a.sq);
  load_tile<T, D, N, NT>(Ks, kb, a.ks.s, 0, a.sk);
  load_tile<T, D, N, NT>(Vs, vb, a.vs.s, 0, a.sk);
  cp_async_commit();
  if (warp == 0) row_delta<T, D>(a, b, h, q0, delta_s, lane);
  __syncthreads();

  // Rows g and g + 8: lse (fp32: in base-2 units) and delta.
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.sq;
  const int r0 = q0 + g, r1 = r0 + 8;
  const float u = f32 ? kLog2e : 1.0f;
  const float lq[2] = {r0 < a.sq ? lse[r0] * u : 0.0f, r1 < a.sq ? lse[r1] * u : 0.0f};
  const float dl[2] = {delta_s[g], delta_s[g + 8]};
  const float scale = a.scale, c = a.scale * u;

  float acc[wide::kCols / 8][4];
#pragma unroll
  for (int n = 0; n < wide::kCols / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const int ntiles = (a.sk + N - 1) / N;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      load_tile<T, D, N, NT>(Ks + nb * L::tile, kb, a.ks.s, (t + 1) * N, a.sk);
      load_tile<T, D, N, NT>(Vs + nb * L::tile, vb, a.vs.s, (t + 1) * N, a.sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + (t & 1) * L::tile;
    const T* Vt = Vs + (t & 1) * L::tile;

    // sd[0][j] = S, sd[1][j] = dP: keys t*N + 8j + 2*t4 + {0, 1}, rows g
    // ([0], [1]) and g + 8.
    float sd[2][N / 8][4];
    wide::partial<T, D>(sd[0], Qs, Kt, L::ld, c0, lane);
    wide::partial<T, D>(sd[1], Gs, Vt, L::ld, c0, lane);
    wide::exchange<D, 2, C::kBwdSlots>(sd, X, warp, lane);
    const int key0 = t * N + 2 * t4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = key0 + 8 * j + (e & 1) < a.sk;
        const float x = sd[0][j][e];
        const float p = !valid ? 0.0f : f32 ? ex2(fmaf(x, c, -lq[e >> 1]))
                                            : expf(x * scale - lq[e >> 1]);
        sd[0][j][e] = p * (sd[1][j][e] - dl[e >> 1]) * scale;
      }
    wide::product<T, D>(acc, sd[0], Kt + c0, lane);  // dq += ds . K
    __syncthreads();  // this tile's buffers (and X) are free for the next writes
  }

  T* dqb = slab<T>(a.dq, a.dqs, b, h);
#pragma unroll
  for (int n = 0; n < wide::kCols / 8; ++n) {
    const int col = c0 + n * 8 + 2 * t4;
    if (r0 < a.sq) store2<T>(dqb + (long long)r0 * a.dqs.s + col, acc[n][0], acc[n][1]);
    if (r1 < a.sq) store2<T>(dqb + (long long)r1 * a.dqs.s + col, acc[n][2], acc[n][3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(wide::Cfg<D>::kThreads) flash_dkv_wide(const Args a) {
  using L = wide::Layout<T, D>;
  using C = wide::Cfg<D>;
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int R = wide::kRows, N = C::kKeys, NT = C::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + R * L::ld;
  T* Qs = Vs + R * L::ld;     // two buffers
  T* Gs = Qs + 2 * L::tile;   // two buffers
  float* X = reinterpret_cast<float*>(Gs + 2 * L::tile);

  const Walk w(a);
  const int k0 = blockIdx.x * R, h = blockIdx.y, b = w.b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, c0 = warp * wide::kCols;
  const T* qb = slab<T>(a.q, a.qs, b, h);
  const T* gb = slab<T>(a.g, a.gs, b, h);
  // The split's 64-row query tiles [t0, t1) as N-row tiles [i0, i1).
  const int i0 = w.t0 * (kTile / N), i1 = min(w.t1 * (kTile / N), (a.sq + N - 1) / N);

  load_tile<T, D, R, NT>(Ks, slab<T>(a.k, a.ks, b, h), a.ks.s, k0, a.sk);
  load_tile<T, D, R, NT>(Vs, slab<T>(a.v, a.vs, b, h), a.vs.s, k0, a.sk);
  load_tile<T, D, N, NT>(Qs, qb, a.qs.s, i0 * N, a.sq);
  load_tile<T, D, N, NT>(Gs, gb, a.gs.s, i0 * N, a.sq);
  cp_async_commit();

  const long long row_base = ((long long)b * a.heads + h) * a.sq;
  const float* lse = a.lse + row_base;
  const float* delta = a.delta + row_base;
  const float u = f32 ? kLog2e : 1.0f;
  const float scale = a.scale, c = a.scale * u;

  float dk[wide::kCols / 8][4], dv[wide::kCols / 8][4];
#pragma unroll
  for (int n = 0; n < wide::kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  for (int i = i0; i < i1; ++i) {
    const int slot = (i - i0) & 1;
    if (i + 1 < i1) {
      const int nb = slot ^ 1;
      load_tile<T, D, N, NT>(Qs + nb * L::tile, qb, a.qs.s, (i + 1) * N, a.sq);
      load_tile<T, D, N, NT>(Gs + nb * L::tile, gb, a.gs.s, (i + 1) * N, a.sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + slot * L::tile;
    const T* Gt = Gs + slot * L::tile;

    // st[0][j] = S^T, st[1][j] = dP^T: queries i*N + 8j + 2*t4 + {0, 1},
    // keys g ([0], [1]) and g + 8 of the block's 16.
    float st[2][N / 8][4];
    wide::partial<T, D>(st[0], Ks, Qt, L::ld, c0, lane);
    wide::partial<T, D>(st[1], Vs, Gt, L::ld, c0, lane);
    wide::exchange<D, 2, C::kBwdSlots>(st, X, warp, lane);
    const int qi0 = i * N + 2 * t4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = qi0 + 8 * j + e;
        const bool valid = qi < a.sq;
        const float l = valid ? lse[qi] * u : 0.0f;
        const float x0 = st[0][j][e], x1 = st[0][j][2 + e];
        st[0][j][e] = !valid ? 0.0f : f32 ? ex2(fmaf(x0, c, -l)) : expf(x0 * scale - l);
        st[0][j][2 + e] = !valid ? 0.0f : f32 ? ex2(fmaf(x1, c, -l)) : expf(x1 * scale - l);
      }
    wide::product<T, D>(dv, st[0], Gt + c0, lane);  // dv += p^T . G
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = qi0 + 8 * j + e;
        const float dl = qi < a.sq ? delta[qi] : 0.0f;
        st[0][j][e] = st[0][j][e] * (st[1][j][e] - dl) * scale;
        st[0][j][2 + e] = st[0][j][2 + e] * (st[1][j][2 + e] - dl) * scale;
      }
    wide::product<T, D>(dk, st[0], Qt + c0, lane);  // dk += ds^T . Q
    __syncthreads();  // this tile's buffers (and X) are free for the next writes
  }

  const int r0 = k0 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < wide::kCols / 8; ++n) {
    const int col = c0 + n * 8 + 2 * t4;
    store_dkv<T, D>(a, w, 0, h, r0, col, dk[n][0], dk[n][1]);
    store_dkv<T, D>(a, w, 0, h, r1, col, dk[n][2], dk[n][3]);
    store_dkv<T, D>(a, w, 1, h, r0, col, dv[n][0], dv[n][1]);
    store_dkv<T, D>(a, w, 1, h, r1, col, dv[n][2], dv[n][3]);
  }
}

// ---- "wgmma": bf16, D 64, warp-specialized, TMA-fed --------------------------

namespace wg {
constexpr int kDqGroups = 3;   // consumer warpgroups of 64 rows: the dq pass
constexpr int kDkvGroups = 2;  // the dk/dv pass (its four accumulators leave room for two)
constexpr int kStages = 4;               // streamed tile pairs in the ring
constexpr int kTileBytes = kTile * 128;  // one streamed 64-row tile, 64 bf16 (128 bytes) a row
constexpr int kAlign = 1024;             // the 128-byte swizzle's atom

// A block of G consumer warpgroups and one producer warp.
template <int G>
struct Cfg {
  static constexpr int kRows = 64 * G;         // fixed rows: queries (dq), keys (dk/dv)
  static constexpr int kThreads = 128 * G + 32;
  static constexpr int kProducer = 4 * G;      // the producer's warp index
  static constexpr int kFixedBytes = kRows * 128;
  static constexpr size_t kSmem = kAlign + 2 * kFixedBytes + 2 * kStages * kTileBytes +
                                  kRows * 4 + kStages * 2 * kTile * 4 + 128;
};

// The shared layout of both passes: fixed tiles A and B (Q and G, or K and
// V), the ring of streamed tiles (K and V, or Q and G), the dq pass's
// delta, the dk/dv pass's lse (base-2 units) and delta of each streamed
// query tile, the barriers.
template <int G>
struct Smem {
  static constexpr int kRows = Cfg<G>::kRows, kFixedBytes = Cfg<G>::kFixedBytes;
  unsigned char *fa, *fb, *sa, *sb;
  float *delta, *rows;  // rows: per stage, 64 lse then 64 delta
  uint64_t *full, *empty, *fixed_full;
  __device__ __forceinline__ Smem(unsigned char* raw) {
    fa = raw + ((kAlign - (hopper::smem_u32(raw) & (kAlign - 1))) & (kAlign - 1));
    fb = fa + kFixedBytes;
    sa = fb + kFixedBytes;
    sb = sa + kStages * kTileBytes;
    delta = reinterpret_cast<float*>(sb + kStages * kTileBytes);
    rows = delta + kRows;
    full = reinterpret_cast<uint64_t*>(rows + kStages * 2 * kTile);
    empty = full + kStages;
    fixed_full = empty + kStages;
  }
};

template <int G>
__device__ __forceinline__ void init_barriers(const Smem<G>& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&s.full[i], 1);
      hopper::mbar_init(&s.empty[i], 4 * G);  // one arrival per consumer warp
    }
    hopper::mbar_init(s.fixed_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// The producer warp: the two fixed tiles at row f0, then streamed tiles
// [t0, t1) of both streamed maps, kStages ahead; with `rows`, each query
// tile's lse (in base-2 units, +inf past Sq: p = 0 there) and delta into
// the stage's slot, stored by the warp before its arrival.
template <int G>
__device__ __forceinline__ void produce(const Args& a, const Smem<G>& s, const CUtensorMap* fa,
                                        const CUtensorMap* fb, const CUtensorMap* sa,
                                        const CUtensorMap* sb, int f0, int t0, int t1, int h,
                                        int b, bool rows) {
  using namespace hopper;
  const int lane = threadIdx.x & 31;
  const long long row_base = ((long long)b * a.heads + h) * a.sq;
  if (lane == 0) {
    tma_prefetch_map(sa);
    tma_prefetch_map(sb);
    mbar_expect_tx(s.fixed_full, 2 * Cfg<G>::kFixedBytes);
    tma_load_4d(s.fa, fa, s.fixed_full, 0, f0, h, b);
    tma_load_4d(s.fb, fb, s.fixed_full, 0, f0, h, b);
  }
  for (int t = t0, st = 0, ph = 0; t < t1; ++t) {
    mbar_wait(&s.empty[st], ph ^ 1);
    if (lane == 0) {
      mbar_add_tx(&s.full[st], 2 * kTileBytes);
      tma_load_4d(s.sa + st * kTileBytes, sa, &s.full[st], 0, t * kTile, h, b);
      tma_load_4d(s.sb + st * kTileBytes, sb, &s.full[st], 0, t * kTile, h, b);
    }
    if (rows) {
      float* slot = s.rows + st * 2 * kTile;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = lane + 32 * i, qi = t * kTile + r;
        const bool valid = qi < a.sq;
        slot[r] = valid ? __ldg(a.lse + row_base + qi) * kLog2e : INFINITY;
        slot[kTile + r] = valid ? __ldg(a.delta + row_base + qi) : 0.0f;
      }
      __syncwarp();
    }
    if (lane == 0) mbar_arrive(&s.full[st]);
    if (++st == kStages) {
      st = 0;
      ph ^= 1;
    }
  }
}

// Two 64 x 64 logit-like products of one warpgroup, both operands K-major:
// x = A1 . B1^T and y = A2 . B2^T (64 rows of A at a1 / a2, 64 rows of B),
// as two wgmma groups, x's first.
__device__ __forceinline__ void two_dots(float (&x)[32], float (&y)[32], uint32_t a1, uint32_t b1,
                                         uint32_t a2, uint32_t b2) {
  using namespace hopper;
  uint64_t da1[4], db1[4], da2[4], db2[4];
  descs_k(da1, a1);
  descs_k(db1, b1);
  descs_k(da2, a2);
  descs_k(db2, b2);
  const ScaleD sd;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(x, da1[kk], db1[kk], sd(kk));
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(y, da2[kk], db2[kk], sd(kk));
  wgmma_commit();
}

// The register A fragments (4 k16 steps over 64 columns) of the fp32
// accumulators (rows g and g+8, columns 8j + 2*t4 + {0, 1}), rounded to bf16.
__device__ __forceinline__ void pack_acc(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j >> 1][2 * (j & 1)] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[j >> 1][2 * (j & 1) + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// acc (64 x 64) += A (64 x 64 registers) . B, B a streamed 64 x 64 tile
// read N-major (its rows are the product's k), as one wgmma group.
__device__ __forceinline__ void rs_product(float (&acc)[32], const uint32_t (&a)[4][4],
                                           uint32_t b) {
  using namespace hopper;
  uint64_t db[4];
  descs_n(db, b, kTileBytes);
  const ScaleD sd;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<64>(acc, a[kk], db[kk], sd(1));
  wgmma_commit();
}
}  // namespace wg

// Each streamed tile: S and dP as two wgmma groups; p from S while dP runs
// (the exponentials beside the tensor cores), then ds, then the product
// that takes ds from registers.

__global__ void __launch_bounds__(wg::Cfg<wg::kDqGroups>::kThreads, 1)
    flash_dq_wgmma(const Args a, const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap) {
  using namespace hopper;
  using namespace wg;
  constexpr int G = kDqGroups, kRows = Cfg<G>::kRows;
  extern __shared__ unsigned char smem_raw[];
  const Smem<G> sm(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (a.sk + kTile - 1) / kTile;
  init_barriers(sm);

  if (warp == Cfg<G>::kProducer) {
    produce(a, sm, &qmap, &gmap, &kmap, &vmap, q0, 0, ntiles, h, b, false);
    return;
  }
  // ---- consumers: delta for the block's rows, then warpgroup w's 64 rows
  row_delta<bf16, 64>(a, b, h, q0, sm.delta, tid);
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * G) : "memory");  // delta is written
  const int w = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int rr = w * 64 + (warp & 3) * 16 + g;  // this thread's first row in the block
  const int r0 = q0 + rr, r1 = r0 + 8;
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.sq;
  const float lse0 = r0 < a.sq ? lse[r0] * kLog2e : 0.0f;
  const float lse1 = r1 < a.sq ? lse[r1] * kLog2e : 0.0f;
  const float dl0 = sm.delta[rr], dl1 = sm.delta[rr + 8];
  const float scale = a.scale, c = a.scale * kLog2e;
  const uint32_t q_addr = smem_u32(sm.fa) + w * 64 * 128, g_addr = smem_u32(sm.fb) + w * 64 * 128;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  mbar_wait(sm.fixed_full, 0);
  for (int t = 0, st = 0, ph = 0; t < ntiles; ++t) {
    mbar_wait(&sm.full[st], ph);
    const uint32_t k_addr = smem_u32(sm.sa + st * kTileBytes);
    const uint32_t v_addr = smem_u32(sm.sb + st * kTileBytes);
    // s[4j + e], dp[4j + e]: row r0, key 8j + 2*t4 + e; [4j + 2 + e]: row r1.
    float s[32], dp[32];
    two_dots(s, dp, q_addr, k_addr, g_addr, v_addr);
    wgmma_wait<1>();
    fence_operands(s);
    const int key0 = t * kTile + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = key0 + 8 * j + e < a.sk;
        s[4 * j + e] = valid ? ex2(fmaf(s[4 * j + e], c, -lse0)) : 0.0f;
        s[4 * j + 2 + e] = valid ? ex2(fmaf(s[4 * j + 2 + e], c, -lse1)) : 0.0f;
      }
    wgmma_wait<0>();
    fence_operands(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] *= (dp[4 * j + e] - dl0) * scale;
        s[4 * j + 2 + e] *= (dp[4 * j + 2 + e] - dl1) * scale;
      }
    uint32_t da[4][4];
    pack_acc(da, s);
    rs_product(acc, da, k_addr);  // dq += bf16(ds) . K
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
    if (++st == kStages) {
      st = 0;
      ph ^= 1;
    }
  }

  bf16* dqb = slab<bf16>(a.dq, a.dqs, b, h);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (r0 < a.sq) store2<bf16>(dqb + (long long)r0 * a.dqs.s + col, acc[4 * j], acc[4 * j + 1]);
    if (r1 < a.sq)
      store2<bf16>(dqb + (long long)r1 * a.dqs.s + col, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(wg::Cfg<wg::kDkvGroups>::kThreads, 1)
    flash_dkv_wgmma(const Args a, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap gmap) {
  using namespace hopper;
  using namespace wg;
  constexpr int G = kDkvGroups;
  extern __shared__ unsigned char smem_raw[];
  const Smem<G> sm(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const Walk wk(a);
  const int k0 = blockIdx.x * Cfg<G>::kRows, h = blockIdx.y, b = wk.b;
  init_barriers(sm);

  if (warp == Cfg<G>::kProducer) {
    produce(a, sm, &kmap, &vmap, &qmap, &gmap, k0, wk.t0, wk.t1, h, b, true);
    return;
  }
  // ---- consumers: warpgroup w owns keys k0 + 64w .. k0 + 64w + 63 --------------
  const int w = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const float scale = a.scale, c = a.scale * kLog2e;
  const uint32_t k_addr = smem_u32(sm.fa) + w * 64 * 128, v_addr = smem_u32(sm.fb) + w * 64 * 128;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;
  mbar_wait(sm.fixed_full, 0);
  for (int t = wk.t0, st = 0, ph = 0; t < wk.t1; ++t) {
    mbar_wait(&sm.full[st], ph);
    const uint32_t q_addr = smem_u32(sm.sa + st * kTileBytes);
    const uint32_t g_addr = smem_u32(sm.sb + st * kTileBytes);
    const float* l2 = sm.rows + st * 2 * kTile + 2 * t4;  // lse, then delta, by query
    // s[4j + e], dpt[4j + e]: key g of the warp's 16, query 8j + 2*t4 + e
    // of the tile; [4j + 2 + e]: key g + 8.
    float s[32], dpt[32];
    two_dots(s, dpt, k_addr, q_addr, v_addr, g_addr);
    // p^T while dP^T runs; then ds^T and both register operands a key
    // block at a time, so that p^T and dP^T free their registers as they go.
    wgmma_wait<1>();
    fence_operands(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(l2 + 8 * j);
      s[4 * j] = ex2(fmaf(s[4 * j], c, -l.x));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, -l.y));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, -l.x));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, -l.y));
    }
    wgmma_wait<0>();
    fence_operands(dpt);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(l2 + kTile + 8 * j);
      const float d0 = s[4 * j] * (dpt[4 * j] - dl.x) * scale;
      const float d1 = s[4 * j + 1] * (dpt[4 * j + 1] - dl.y) * scale;
      const float d2 = s[4 * j + 2] * (dpt[4 * j + 2] - dl.x) * scale;
      const float d3 = s[4 * j + 3] * (dpt[4 * j + 3] - dl.y) * scale;
      pa[j >> 1][2 * (j & 1)] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      da[j >> 1][2 * (j & 1)] = pack_bf16(d0, d1);
      da[j >> 1][2 * (j & 1) + 1] = pack_bf16(d2, d3);
    }
    rs_product(dv, pa, g_addr);  // dv += bf16(p^T) . G
    rs_product(dk, da, q_addr);  // dk += bf16(ds^T) . Q
    wgmma_wait<0>();
    fence_operands(dv);
    fence_operands(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
    if (++st == kStages) {
      st = 0;
      ph ^= 1;
    }
  }

  const int r0 = k0 + w * 64 + (warp & 3) * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t4;
    store_dkv<bf16, 64>(a, wk, 0, h, r0, col, dk[4 * j], dk[4 * j + 1]);
    store_dkv<bf16, 64>(a, wk, 0, h, r1, col, dk[4 * j + 2], dk[4 * j + 3]);
    store_dkv<bf16, 64>(a, wk, 1, h, r0, col, dv[4 * j], dv[4 * j + 1]);
    store_dkv<bf16, 64>(a, wk, 1, h, r1, col, dv[4 * j + 2], dv[4 * j + 3]);
  }
}

// ---- the split sum: dk and dv from their partials, in split order -----------

template <typename T>
__global__ void flash_split_sum(const Args a, int d) {
  const long long per = (long long)a.nb * a.heads * a.sk * d / 2;  // column pairs of dk
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * per) return;
  const int which = idx >= per;
  const long long e = (idx - which * per) * 2;  // element of (B, H, Sk, D)
  const int col = (int)(e % d);
  const long long row = e / d;
  const int key = (int)(row % a.sk);
  const long long bh = row / a.sk;
  const int h = (int)(bh % a.heads), b = (int)(bh / a.heads);
  const long long stride = (long long)a.nb * a.heads * a.sk * d;  // one split's partial
  const float* p = a.part + (long long)which * a.splits * stride + e;
  float x0 = 0.0f, x1 = 0.0f;
  for (int s = 0; s < a.splits; ++s) {
    const float2 v = *reinterpret_cast<const float2*>(p + s * stride);
    x0 += v.x;
    x1 += v.y;
  }
  T* out = which ? slab<T>(a.dv, a.dvs, b, h) : slab<T>(a.dk, a.dks, b, h);
  store2<T>(out + (long long)key * (which ? a.dvs.s : a.dks.s) + col, x0, x1);
}

// ---- launch ------------------------------------------------------------------

template <typename K>
int raise_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  *done = true;
  return 0;
}

// plan: {variant, dq rows, dq grid x, dq threads, dq smem, dk/dv keys, dk/dv
// grid x, dk/dv threads, dk/dv smem, splits, tiles per split} from
// flash_plan; refused unless it is this variant's geometry and covers the
// shape.
struct Plan {
  int variant, dq_rows, dq_gx, dq_threads, dq_smem, dkv_keys, dkv_gx, dkv_threads, dkv_smem,
      splits, tps;
};

bool covers(const Plan& p, const Args& a, int rows, int threads, size_t smem, int keys,
            int kthreads, size_t ksmem) {
  const int qtiles = (a.sq + kTile - 1) / kTile;
  return p.dq_rows == rows && p.dq_gx == (a.sq + rows - 1) / rows && p.dq_threads == threads &&
         p.dq_smem == (int)smem && p.dkv_keys == keys && p.dkv_gx == (a.sk + keys - 1) / keys &&
         p.dkv_threads == kthreads && p.dkv_smem == (int)ksmem && p.splits >= 1 && p.tps >= 1 &&
         p.splits * p.tps >= qtiles && (p.splits - 1) * p.tps < qtiles;
}

template <typename T>
int sum_splits(const Args& a, int d, cudaStream_t st) {
  if (a.splits == 1) return 0;
  const long long n = (long long)a.nb * a.heads * a.sk * d;  // pairs of dk and dv together
  flash_split_sum<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a, d);
  return (int)cudaGetLastError();
}

template <typename T, int D, int MT, typename KQ, typename KV>
int launch_stream(KQ kdq, KV kdkv, const Plan& p, const Args& a, cudaStream_t st) {
  constexpr size_t qb = Layout<T, D>::template dq_bytes<MT>, kb = Layout<T, D>::dkv_bytes;
  if (!covers(p, a, 64 * MT, kThreads, qb, kTile, kThreads, kb)) return XD_ERR_SHAPE;
  static bool done_dq = false, done_dkv = false;
  int rc = raise_smem(kdq, qb, &done_dq);
  if (!rc) rc = raise_smem(kdkv, kb, &done_dkv);
  if (rc) return rc;
  // The dk/dv pass reads the delta the dq pass writes: same stream, in order.
  kdq<<<dim3(p.dq_gx, a.heads, a.nb), kThreads, qb, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  kdkv<<<dim3(p.dkv_gx, a.heads, a.nb * p.splits), kThreads, kb, st>>>(a);
  rc = (int)cudaGetLastError();
  return rc ? rc : sum_splits<T>(a, D, st);
}

template <typename T, int D>
int launch_wide(const Plan& p, const Args& a, cudaStream_t st) {
  constexpr size_t bytes = wide::Layout<T, D>::bwd_bytes;
  constexpr int threads = wide::Cfg<D>::kThreads;
  if (!covers(p, a, wide::kRows, threads, bytes, wide::kRows, threads, bytes))
    return XD_ERR_SHAPE;
  static bool done_dq = false, done_dkv = false;
  int rc = raise_smem(flash_dq_wide<T, D>, bytes, &done_dq);
  if (!rc) rc = raise_smem(flash_dkv_wide<T, D>, bytes, &done_dkv);
  if (rc) return rc;
  // The dk/dv pass reads the delta the dq pass writes: same stream, in order.
  flash_dq_wide<T, D><<<dim3(p.dq_gx, a.heads, a.nb), threads, bytes, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  flash_dkv_wide<T, D><<<dim3(p.dkv_gx, a.heads, a.nb * p.splits), threads, bytes, st>>>(a);
  rc = (int)cudaGetLastError();
  return rc ? rc : sum_splits<T>(a, D, st);
}

int launch_wgmma(const Plan& p, const Args& a, const long long* s, cudaStream_t st) {
  using Q = wg::Cfg<wg::kDqGroups>;
  using K = wg::Cfg<wg::kDkvGroups>;
  if (!covers(p, a, Q::kRows, Q::kThreads, Q::kSmem, K::kRows, K::kThreads, K::kSmem))
    return XD_ERR_SHAPE;
  // Maps: q and g by kRows rows (dq's fixed tiles) and 64 (dk/dv's streamed
  // ones), k and v the other way round; strides {q, k, v, o, g, ...} x 3.
  CUtensorMap q_fix, g_fix, k_st, v_st, k_fix, v_fix, q_st, g_st;
  int rc = hopper::bf16_rows_map(&q_fix, a.q, a.nb, a.heads, a.sq, 64, s, Q::kRows);
  if (!rc) rc = hopper::bf16_rows_map(&g_fix, a.g, a.nb, a.heads, a.sq, 64, s + 12, Q::kRows);
  if (!rc) rc = hopper::bf16_rows_map(&k_st, a.k, a.nb, a.heads, a.sk, 64, s + 3, kTile);
  if (!rc) rc = hopper::bf16_rows_map(&v_st, a.v, a.nb, a.heads, a.sk, 64, s + 6, kTile);
  if (!rc) rc = hopper::bf16_rows_map(&k_fix, a.k, a.nb, a.heads, a.sk, 64, s + 3, K::kRows);
  if (!rc) rc = hopper::bf16_rows_map(&v_fix, a.v, a.nb, a.heads, a.sk, 64, s + 6, K::kRows);
  if (!rc) rc = hopper::bf16_rows_map(&q_st, a.q, a.nb, a.heads, a.sq, 64, s, kTile);
  if (!rc) rc = hopper::bf16_rows_map(&g_st, a.g, a.nb, a.heads, a.sq, 64, s + 12, kTile);
  if (rc) return rc;
  static bool done_dq = false, done_dkv = false;
  rc = raise_smem(flash_dq_wgmma, Q::kSmem, &done_dq);
  if (!rc) rc = raise_smem(flash_dkv_wgmma, K::kSmem, &done_dkv);
  if (rc) return rc;
  flash_dq_wgmma<<<dim3(p.dq_gx, a.heads, a.nb), Q::kThreads, Q::kSmem, st>>>(a, q_fix, g_fix,
                                                                              k_st, v_st);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  flash_dkv_wgmma<<<dim3(p.dkv_gx, a.heads, a.nb * p.splits), K::kThreads, K::kSmem, st>>>(
      a, k_fix, v_fix, q_st, g_st);
  rc = (int)cudaGetLastError();
  return rc ? rc : sum_splits<bf16>(a, 64, st);
}

}  // namespace

// q, o, g, dq: (B, H, Sq, d); k, v, dk, dv: (B, H, Sk, d), each with unit
// stride on d and its batch / head / row strides (elements) in `strides` as
// {q, k, v, o, g, dq, dk, dv} x {b, h, s}; rows start on 16-byte boundaries
// (checked by the Python wrapper). lse: contiguous fp32 (B, H, Sq), as K5
// writes it; delta: fp32 scratch of B * H * Sq floats; part: fp32 scratch
// of 2 * splits * B * H * Sk * d floats where the plan splits (else
// unused). plan: flash_plan's 11 ints for this shape.
XD_EXPORT int xd_flash_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* o, const void* g, const void* lse,
                                     void* delta, void* dq, void* dk, void* dv, void* part,
                                     int b, int heads, int sq, int sk, int d,
                                     const long long* strides, float scale, int dtype,
                                     const int* plan, void* stream) {
  if (b <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || b > 65535 || heads > 65535)
    return XD_ERR_SHAPE;
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
               plan[6], plan[7], plan[8], plan[9], plan[10]};
  if ((long long)b * p.splits > 65535 || (p.splits > 1 && part == nullptr)) return XD_ERR_SHAPE;
  const long long* s = strides;
  const Args a{q, k, v, o, g, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, dk, dv, static_cast<float*>(part), b, heads, sq, sk, p.splits, p.tps,
               Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
               Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]},
               Strides{s[12], s[13], s[14]}, Strides{s[15], s[16], s[17]},
               Strides{s[18], s[19], s[20]}, Strides{s[21], s[22], s[23]}, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (p.variant == kWide && d == 256) {
    if (dtype == XD_F32) return launch_wide<float, 256>(p, a, st);
    if (dtype == XD_BF16) return launch_wide<bf16, 256>(p, a, st);
  }
  if (p.variant == kWide && d == 576) {
    if (dtype == XD_F32) return launch_wide<float, 576>(p, a, st);
    if (dtype == XD_BF16) return launch_wide<bf16, 576>(p, a, st);
  }
  if (dtype == XD_F32 && p.variant == kTf32) {
    if (d == 64 && p.dq_rows == 128)
      return launch_stream<float, 64, 2>(flash_dq_tf32<64, 2>, flash_dkv_tf32<64>, p, a, st);
    if (d == 64)
      return launch_stream<float, 64, 1>(flash_dq_tf32<64, 1>, flash_dkv_tf32<64>, p, a, st);
    if (d == 128)
      return launch_stream<float, 128, 1>(flash_dq_tf32<128, 1>, flash_dkv_tf32<128>, p, a, st);
    return XD_ERR_SHAPE;
  }
  if (dtype == XD_BF16 && p.variant == kWgmma && d == 64) return launch_wgmma(p, a, s, st);
  if (dtype == XD_BF16 && p.variant == kMma && d == 128)
    return launch_stream<bf16, 128, 1>(flash_dq_mma<128>, flash_dkv_mma<128>, p, a, st);
  return dtype == XD_F32 || dtype == XD_BF16 ? XD_ERR_SHAPE : XD_ERR_DTYPE;
}
