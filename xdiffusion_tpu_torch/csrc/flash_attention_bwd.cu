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
// Sq = 512 or 16,384, Sk = 128 to 16,384) operations bound it, in bf16 the
// tensor cores, in fp32 the CUDA cores; only the 128-key caption
// cross-attention comes near the bytes.
//
// Design: two launches with no atomics, as the TPU splits it, so results
// repeat exactly from run to run:
//
//   dq pass, one block per (batch, head, 64-row query tile): delta for its
//   rows (also stored for the other pass), then a walk over the 64-key
//   tiles, K and V double buffered by cp.async: S = Q.K^T, dP = G.V^T, p,
//   ds, dq += ds . K.
//
//   dk/dv pass, one block per (batch, head, 64-key tile): a walk over the
//   64-row query tiles, Q and G double buffered: the transposed tiles
//   S^T = K.Q^T and dP^T = V.G^T, so p^T and ds^T come out with one key per
//   row, the rows dv and dk accumulate; dv += p^T . G, dk += ds^T . Q.
//
// The dk/dv pass recomputes S and dP: 14 products of Sq*Sk*D where 10 are
// needed, traded for no (Sq, Sk) tensor in device memory. Rows past Sq and
// keys past Sk load as zeros and their p is set to 0; they are not stored.
// q, k, v, o and g are read, and dq, dk and dv written, through their
// (batch, head, row) strides with unit stride on D.
//
// - bf16: each of the 4 warps owns 16 rows of the block's tile (queries in
//   the dq pass, keys in the dk/dv pass) and walks the streamed tile in
//   chunks of 32 on mma.sync m16n8k16. The accumulators of S (S^T) and dP
//   (dP^T) are laid out as the A operand of the next product, so ds (p^T,
//   ds^T) goes back to the tensor cores from registers, rounded to bf16;
//   the B operand of that product comes from ldmatrix.trans.
// - fp32: full-fp32 CUDA-core math (no TF32), as K5. Each thread computes a
//   4 x 8 block of the (transposed) tile: rows r, r+16, r+32, r+48 and
//   columns c, c+8, ..., c+56; ds (p^T, then ds^T in place) goes through a
//   64x64 shared tile to the product, where each thread owns 4 rows x D/8
//   output columns. The 8 threads of a row group are lanes of one warp, so
//   the shared tile needs only warp barriers.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kChunk = 32;  // streamed rows per mma step (bf16)

template <typename T, int D>
struct Layout {
  using Tl = Tile<T, D>;
  // Two fixed tiles, two double-buffered streamed tiles, and in fp32 the
  // ds / p tile.
  static constexpr size_t bytes =
      sizeof(T) * 6 * Tl::elems +
      (std::is_same<T, float>::value ? sizeof(float) * kTile * kLdp : 0);
};

struct Args {
  const void *q, *k, *v, *o, *g;
  const float* lse;  // (B, H, Sq), contiguous
  float* delta;      // (B, H, Sq), written by the dq pass
  void *dq, *dk, *dv;
  int heads, sq, sk;
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

// delta = rowsum(g * o) in fp32 for rows [q0, q0 + 64) of (b, h), read from
// device memory, two threads a row; into `out` (0 past Sq) and a.delta.
template <typename T, int D>
__device__ __forceinline__ void row_delta(const Args& a, int b, int h, int q0,
                                          float* out) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
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

// ---- bf16: tensor cores ----------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) dq_bf16(const Args a) {
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
  row_delta<bf16, D>(a, b, h, q0, delta_s);
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
    if (r0 < a.sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)r0 * a.dqs.s + col) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (r1 < a.sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)r1 * a.dqs.s + col) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_bf16(const Args a) {
  constexpr int ld = Tile<bf16, D>::ld, tile = Tile<bf16, D>::elems;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + tile;
  bf16* Qs = Vs + tile;      // two buffers
  bf16* Gs = Qs + 2 * tile;  // two buffers

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = slab<bf16>(a.q, a.qs, b, h);
  const bf16* gb = slab<bf16>(a.g, a.gs, b, h);

  load_tile<bf16, D>(Ks, slab<bf16>(a.k, a.ks, b, h), a.ks.s, k0, a.sk);
  load_tile<bf16, D>(Vs, slab<bf16>(a.v, a.vs, b, h), a.vs.s, k0, a.sk);
  load_tile<bf16, D>(Qs, qb, a.qs.s, 0, a.sq);
  load_tile<bf16, D>(Gs, gb, a.gs.s, 0, a.sq);
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

  const int ntiles = (a.sq + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      load_tile<bf16, D>(Qs + nb * tile, qb, a.qs.s, (t + 1) * kTile, a.sq);
      load_tile<bf16, D>(Gs + nb * tile, gb, a.gs.s, (t + 1) * kTile, a.sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + (t & 1) * tile;
    const bf16* Gt = Gs + (t & 1) * tile;

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
  bf16* dkb = slab<bf16>(a.dk, a.dks, b, h);
  bf16* dvb = slab<bf16>(a.dv, a.dvs, b, h);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (r0 < a.sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)r0 * a.dks.s + col) =
          __floats2bfloat162_rn(dk[n][0], dk[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)r0 * a.dvs.s + col) =
          __floats2bfloat162_rn(dv[n][0], dv[n][1]);
    }
    if (r1 < a.sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)r1 * a.dks.s + col) =
          __floats2bfloat162_rn(dk[n][2], dk[n][3]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)r1 * a.dvs.s + col) =
          __floats2bfloat162_rn(dv[n][2], dv[n][3]);
    }
  }
}

// ---- fp32: CUDA cores --------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) dq_f32(const Args a) {
  constexpr int tile = Tile<float, D>::elems;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float delta_s[kTile];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + tile;
  float* Ks = Gs + tile;      // two buffers
  float* Vs = Ks + 2 * tile;  // two buffers
  float* DS = Vs + 2 * tile;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  // Rows rg + 16i (i < 4), keys / columns kg + 8j: the 8 threads of a row
  // group are consecutive lanes of one warp.
  const int rg = threadIdx.x >> 3, kg = threadIdx.x & 7;
  const float* kb = slab<float>(a.k, a.ks, b, h);
  const float* vb = slab<float>(a.v, a.vs, b, h);

  load_tile<float, D>(Qs, slab<float>(a.q, a.qs, b, h), a.qs.s, q0, a.sq);
  load_tile<float, D>(Gs, slab<float>(a.g, a.gs, b, h), a.gs.s, q0, a.sq);
  load_tile<float, D>(Ks, kb, a.ks.s, 0, a.sk);
  load_tile<float, D>(Vs, vb, a.vs.s, 0, a.sk);
  cp_async_commit();
  row_delta<float, D>(a, b, h, q0, delta_s);
  __syncthreads();

  const float* lse = a.lse + ((long long)b * a.heads + h) * a.sq;
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg + 16 * i;
    lse_r[i] = r < a.sq ? lse[r] : 0.0f;
    dl_r[i] = delta_s[rg + 16 * i];
  }
  const float scale = a.scale;
  float acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.0f;

  const int ntiles = (a.sk + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      load_tile<float, D>(Ks + nb * tile, kb, a.ks.s, (t + 1) * kTile, a.sk);
      load_tile<float, D>(Vs + nb * tile, vb, a.vs.s, (t + 1) * kTile, a.sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + (t & 1) * tile;
    const float* Vt = Vs + (t & 1) * tile;

    float s[4][8], dp[4][8];
    tile_dots<D>(s, Qs, Kt, rg, kg);
    tile_dots<D>(dp, Gs, Vt, rg, kg);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool valid = t * kTile + kg + 8 * j < a.sk;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = valid ? expf(s[i][j] * scale - lse_r[i]) : 0.0f;
        DS[(rg + 16 * i) * kLdp + kg + 8 * j] = p * (dp[i][j] - dl_r[i]) * scale;
      }
    }
    __syncwarp();  // a row group's dS rows are written and read by its own warp
    tile_product<D>(acc, DS, Kt, rg, kg);
    __syncthreads();  // K, V and dS are free for the next tile
  }
  store_rows<D>(static_cast<float*>(a.dq), a.dqs, b, h, q0, a.sq, acc, rg, kg);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_f32(const Args a) {
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
  const float* qb = slab<float>(a.q, a.qs, b, h);
  const float* gb = slab<float>(a.g, a.gs, b, h);

  load_tile<float, D>(Ks, slab<float>(a.k, a.ks, b, h), a.ks.s, k0, a.sk);
  load_tile<float, D>(Vs, slab<float>(a.v, a.vs, b, h), a.vs.s, k0, a.sk);
  load_tile<float, D>(Qs, qb, a.qs.s, 0, a.sq);
  load_tile<float, D>(Gs, gb, a.gs.s, 0, a.sq);
  cp_async_commit();

  const long long row_base = ((long long)b * a.heads + h) * a.sq;
  const float* lse = a.lse + row_base;
  const float* delta = a.delta + row_base;
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
      load_tile<float, D>(Qs + nb * tile, qb, a.qs.s, (t + 1) * kTile, a.sq);
      load_tile<float, D>(Gs + nb * tile, gb, a.gs.s, (t + 1) * kTile, a.sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + (t & 1) * tile;
    const float* Gt = Gs + (t & 1) * tile;

    float s[4][8];
    tile_dots<D>(s, Ks, Qt, rg, kg);  // S^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qi = t * kTile + kg + 8 * j;
      const bool valid = qi < a.sq;
      const float l = valid ? lse[qi] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        P[(rg + 16 * i) * kLdp + kg + 8 * j] = valid ? expf(s[i][j] * scale - l) : 0.0f;
    }
    __syncwarp();
    tile_product<D>(dv, P, Gt, rg, kg);  // dv += p^T . G
    tile_dots<D>(s, Vs, Gt, rg, kg);     // dP^T
    __syncwarp();  // every lane has read p^T for dv
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qi = t * kTile + kg + 8 * j;
      const float dl = qi < a.sq ? delta[qi] : 0.0f;
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
  store_rows<D>(static_cast<float*>(a.dk), a.dks, b, h, k0, a.sk, dk, rg, kg);
  store_rows<D>(static_cast<float*>(a.dv), a.dvs, b, h, k0, a.sk, dv, rg, kg);
}

// ---- launch ------------------------------------------------------------------

template <int D>
auto dq_kernel(float) { return dq_f32<D>; }
template <int D>
auto dq_kernel(bf16) { return dq_bf16<D>; }
template <int D>
auto dkv_kernel(float) { return dkv_f32<D>; }
template <int D>
auto dkv_kernel(bf16) { return dkv_bf16<D>; }

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
int launch(const Args& a, int b, cudaStream_t st) {
  constexpr size_t bytes = Layout<T, D>::bytes;
  auto kdq = dq_kernel<D>(T{});
  auto kdkv = dkv_kernel<D>(T{});
  static bool done_dq = false, done_dkv = false;
  int rc = configure(kdq, bytes, &done_dq);
  if (rc) return rc;
  rc = configure(kdkv, bytes, &done_dkv);
  if (rc) return rc;
  // The dk/dv pass reads the delta the dq pass writes: same stream, in order.
  kdq<<<dim3((a.sq + kTile - 1) / kTile, a.heads, b), kThreads, bytes, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  kdkv<<<dim3((a.sk + kTile - 1) / kTile, a.heads, b), kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a, int b, int d, cudaStream_t st) {
  switch (d) {
    case 64: return launch<T, 64>(a, b, st);
    case 128: return launch<T, 128>(a, b, st);
    default: return XD_ERR_SHAPE;
  }
}

}  // namespace

// q, o, g, dq: (B, H, Sq, d); k, v, dk, dv: (B, H, Sk, d), each with unit
// stride on d and its batch / head / row strides (elements) in `strides` as
// {q, k, v, o, g, dq, dk, dv} x {b, h, s}; rows start on 16-byte boundaries
// (checked by the Python wrapper). lse: contiguous fp32 (B, H, Sq), as K5
// writes it; delta: fp32 scratch of B * H * Sq floats. d is 64 or 128.
XD_EXPORT int xd_flash_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* o, const void* g, const void* lse,
                                     void* delta, void* dq, void* dk, void* dv, int b,
                                     int heads, int sq, int sk, int d,
                                     const long long* strides, float scale, int dtype,
                                     void* stream) {
  if (b <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || b > 65535 || heads > 65535)
    return XD_ERR_SHAPE;
  const long long* s = strides;
  const Args a{q, k, v, o, g, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, dk, dv, heads, sq, sk,
               Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
               Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]},
               Strides{s[12], s[13], s[14]}, Strides{s[15], s[16], s[17]},
               Strides{s[18], s[19], s[20]}, Strides{s[21], s[22], s[23]}, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == XD_F32) return dispatch_d<float>(a, b, d, st);
  if (dtype == XD_BF16) return dispatch_d<bf16>(a, b, d, st);
  return XD_ERR_DTYPE;
}
