// K5: streamed (online-softmax) non-causal attention forward on (B, H, S, D),
// emitting the output and the per-row logsumexp.
//
// Replaces the Pallas kernel xdiffusion_tpu/ops/flash_attention.py:48
// (`_flash_kernel`, `pallas_call` :119 in `_flash_forward` :108, public
// `flash_attention` :103). Same numerics per key tile: fp32 logits from the
// dots times `scale`, a running row max m and sum l in fp32, the
// unnormalised p = exp(s - m_new) rounded to v's dtype before the P.V
// product (the sum l adds the unrounded p), fp32 accumulation, and at the
// end o = acc / l and lse = m + log(l) in fp32.
//
// Bound on the H100: for a (batch, head) it does 4*Sq*Sk*D flops and
// Sq*Sk exponentials against (2*Sq + 2*Sk)*D elements of traffic, so at the
// LTX shapes (D = 64, S = 512 to 16,384) it is bound by operations: the
// bf16 tensor-core rate and, at D = 64, the exponential rate of the SFUs,
// which is about as tight.
//
// Design: the TPU kernel walks the key tiles as its innermost grid axis and
// carries (m, l, acc) in VMEM scratch from one grid step to the next. Blocks
// on Hopper carry nothing, so each block takes one (batch, head, 64-row
// query tile) and loops over 64-key tiles itself, with K and V double
// buffered in shared memory by cp.async (the next tile loads while this one
// computes). Rows or keys past the end load as zeros; keys past Sk get a
// logit of -inf, rows past Sq are not stored. q, k, v and o are read and
// written through their (batch, head, row) strides, unit stride on D.
//
// - bf16: 4 warps, each owning 16 query rows. Q.K^T and P.V run on the
//   tensor cores (mma.sync m16n8k16, fp32 accumulation); the accumulator
//   layout of Q.K^T is the operand layout P.V needs, so p goes from
//   registers to the tensor cores, rounded to bf16, without shared memory.
//   The Q fragments stay in registers for the whole walk; V's operand comes
//   from ldmatrix.trans.
// - fp32: full-fp32 CUDA-core math (no TF32), so it matches the plain
//   version to rounding. Each thread computes a 4 x 8 block of the logits
//   (rows r, r+16, r+32, r+48; keys k, k+8, ..., k+56); the 8 threads that
//   share rows reduce the row max and sum by shuffles, and p goes through
//   shared memory to the P.V product, where each thread owns 4 rows x D/8
//   output columns.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kRows = kTile;  // query rows per block
constexpr int kKeys = kTile;  // keys per tile

template <typename T, int D>
struct Layout {
  static constexpr int ld = D + Pad<T>::value;  // Q, K, V rows
  static constexpr int tile = kRows * ld;       // elements of one tile
  static constexpr int ldp = kKeys + 4;         // fp32 P rows (fp32 path)
  // Q, two K buffers, two V buffers (+ the fp32 path's P tile).
  static constexpr size_t bytes =
      sizeof(T) * 5 * tile +
      (std::is_same<T, float>::value ? sizeof(float) * kRows * ldp : 0);
};

// ---- bf16: tensor cores ----------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, int heads, int sq, int sk, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale) {
  using L = Layout<bf16, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + L::tile;      // two buffers
  bf16* Vs = Ks + 2 * L::tile;  // two buffers

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  load_tile<bf16, D>(Qs, qb, qs.s, q0, sq);
  load_tile<bf16, D>(Ks, kb, ks.s, 0, sk);
  load_tile<bf16, D>(Vs, vb, vs.s, 0, sk);
  cp_async_commit();

  // This thread's rows of the warp's 16: r0 = g and r1 = g + 8.
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.0f, l1 = 0.0f;  // this thread's share of the row sums

  const int ntiles = (sk + kKeys - 1) / kKeys;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      load_tile<bf16, D>(Ks + nb * L::tile, kb, ks.s, (t + 1) * kKeys, sk);
      load_tile<bf16, D>(Vs + nb * L::tile, vb, vs.s, (t + 1) * kKeys, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      const bf16* qr = Qs + (warp * 16 + g) * L::ld + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], qr + kk * 16, L::ld);
    }
    const bf16* Kt = Ks + (t & 1) * L::tile;
    const bf16* Vt = Vs + (t & 1) * L::tile;

    // s[j]: keys 8j + 2*t4 + {0, 1} of this tile, rows r0 ([0], [1]) and r1.
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const bf16* kp = Kt + (j * 8 + g) * L::ld + kk * 16 + 2 * t4;
        mma_bf16(s[j], qf[kk], lds32(kp), lds32(kp + 8));
      }

    const int key0 = t * kKeys + 2 * t4;
    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = key0 + 8 * j + e < sk;
        s[j][e] = valid ? s[j][e] * scale : -INFINITY;
        s[j][2 + e] = valid ? s[j][2 + e] * scale : -INFINITY;
        tm0 = fmaxf(tm0, s[j][e]);
        tm1 = fmaxf(tm1, s[j][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
      tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
    }
    // Finite: every tile holds at least one key below sk.
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(s[j][e] - mn0);
        s[j][2 + e] = expf(s[j][2 + e] - mn1);
        ps0 += s[j][e];
        ps1 += s[j][2 + e];
      }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }

    // acc += bf16(p) . V, 16 keys per step: p's accumulator fragments of
    // key blocks 2*ks and 2*ks + 1 are the A operand as they stand.
#pragma unroll
    for (int kstep = 0; kstep < kKeys / 16; ++kstep) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kstep], s[2 * kstep + 1]);
      mma_a_times_tile<D>(acc, pa, Vt, kstep * 16, lane);
    }
    __syncthreads();  // this tile's buffers are free for the load after next
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * os.s + c) =
          __floats2bfloat162_rn(acc[n][0] / l0, acc[n][1] / l0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * os.s + c) =
          __floats2bfloat162_rn(acc[n][2] / l1, acc[n][3] / l1);
  }
  if (t4 == 0) {
    float* lb = lse + ((long long)b * heads + h) * sq;
    if (r0 < sq) lb[r0] = m0 + logf(l0);
    if (r1 < sq) lb[r1] = m1 + logf(l1);
  }
}

// ---- fp32: CUDA cores --------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int heads, int sq, int sk, Strides qs,
                  Strides ks, Strides vs, Strides os, float scale) {
  using L = Layout<float, D>;
  constexpr int kCols = D / 8;  // output columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + L::tile;
  float* Vs = Ks + 2 * L::tile;
  float* Ps = Vs + 2 * L::tile;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  // Rows rg + 16*i (i < 4) and keys / columns kg + 8*j: the 8 threads of a
  // row group are consecutive lanes of one warp.
  const int rg = threadIdx.x >> 3, kg = threadIdx.x & 7;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  load_tile<float, D>(Qs, qb, qs.s, q0, sq);
  load_tile<float, D>(Ks, kb, ks.s, 0, sk);
  load_tile<float, D>(Vs, vb, vs.s, 0, sk);
  cp_async_commit();

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }

  const int ntiles = (sk + kKeys - 1) / kKeys;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      load_tile<float, D>(Ks + nb * L::tile, kb, ks.s, (t + 1) * kKeys, sk);
      load_tile<float, D>(Vs + nb * L::tile, vb, vs.s, (t + 1) * kKeys, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + (t & 1) * L::tile;
    const float* Vt = Vs + (t & 1) * L::tile;

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg + 16 * i) * L::ld + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Kt[(kg + 8 * j) * L::ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = t * kKeys + kg + 8 * j < sk ? s[i][j] * scale : -INFINITY;
        tm = fmaxf(tm, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, off));
      const float mn = fmaxf(m[i], tm);
      const float a = expf(m[i] - mn);
      float ps = 0.0f;
      float* prow = Ps + (rg + 16 * i) * L::ldp + kg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;
        prow[8 * j] = p;
      }
      l[i] = l[i] * a + ps;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= a;
    }
    __syncwarp();  // a row group's P rows are written and read by its own warp

#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg + 16 * i) * L::ldp + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = Vt[key * L::ld + kg + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    __syncthreads();  // K, V and P are free for the next tile
  }

  float* ob = o + b * os.b + h * os.h;
  float* lb = lse + ((long long)b * heads + h) * sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int r = q0 + rg + 16 * i;
    if (r < sq) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) ob[(long long)r * os.s + kg + 8 * c] = acc[i][c] / li;
      if (kg == 0) lb[r] = m[i] + logf(li);
    }
  }
}

// ---- launch ------------------------------------------------------------------

template <int D>
auto kernel_for(float) { return flash_fwd_f32<D>; }
template <int D>
auto kernel_for(bf16) { return flash_fwd_bf16<D>; }

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
           int heads, int sq, int sk, const long long* st, float scale,
           cudaStream_t stream) {
  auto kernel = kernel_for<D>(T{});
  constexpr size_t bytes = Layout<T, D>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((sq + kRows - 1) / kRows, heads, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, heads, sq, sk,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse,
               int b, int heads, int sq, int sk, int d, const long long* st,
               float scale, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, lse, b, heads, sq, sk, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, heads, sq, sk, st, scale, stream);
    default: return XD_ERR_SHAPE;
  }
}

}  // namespace

// q: (B, H, Sq, d), k/v: (B, H, Sk, d), o: (B, H, Sq, d), each with unit stride
// on d and its batch / head / row strides (elements) in `strides` as
// {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s}; rows start on
// 16-byte boundaries (checked by the Python wrapper). lse: contiguous fp32
// (B, H, Sq). d is 64 or 128.
XD_EXPORT int xd_flash_attention(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int b, int heads, int sq, int sk, int d,
                                 const long long* strides, float scale, int dtype,
                                 void* stream) {
  if (b <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || b > 65535 || heads > 65535)
    return XD_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dtype == XD_F32)
    return dispatch_d<float>(q, k, v, o, l, b, heads, sq, sk, d, strides, scale, st);
  if (dtype == XD_BF16)
    return dispatch_d<bf16>(q, k, v, o, l, b, heads, sq, sk, d, strides, scale, st);
  return XD_ERR_DTYPE;
}
