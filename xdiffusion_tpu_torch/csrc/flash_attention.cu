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
// LTX shapes (D = 64, S = 512 to 16,384) it is bound by operations: in bf16
// the tensor cores and, at D = 64, the exponential rate of the SFUs, which
// is about as tight; in fp32 three TF32 products per product (below).
//
// The TPU kernel walks the key tiles as its innermost grid axis and carries
// (m, l, acc) in VMEM scratch from one grid step to the next. Blocks on
// Hopper carry nothing, so each block takes one (batch, head, query tile)
// and loops over the key tiles itself. Four variants, which `flash_plan`
// (ops/flash_attention.py) names by dtype and head dim:
//
// - "tf32", fp32, D 64 or 128: fp32 on the tensor cores by split TF32. Each
//   fp32 operand x is hi = tf32(x) and lo = x - hi; a product is lo.hi +
//   hi.lo + hi.hi on mma.sync m16n8k8, accumulated in fp32, which keeps the
//   error near 2^-21 of each product. Four warps of 16 query rows (64 a
//   block), or of 32 at D 64 where the grid stays large (each K and V
//   fragment split once for both row tiles), K and V double buffered by
//   cp.async in padded shared
//   tiles; mma.sync takes its B fragments from plain shared loads, so K
//   (logits) and V (P.V, an N-major B that wgmma refuses for tf32) are read
//   as they land. p goes back to the tensor cores from registers in the key
//   order that makes the logits' accumulator layout the A layout
//   (flash_common.cuh).
// - "wgmma", bf16, D 64: three consumer warpgroups of 64 query rows (192 a
//   block) and one producer warp, which loads the block's Q tile and then
//   streams 128-key K and V tiles by TMA (128-byte swizzle, rows past Sk
//   zero-filled) through a ring of kStages stages on mbarriers. S = Q.K^T
//   is a wgmma with both operands K-major in shared memory; its
//   accumulators hold the row's 128 logits, and p, rounded to bf16, goes
//   back from them as the register A operand of P.V, whose B (V, N-major)
//   wgmma reads transposed. The exponentials run in base 2 on the scaled
//   logits.
// - "mma", bf16, D 128: 4 warps of 16 rows on mma.sync m16n8k16, K and V
//   double buffered by cp.async; the Q fragments stay in registers and p
//   goes from the logits' accumulators to the tensor cores.
// - "wide", fp32 or bf16, D 256 (WideFormer-PixArt's 8 heads of 256) or
//   576 (Sana's 2 cross-attention heads): 16 query rows a block, its 4 or 9
//   warps each owning 64 columns of D (flash_common.cuh, namespace wide),
//   32-key tiles (16 at D 576). At WideFormer's site, 16
//   queries against 77 caption keys, a (batch, head) reads 16 rows of q
//   and 77 of k and v: the bound is bytes (4*Sq*Sk*D flops against
//   (2*Sq + 2*Sk)*D elements), and one block a (batch, head) fills the
//   card at batch 128 (1,024 blocks).
//
// Rows or keys past the end load as zeros; keys past Sk get a logit of
// -inf, rows past Sq are not stored. q, k, v and o are read and written
// through their (batch, head, row) strides, unit stride on D.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

enum { kTf32 = 0, kMma = 1, kWgmma = 2, kWide = 3 };
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// ---- "tf32": fp32, split TF32 on mma.sync --------------------------------

template <typename T, int D>
struct Layout {
  static constexpr int ld = D + Pad<T>::value;  // Q, K, V rows
  static constexpr int tile = kTile * ld;       // elements of one 64-row tile
  // Q (64 * MT rows), two K buffers, two V buffers.
  template <int MT>
  static constexpr size_t bytes = sizeof(T) * (MT + 4) * tile;
};

// MT row tiles of 16 a warp: 64 * MT query rows a block. With two (the
// plan's choice at D 64 where the grid stays large), each K and V fragment
// is loaded and split once for both.
template <int D, int MT>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                   int heads, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale) {
  using L = Layout<float, D>;
  constexpr int kRows = 64 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + MT * L::tile;  // two buffers
  float* Vs = Ks + 2 * L::tile;   // two buffers

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  load_tile<float, D, kRows>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, sq);
  load_tile<float, D>(Ks, kb, ks.s, 0, sk);
  load_tile<float, D>(Vs, vb, vs.s, 0, sk);
  cp_async_commit();

  // This warp's rows: 16 * MT from wr; row tile m holds rows wr + 16m + g
  // ([m][0]) and + 8 ([m][1]).
  const int wr = warp * 16 * MT;
  float acc[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.0f;
  float m[MT][2], l[MT][2];  // running maxima (base-2 units); this thread's share of the sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = -INFINITY;
      l[mt][i] = 0.0f;
    }
  const float c = scale * kLog2e;
  const float* qa = Qs + (wr + g) * L::ld + 2 * t4;  // k order of dots_3xtf32

  const int ntiles = (sk + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      load_tile<float, D>(Ks + nb * L::tile, kb, ks.s, (t + 1) * kTile, sk);
      load_tile<float, D>(Vs + nb * L::tile, vb, vs.s, (t + 1) * kTile, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + (t & 1) * L::tile;
    const float* Vt = Vs + (t & 1) * L::tile;

    // s[m][j]: keys 8j + 2*t4 + {0, 1} of this tile, rows wr + 16m + g
    // ([0], [1]) and + 8 ([2], [3]).
    float s[MT][kTile / 8][4];
    dots_3xtf32<D, kTile, MT>(s, qa, Kt, L::ld, lane);

    // Logits in base-2 units (s * scale * log2(e)): each p is one ex2.
    const int key0 = t * kTile + 2 * t4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = key0 + 8 * j + e < sk;
          s[mt][j][e] = valid ? s[mt][j][e] * c : -INFINITY;
          s[mt][j][2 + e] = valid ? s[mt][j][2 + e] * c : -INFINITY;
          tm0 = fmaxf(tm0, s[mt][j][e]);
          tm1 = fmaxf(tm1, s[mt][j][2 + e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
        tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
      }
      // Finite: every tile holds at least one key below sk.
      const float mn0 = fmaxf(m[mt][0], tm0), mn1 = fmaxf(m[mt][1], tm1);
      const float a0 = ex2(m[mt][0] - mn0), a1 = ex2(m[mt][1] - mn1);
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[mt][j][e] = ex2(s[mt][j][e] - mn0);
          s[mt][j][2 + e] = ex2(s[mt][j][2 + e] - mn1);
          ps0 += s[mt][j][e];
          ps1 += s[mt][j][2 + e];
        }
      l[mt][0] = l[mt][0] * a0 + ps0;
      l[mt][1] = l[mt][1] * a1 + ps1;
      m[mt][0] = mn0;
      m[mt][1] = mn1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[mt][n][0] *= a0;
        acc[mt][n][1] *= a0;
        acc[mt][n][2] *= a1;
        acc[mt][n][3] *= a1;
      }
    }
    product_3xtf32<D, kTile, MT>(acc, s, Vt, L::ld, 0, lane);
    __syncthreads();  // this tile's buffers are free for the load after next
  }

  float* ob = o + b * os.b + h * os.h;
  float* lb = lse + ((long long)b * heads + h) * sq;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
      const int r = q0 + wr + 16 * mt + 8 * i + g;
      if (r < sq) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(ob + (long long)r * os.s + n * 8 + 2 * t4) =
              make_float2(acc[mt][n][2 * i] / li, acc[mt][n][2 * i + 1] / li);
        if (t4 == 0) lb[r] = m[mt][i] * kLn2 + logf(li);
      }
    }
}

// ---- "mma": bf16, mma.sync m16n8k16 (D 128) --------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                  int heads, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
                  float scale) {
  using L = Layout<bf16, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + L::tile;      // two buffers
  bf16* Vs = Ks + 2 * L::tile;  // two buffers

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
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

  const int ntiles = (sk + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      load_tile<bf16, D>(Ks + nb * L::tile, kb, ks.s, (t + 1) * kTile, sk);
      load_tile<bf16, D>(Vs + nb * L::tile, vb, vs.s, (t + 1) * kTile, sk);
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
    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const bf16* kp = Kt + (j * 8 + g) * L::ld + kk * 16 + 2 * t4;
        mma_bf16(s[j], qf[kk], lds32(kp), lds32(kp + 8));
      }

    const int key0 = t * kTile + 2 * t4;
    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
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
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
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
    for (int kstep = 0; kstep < kTile / 16; ++kstep) {
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

// ---- "wgmma": bf16, D 64, warp-specialized, TMA-fed --------------------------

namespace wg {
constexpr int kGroups = 3;                // consumer warpgroups of 64 query rows
constexpr int kRows = 64 * kGroups;       // query rows a block
constexpr int kKeys = 128;                // keys a tile
constexpr int kStages = 3;                // (K, V) tile pairs in the ring
constexpr int kThreads = 128 * kGroups + 32;  // the consumers and one producer warp
constexpr int kQBytes = kRows * 128;      // 64 bf16 (128 bytes) a row
constexpr int kTileBytes = kKeys * 128;   // one K or V tile
constexpr int kAlign = 1024;              // the 128-byte swizzle's atom
constexpr size_t kSmem = kAlign + kQBytes + 2 * kStages * kTileBytes + 64;
}  // namespace wg

__global__ void __launch_bounds__(wg::kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                    float* __restrict__ lse, int heads, int sq, int sk, Strides os,
                    float scale) {
  using namespace hopper;
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs =
      smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  unsigned char* Ks = Qs + kQBytes;
  unsigned char* Vs = Ks + kStages * kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kStages * kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int tid = threadIdx.x, lane = tid & 31;
  // Warp-uniform roles, as the compiler can see: a wgmma on a path it
  // thinks divergent is serialized.
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (sk + kKeys - 1) / kKeys;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * kGroups);  // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kGroups) {
    // ---- producer: Q once, then K and V, kStages tiles ahead -------------------
    if (lane == 0) {
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_expect_tx(q_full, kQBytes);
      tma_load_4d(Qs, &qmap, q_full, 0, q0, h, b);
      for (int t = 0, st = 0, ph = 0; t < ntiles; ++t) {
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        tma_load_4d(Ks + st * kTileBytes, &kmap, &full[st], 0, t * kKeys, h, b);
        tma_load_4d(Vs + st * kTileBytes, &vmap, &full[st], 0, t * kKeys, h, b);
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows 64w .. 64w + 63 -------------------
  const int w = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const uint32_t q_addr = smem_u32(Qs) + w * 64 * 128;
  const float c = scale * kLog2e;  // logits into base-2 exponents
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima, in base-2 units
  float l0 = 0.0f, l1 = 0.0f;
  mbar_wait(q_full, 0);

  for (int t = 0, st = 0, ph = 0; t < ntiles; ++t) {
    mbar_wait(&full[st], ph);
    const uint32_t k_addr = smem_u32(Ks + st * kTileBytes);
    const uint32_t v_addr = smem_u32(Vs + st * kTileBytes);
    // s[4j + e]: row g, key 8j + 2*t4 + e; s[4j + 2 + e]: row g + 8.
    float s[64];
    uint64_t dq[4], dk[4];
    descs_k(dq, q_addr);
    descs_k(dk, k_addr);
    const ScaleD sd;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(s, dq[kk], dk[kk], sd(kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    const int key0 = t * kKeys + 2 * t4;
    const bool ragged = t * kKeys + kKeys > sk;
    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = !ragged || key0 + 8 * j + e < sk;
        s[4 * j + e] = valid ? s[4 * j + e] * c : -INFINITY;
        s[4 * j + 2 + e] = valid ? s[4 * j + 2 + e] * c : -INFINITY;
        tm0 = fmaxf(tm0, s[4 * j + e]);
        tm1 = fmaxf(tm1, s[4 * j + 2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
      tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
    }
    // Finite: every tile holds at least one key below sk.
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const float p0 = ex2(s[4 * j] - mn0), p1 = ex2(s[4 * j + 1] - mn0);
      const float p2 = ex2(s[4 * j + 2] - mn1), p3 = ex2(s[4 * j + 3] - mn1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      // Key block j is half (j & 1) of the A fragment of k16 step j / 2.
      pa[j >> 1][2 * (j & 1)] = pack_bf16(p0, p1);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[4 * j] *= a0;
      acc[4 * j + 1] *= a0;
      acc[4 * j + 2] *= a1;
      acc[4 * j + 3] *= a1;
    }
    // acc += bf16(p) . V: V's rows are the k of the product, N-major.
    uint64_t dv[kKeys / 16];
    descs_n(dv, v_addr, kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) wgmma_rs<64>(acc, pa[kk], dv[kk], sd(1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (++st == kStages) {
      st = 0;
      ph ^= 1;
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + w * 64 + (warp & 3) * 16 + g, r1 = r0 + 8;
  bf16* ob = o + b * os.b + h * os.h;
  const float i0 = 1.0f / l0, i1 = 1.0f / l1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * os.s + col) =
          __floats2bfloat162_rn(acc[4 * j] * i0, acc[4 * j + 1] * i0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * os.s + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * i1, acc[4 * j + 3] * i1);
  }
  if (t4 == 0) {
    float* lb = lse + ((long long)b * heads + h) * sq;
    if (r0 < sq) lb[r0] = m0 * kLn2 + logf(l0);
    if (r1 < sq) lb[r1] = m1 * kLn2 + logf(l1);
  }
}

// ---- "wide": D 256 or 576, fp32 (split TF32) or bf16 (mma.sync) -------------
//
// 16 query rows a block, its warps splitting D (flash_common.cuh, namespace
// wide): each logit tile is D / 64 partials over 64 columns summed in warp
// order; each warp keeps the row max and sum and accumulates P.V into its 64
// columns of o. K and V stream in kKeys-key tiles (32 at D 256, 16 at D
// 576), double buffered by cp.async. fp32 keeps the tf32 variant's
// arithmetic (base-2 logits, p split again for P.V), bf16 the mma variant's.
template <typename T, int D>
__global__ void __launch_bounds__(wide::Cfg<D>::kThreads)
    flash_fwd_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, float* __restrict__ lse, int heads, int sq, int sk,
                   Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  using L = wide::Layout<T, D>;
  using C = wide::Cfg<D>;
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int R = wide::kRows, N = C::kKeys, NT = C::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + R * L::ld;      // two buffers
  T* Vs = Ks + 2 * L::tile;    // two buffers
  float* X = reinterpret_cast<float*>(Vs + 2 * L::tile);

  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, c0 = warp * wide::kCols;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  load_tile<T, D, R, NT>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, sq);
  load_tile<T, D, N, NT>(Ks, kb, ks.s, 0, sk);
  load_tile<T, D, N, NT>(Vs, vb, vs.s, 0, sk);
  cp_async_commit();

  float acc[wide::kCols / 8][4];
#pragma unroll
  for (int n = 0; n < wide::kCols / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  // Rows g and g + 8: running maxima (fp32: base-2 units), this thread's
  // share of the sums.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  const float c = f32 ? scale * kLog2e : scale;

  const int ntiles = (sk + N - 1) / N;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      load_tile<T, D, N, NT>(Ks + nb * L::tile, kb, ks.s, (t + 1) * N, sk);
      load_tile<T, D, N, NT>(Vs + nb * L::tile, vb, vs.s, (t + 1) * N, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + (t & 1) * L::tile;
    const T* Vt = Vs + (t & 1) * L::tile;

    // s[0][j]: keys t*N + 8j + 2*t4 + {0, 1}, rows g ([0], [1]) and g + 8.
    float s[1][N / 8][4];
    wide::partial<T, D>(s[0], Qs, Kt, L::ld, c0, lane);
    wide::exchange<D, 1>(s, X, warp, lane);

    const int key0 = t * N + 2 * t4;
    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = key0 + 8 * j + e < sk;
        s[0][j][e] = valid ? s[0][j][e] * c : -INFINITY;
        s[0][j][2 + e] = valid ? s[0][j][2 + e] * c : -INFINITY;
        tm0 = fmaxf(tm0, s[0][j][e]);
        tm1 = fmaxf(tm1, s[0][j][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
      tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
    }
    // Finite: every tile holds at least one key below sk.
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    const float a0 = f32 ? ex2(m0 - mn0) : expf(m0 - mn0);
    const float a1 = f32 ? ex2(m1 - mn1) : expf(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[0][j][e] = f32 ? ex2(s[0][j][e] - mn0) : expf(s[0][j][e] - mn0);
        s[0][j][2 + e] = f32 ? ex2(s[0][j][2 + e] - mn1) : expf(s[0][j][2 + e] - mn1);
        ps0 += s[0][j][e];
        ps1 += s[0][j][2 + e];
      }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < wide::kCols / 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    wide::product<T, D>(acc, s[0], Vt + c0, lane);
    __syncthreads();  // this tile's buffers (and X) are free for the next writes
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + g, r1 = r0 + 8;
  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < wide::kCols / 8; ++n) {
    const int col = c0 + n * 8 + 2 * t4;
    if (r0 < sq) store2<T>(ob + (long long)r0 * os.s + col, acc[n][0] / l0, acc[n][1] / l0);
    if (r1 < sq) store2<T>(ob + (long long)r1 * os.s + col, acc[n][2] / l1, acc[n][3] / l1);
  }
  if (warp == 0 && t4 == 0) {
    float* lb = lse + ((long long)b * heads + h) * sq;
    if (r0 < sq) lb[r0] = f32 ? m0 * kLn2 + logf(l0) : m0 + logf(l0);
    if (r1 < sq) lb[r1] = f32 ? m1 * kLn2 + logf(l1) : m1 + logf(l1);
  }
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

// plan: {variant, rows, grid x, grid y, grid z, threads, smem}, from
// flash_plan; refused unless it is this variant's geometry and covers the
// shape.
struct Plan {
  int variant, rows, gx, gy, gz, threads, smem;
};

bool covers(const Plan& p, int b, int heads, int sq, int rows, int threads, size_t smem) {
  return p.rows == rows && p.gx == (sq + rows - 1) / rows && p.gy == heads && p.gz == b &&
         p.threads == threads && p.smem == (int)smem;
}

template <typename T, int D, int MT, typename K>
int launch_stream(K kernel, const Plan& p, const void* q, const void* k, const void* v, void* o,
                  float* lse, int b, int heads, int sq, int sk, const long long* st, float scale,
                  cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, D>::template bytes<MT>;
  if (!covers(p, b, heads, sq, 64 * MT, kThreads, bytes)) return XD_ERR_SHAPE;
  static bool done = false;
  const int rc = raise_smem(kernel, bytes, &done);
  if (rc) return rc;
  kernel<<<dim3(p.gx, p.gy, p.gz), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, heads, sq, sk,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_wide(const Plan& p, const void* q, const void* k, const void* v, void* o, float* lse,
                int b, int heads, int sq, int sk, const long long* st, float scale,
                cudaStream_t stream) {
  constexpr size_t bytes = wide::Layout<T, D>::fwd_bytes;
  constexpr int threads = wide::Cfg<D>::kThreads;
  if (!covers(p, b, heads, sq, wide::kRows, threads, bytes)) return XD_ERR_SHAPE;
  static bool done = false;
  const int rc = raise_smem(flash_fwd_wide<T, D>, bytes, &done);
  if (rc) return rc;
  flash_fwd_wide<T, D><<<dim3(p.gx, p.gy, p.gz), threads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, heads, sq, sk,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, scale);
  return (int)cudaGetLastError();
}

int launch_wgmma(const Plan& p, const void* q, const void* k, const void* v, void* o, float* lse,
                 int b, int heads, int sq, int sk, const long long* st, float scale,
                 cudaStream_t stream) {
  if (!covers(p, b, heads, sq, wg::kRows, wg::kThreads, wg::kSmem)) return XD_ERR_SHAPE;
  CUtensorMap qm, km, vm;
  int rc = hopper::bf16_rows_map(&qm, q, b, heads, sq, 64, st, wg::kRows);
  if (!rc) rc = hopper::bf16_rows_map(&km, k, b, heads, sk, 64, st + 3, wg::kKeys);
  if (!rc) rc = hopper::bf16_rows_map(&vm, v, b, heads, sk, 64, st + 6, wg::kKeys);
  if (rc) return rc;
  static bool done = false;
  rc = raise_smem(flash_fwd_wgmma, wg::kSmem, &done);
  if (rc) return rc;
  flash_fwd_wgmma<<<dim3(p.gx, p.gy, p.gz), wg::kThreads, wg::kSmem, stream>>>(
      qm, km, vm, (bf16*)o, lse, heads, sq, sk, Strides{st[9], st[10], st[11]}, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, H, Sq, d), k/v: (B, H, Sk, d), o: (B, H, Sq, d), each with unit stride
// on d and its batch / head / row strides (elements) in `strides` as
// {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s}; rows start on
// 16-byte boundaries (checked by the Python wrapper). lse: contiguous fp32
// (B, H, Sq). plan: flash_plan's 7 ints for this shape.
XD_EXPORT int xd_flash_attention(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int b, int heads, int sq, int sk, int d,
                                 const long long* strides, float scale, int dtype,
                                 const int* plan, void* stream) {
  if (b <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || b > 65535 || heads > 65535)
    return XD_ERR_SHAPE;
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (p.variant == kWide && d == 256) {
    if (dtype == XD_F32)
      return launch_wide<float, 256>(p, q, k, v, o, l, b, heads, sq, sk, strides, scale, st);
    if (dtype == XD_BF16)
      return launch_wide<bf16, 256>(p, q, k, v, o, l, b, heads, sq, sk, strides, scale, st);
  }
  if (p.variant == kWide && d == 576) {
    if (dtype == XD_F32)
      return launch_wide<float, 576>(p, q, k, v, o, l, b, heads, sq, sk, strides, scale, st);
    if (dtype == XD_BF16)
      return launch_wide<bf16, 576>(p, q, k, v, o, l, b, heads, sq, sk, strides, scale, st);
  }
  if (dtype == XD_F32 && p.variant == kTf32) {
    if (d == 64 && p.rows == 128)
      return launch_stream<float, 64, 2>(flash_fwd_tf32<64, 2>, p, q, k, v, o, l, b, heads, sq,
                                         sk, strides, scale, st);
    if (d == 64)
      return launch_stream<float, 64, 1>(flash_fwd_tf32<64, 1>, p, q, k, v, o, l, b, heads, sq,
                                         sk, strides, scale, st);
    if (d == 128)
      return launch_stream<float, 128, 1>(flash_fwd_tf32<128, 1>, p, q, k, v, o, l, b, heads, sq,
                                          sk, strides, scale, st);
    return XD_ERR_SHAPE;
  }
  if (dtype == XD_BF16 && p.variant == kWgmma && d == 64)
    return launch_wgmma(p, q, k, v, o, l, b, heads, sq, sk, strides, scale, st);
  if (dtype == XD_BF16 && p.variant == kMma && d == 128)
    return launch_stream<bf16, 128, 1>(flash_fwd_mma<128>, p, q, k, v, o, l, b, heads, sq, sk,
                                       strides, scale, st);
  return dtype == XD_F32 || dtype == XD_BF16 ? XD_ERR_SHAPE : XD_ERR_DTYPE;
}
