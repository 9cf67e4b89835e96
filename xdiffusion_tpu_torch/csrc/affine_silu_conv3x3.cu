// K4: out = conv3x3_same(silu(x * a + off), w) + bias [+ residual], NHWC.
//
// Replaces the Pallas kernel xdiffusion_tpu/ops/fused_resblock.py:62
// (`_kernel`, wrapper `affine_silu_conv3x3` :252, `pallas_call` :145). The
// per-(batch, channel) affine a/off carries the block's GroupNorm (and its
// folded timestep scale-shift), so the normalized activation is never
// written to device memory.
//
// Bound on the H100: operations. At the UNet's shapes (B*H*W = 1,024 to
// 65,536 rows, 9*C = 1,152..4,608, Co = 128 or 256) it does about 2*9*C*Co
// flops per output pixel against (C + Co) * 2 bytes, hundreds of flops per
// byte, above the card's ~295 bf16 flops per byte; so the tensor cores'
// rate, and keeping them fed, set its time.
//
// Both paths run an implicit GEMM with M = B*H*W output pixels, N = Co and
// K = 9*C (tap-major, then input channel: the HWIO weight read as a (9*C, Co)
// row-major matrix). The affine and SiLU are applied per (batch, input
// channel) in fp32 and rounded once to the storage type; a tap that falls
// off the image reads 0, the zero padding of the activated map
// (fused_resblock.py:95-99), not silu(off). Bias and the optional residual
// are added in fp32 in the epilogue. `conv_plan` (ops/fused_resblock.py)
// picks the path and its geometry before the launch:
// - the staged path (`staged::`, below), bf16 with C % 32 == 0, Co % 8 == 0
//   and W <= 128, every conv of the shipped UNets: each block stages the
//   activated map of its tile once per 64-channel chunk, with its halo, in
//   shared memory (each element transformed once per block), and all nine
//   taps read it as shifted rows into wgmma (Hopper's warpgroup MMA), its
//   weights arriving by TMA up to six stages deep;
// - the generic kernel for everything else (fp32, or channel counts that
//   are not multiples of 32): 64 x 64 tiles, one element per load, every
//   edge masked, so any C_in and C_out work. bf16 runs its product on the
//   tensor cores (wmma 16x16x16, fp32 accumulation); fp32 runs it on the
//   CUDA cores in full fp32, so that it matches the plain version without
//   TF32 rounding.
#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int kThreads = 128;

// Row padding (elements) of the shared tiles: 16 bytes, which keeps wmma's
// ldm a multiple of 8 for bf16.
template <typename T>
struct Pad {
  static constexpr int value = 16 / (int)sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    affine_silu_conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ a,
                               const float* __restrict__ off,
                               const T* __restrict__ w, const float* __restrict__ bias,
                               const T* __restrict__ res, T* __restrict__ out,
                               int nb, int h, int wd, int c, int co, int apply_silu) {
  constexpr int lda = BM + Pad<T>::value;   // As is k-major: As[k][m]
  constexpr int ldb = BN + Pad<T>::value;   // Bs[k][n]
  constexpr int ldc = BN + 4;          // Cs[m][n], fp32
  __shared__ __align__(128) T As[BK * lda];
  __shared__ __align__(128) T Bs[BK * ldb];
  __shared__ __align__(128) float Cs[BM * ldc];
  __shared__ int row_b[BM], row_y[BM], row_x[BM];

  const int m_total = nb * h * wd;
  const int k_total = 9 * c;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  if (tid < BM) {
    const int m = m0 + tid;
    if (m < m_total) {
      const int hw = h * wd;
      const int bb = m / hw;
      const int rem = m - bb * hw;
      row_b[tid] = bb;
      row_y[tid] = rem / wd;
      row_x[tid] = rem - (rem / wd) * wd;
    } else {
      row_b[tid] = -1;
      row_y[tid] = 0;
      row_x[tid] = 0;
    }
  }

  // A loader: a thread keeps one k column (so one tap and one input
  // channel per k tile: neighbouring lanes read neighbouring channels) and
  // 16 of the 64 rows.
  const int a_k = tid % BK;
  const int a_m0 = tid / BK;  // rows a_m0 + 4*i
  // B loader: one n column, 16 of the 32 k rows.
  const int b_n = tid % BN;
  const int b_k0 = tid / BN;  // rows b_k0 + 2*i

  // fp32 compute mapping: 8 rows x 4 cols per thread.
  const int tm = tid / 16, tn = tid % 16;
  float acc[std::is_same<T, float>::value ? 32 : 1];
  // bf16 compute mapping: warp (wm, wn) owns a 32 x 32 quarter.
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[2][2];
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(cf[i][j], 0.0f);
  }

  for (int k0 = 0; k0 < k_total; k0 += BK) {
    __syncthreads();  // row info written; previous tiles consumed
    {
      const int k = k0 + a_k;
      const bool kvalid = k < k_total;
      const int tap = kvalid ? k / c : 0;
      const int ci = k - tap * c;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll 4
      for (int i = 0; i < BM / (kThreads / BK); ++i) {
        const int r = a_m0 + i * (kThreads / BK);
        const int bb = row_b[r];
        const int yy = row_y[r] + dy, xx = row_x[r] + dx;
        float v = 0.0f;
        if (kvalid && bb >= 0 && yy >= 0 && yy < h && xx >= 0 && xx < wd) {
          const long long pix = ((long long)bb * h + yy) * wd + xx;
          v = fmaf(to_f<T>(x[pix * c + ci]), a[bb * c + ci], off[bb * c + ci]);
          if (apply_silu) v = silu_f(v);
        }
        As[a_k * lda + r] = from_f<T>(v);
      }
    }
    {
      const int n = n0 + b_n;
#pragma unroll 4
      for (int i = 0; i < BK / (kThreads / BN); ++i) {
        const int kr = b_k0 + i * (kThreads / BN);
        const int k = k0 + kr;
        Bs[kr * ldb + b_n] =
            (k < k_total && n < co) ? w[(long long)k * co + n] : from_f<T>(0.0f);
      }
    }
    __syncthreads();

    if constexpr (std::is_same<T, float>::value) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[kk * lda + tm * 8 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * ldb + tn * 4 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(av[i], bv[j], acc[i * 4 + j]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], As + kk * lda + wm * 32 + i * 16, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bf[j], Bs + kk * ldb + wn * 32 + j * 16, ldb);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(cf[i][j], af[i], bf[j], cf[i][j]);
      }
    }
  }

  // Stage the 64 x 64 fp32 tile, then write it with bias and residual.
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(tm * 8 + i) * ldc + tn * 4 + j] = acc[i * 4 + j];
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * ldc + wn * 32 + j * 16,
                                cf[i][j], ldc, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, cc = e - (e / BN) * BN;
    const int m = m0 + r, n = n0 + cc;
    if (m < m_total && n < co) {
      float v = Cs[r * ldc + cc] + bias[n];
      const long long o = (long long)m * co + n;
      if (res != nullptr) v += to_f<T>(res[o]);
      out[o] = from_f<T>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 staged path: `conv_plan` in ops/fused_resblock.py picks it for C % 32
// == 0, Co % 8 == 0 and W <= 128, with 16-byte aligned pointers, and gives
// its geometry. An implicit GEMM (M = B*H*W output pixels, N = Co, K = 9*C)
// on Hopper's warpgroup MMA, in which each element of the activated map is
// computed once per block instead of once per tap and output tile.
//
// Tiles. A tile is BM = 128 GEMM rows made of whole image rows: `tr` rows of
// one image, or `ni` whole images (tr = H) where an image holds at most 64
// pixels; the last tile of an image or of the batch may hold fewer. Its N
// tile is BN output channels, its K range one split of the units (chunk j,
// tap t), chunk-major, a chunk being 64 input channels, cut at tap rows.
//
// A persistent block of three warpgroups walks tiles blockIdx.x, + gridDim.x.
// - Warpgroup 0 produces, on 80 registers (setmaxnreg). A thread of warp 0
//   keeps up to `stages` weight tiles (64 K rows by BN, one a unit) in
//   flight by TMA on full/empty mbarriers. Warps 1-3, the stagers, activate
//   each chunk once, in place. Its raw halo'd x tile (sr = tr + 2 rows of
//   each of the `ni` images, P = W + 2 columns, 64 channels; zeros outside
//   the tensor) arrives by TMA, issued by stager 0 up to two chunks ahead,
//   in one of three buffers: one 128-byte row per staged pixel, its 16-byte
//   chunks in TMA's 128-byte swizzle (XOR with the pixel's low three bits).
//   The stagers write silu(x * a + off) over it in fp32, rounded once to
//   bf16, and exact zeros outside the image (the zero padding of the
//   activated map, fused_resblock.py:95-99) and past C. The transform thus
//   runs on warps of its own beside the tensor cores; only a block's first
//   chunk, which nothing could overlap, the consumers help to activate.
// - Warpgroups 1 and 2 consume, 64 rows each, on 208 registers. The GEMM row
//   of output pixel (image i, row y, column x) of the tile reads, for tap
//   (dy, dx), staged pixel s = (i*sr + y + dy)*P + x + dx: all nine taps are
//   shifted views of the one staged tile. ldmatrix takes a row address from
//   each lane, so the halo's uneven strides cost nothing and no im2col copy
//   is made; it gives wgmma's A fragment in registers. B comes from the TMA
//   ring through a descriptor. A tap row (3 taps, 12 wgmma m64nBNk16 with
//   fp32 accumulators) is one group, waited for before the next one's A is
//   loaded (a register written while a group runs would serialize it).
// One split: acc + bias (+ residual, loaded by TMA into the output tile while
// the last chunk runs) in fp32, one rounding, in place in a swizzled shared
// tile that TMA stores while the next tile runs. Several splits: fp32
// partials to the workspace, summed in split order by `reduce_kernel`. No
// atomics anywhere, so the output repeats bit for bit.
namespace staged {

using bf16 = __nv_bfloat16;
constexpr int BM = 128, CK = 64;
constexpr int kThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kAlign = 1024;        // the 128-byte swizzle's atom
constexpr int kABufs = 3;           // staged activation buffers
constexpr int kSmemMax = 232448;

struct Params {
  const bf16* x;
  const float* a;
  const float* off;
  const float* bias;
  const bf16* res;
  bf16* out;
  float* part;
  int nb, h, w, c, co, apply_silu;
  int tr, ni, tpi, sr, pitch, npix, a_bytes;
  int n_tiles, splits, units, tiles, stages;
};

__device__ __forceinline__ float tanh_approx(float v) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(v));
  return t;
}

struct Tile {
  int b0, y0, n0, split, u_lo, u_hi;
};

template <int BN>
__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  Tile q;
  q.split = t % p.splits;
  const int rest = t / p.splits;
  const int nt = rest % p.n_tiles, mt = rest / p.n_tiles;
  q.n0 = nt * BN;
  q.b0 = (mt / p.tpi) * p.ni;
  q.y0 = (mt % p.tpi) * p.tr;
  // Splits cut at tap rows (3 units), so every wgmma group is one whole row.
  const int rows = p.units / 3;
  q.u_lo = 3 * (int)((long long)q.split * rows / p.splits);
  q.u_hi = 3 * (int)((long long)(q.split + 1) * rows / p.splits);
  return q;
}

// Output pixel of GEMM row r of tile q, or -1 for a row the tile leaves
// empty; `s` gets the row's staged pixel at tap (0, 0).
__device__ __forceinline__ long long out_pixel(const Params& p, const Tile& q, int r, int& s) {
  const int rows = p.tr * p.w;
  const int i = r / rows, rr = r - i * rows;
  const int y = rr / p.w, x = rr - (rr / p.w) * p.w;
  s = 0;
  if (i >= p.ni || q.b0 + i >= p.nb || q.y0 + y >= p.h) return -1;
  s = (i * p.sr + y) * p.pitch + x;
  return ((long long)(q.b0 + i) * p.h + q.y0 + y) * p.w + x;
}

// silu(x * a + off) of 8 bf16 channels in fp32, rounded once to bf16; 0
// where !ok. With kSilu, a and o hold a / 2 and off / 2: h = x * a / 2 +
// off / 2 is exactly (x * a + off) / 2, and silu(2h) = 2h sigmoid(2h) =
// h + h tanh(h), one tanh.approx (relative error ~2^-11, below bf16's 2^-8)
// and two fused multiply-adds an element. Without, x * a + off alone.
template <bool kSilu>
__device__ __forceinline__ uint4 activate8(uint4 raw, const float4 (&a)[2], const float4 (&o)[2],
                                           bool ok) {
  const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float am[8] = {a[0].x, a[0].y, a[0].z, a[0].w, a[1].x, a[1].y, a[1].z, a[1].w};
  const float om[8] = {o[0].x, o[0].y, o[0].z, o[0].w, o[1].x, o[1].y, o[1].z, o[1].w};
  uint4 packed;
  __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(xv[e]);
    float v0 = fmaf(f.x, am[2 * e], om[2 * e]);
    float v1 = fmaf(f.y, am[2 * e + 1], om[2 * e + 1]);
    if (kSilu) {
      v0 = fmaf(v0, tanh_approx(v0), v0);
      v1 = fmaf(v1, tanh_approx(v1), v1);
    }
    pv[e] = __floats2bfloat162_rn(v0, v1);
  }
  return ok ? packed : make_uint4(0u, 0u, 0u, 0u);
}

// A block's walk over its (tile, chunk) sequence: tiles blockIdx.x,
// + gridDim.x, ..., in each the chunks its split's units touch.
struct Cursor {
  int t, j, j_end;
  Tile q;
};
template <int BN>
__device__ __forceinline__ void cursor_at(const Params& p, Cursor& c, int t) {
  c.t = t;
  if (t < p.tiles) {
    c.q = tile_at<BN>(p, t);
    c.j = c.q.u_lo / 9;
    c.j_end = (c.q.u_hi - 1) / 9;
  }
}
template <int BN>
__device__ __forceinline__ void cursor_next(const Params& p, Cursor& c) {
  if (++c.j > c.j_end) cursor_at<BN>(p, c, c.t + gridDim.x);
}

// The stagers' (producer warps 1-3) activation of a staged chunk, in place.
// TMA has written the raw halo'd x tile in the staged layout (a 128-byte row
// of 64 channels per staged pixel, its 16-byte chunks swizzled by the
// pixel's low three bits, zeros outside the tensor). Stager k takes channel
// group k % 8 of staged pixels k / 8 + 12m, m = 0, 1, ... (a pass each), and
// writes silu(x * a + off), or an exact 0 where the pixel lies outside its
// image or past C. `start` finds which passes' pixels are inside (a bit
// each), so a pass is a load, the arithmetic and a store. The block's first
// chunk, which nothing can overlap, the consumers activate with them: then
// thread k of n takes pixels k / 8 + (n / 8) m.
constexpr int kStagers = 96, kStep = kStagers / 8;
constexpr int kFirstThreads = kStagers + 256;  // stagers and consumers

struct Activator {
  uint64_t inside;  // bit m: pass m's pixel lies inside its image
  int g, ch, s0, step, img_px;
  float4 ra[2], ro[2];  // the tile's coefficients (one image a tile)

  __device__ __forceinline__ void start(const Params& p, const Tile& q, int j, int k,
                                        int n = kStagers) {
    g = k & 7;
    ch = j * CK + g * 8;
    s0 = k >> 3;
    step = n / 8;
    img_px = p.sr * p.pitch;
    int xx = s0 % p.pitch, yr = (s0 / p.pitch) % p.sr, i = s0 / img_px;
    inside = 0;
    for (int m = 0, s = s0; s < p.npix; ++m, s += step) {
      const int yy = q.y0 - 1 + yr;
      if (q.b0 + i < p.nb && yy >= 0 && yy < p.h && xx >= 1 && xx <= p.w) inside |= 1ull << m;
      xx += step;
      while (xx >= p.pitch) {
        xx -= p.pitch;
        if (++yr == p.sr) {
          yr = 0;
          ++i;
        }
      }
    }
    if (ch >= p.c) inside = 0;  // a half chunk's upper channels
    coefficients(p, min(q.b0, p.nb - 1), ra, ro);
  }

  // Image b's a and off for this thread's 8 channels, halved for SiLU.
  __device__ __forceinline__ void coefficients(const Params& p, int b, float4 (&a)[2],
                                               float4 (&o)[2]) const {
    const long long cb = (long long)b * p.c + min(ch, p.c - 8);
    const float k = p.apply_silu ? 0.5f : 1.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 av = __ldg(reinterpret_cast<const float4*>(p.a + cb) + h);
      const float4 ov = __ldg(reinterpret_cast<const float4*>(p.off + cb) + h);
      a[h] = make_float4(k * av.x, k * av.y, k * av.z, k * av.w);
      o[h] = make_float4(k * ov.x, k * ov.y, k * ov.z, k * ov.w);
    }
  }

  // Every pass of tile q's chunk at `tile`.
  template <bool kSilu>
  __device__ __forceinline__ void run(const Params& p, const Tile& q, unsigned char* tile) {
    int m = 0;
#pragma unroll 2
    for (int s = s0; s < p.npix; s += step, ++m) {
      uint4* slot = reinterpret_cast<uint4*>(tile + s * 128 + ((g ^ (s & 7)) << 4));
      const uint4 raw = *slot;
      float4 av[2] = {ra[0], ra[1]}, ov[2] = {ro[0], ro[1]};
      if (p.ni > 1)  // several images a tile: this pixel's image
        coefficients(p, min(q.b0 + s / img_px, p.nb - 1), av, ov);
      *slot = activate8<kSilu>(raw, av, ov, (inside >> m) & 1ull);
    }
  }

  __device__ __forceinline__ void run(const Params& p, const Tile& q, unsigned char* tile) {
    if (p.apply_silu) run<true>(p, q, tile);
    else run<false>(p, q, tile);
  }
};

// Named barrier of the two consumer warpgroups.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// Named barrier of the stagers and the consumers, after the first chunk.
__device__ __forceinline__ void first_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kFirstThreads) : "memory");
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap omap,
                const __grid_constant__ CUtensorMap rmap) {
  using namespace hopper;
  constexpr int kStageBytes = CK * BN * 2;
  extern __shared__ unsigned char smem_raw[];
  // Aligned by an offset from smem_raw, so that every pointer below stays
  // one the compiler knows to be shared (LDS/STS, not generic accesses).
  unsigned char* bsm = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  unsigned char* asm_tiles = bsm + p.stages * kStageBytes;
  // The output tile: BN / 64 boxes of TILE_M rows by 64 bf16 columns, in
  // TMA's 128-byte swizzle; the residual lands there too. Then the tile's bias.
  unsigned char* otile = asm_tiles + kABufs * p.a_bytes;
  float* obias = reinterpret_cast<float*>(otile + BM * BN * 2);
  uint64_t* b_full = reinterpret_cast<uint64_t*>(obias + BN);
  uint64_t* b_empty = b_full + p.stages;
  uint64_t* x_full = b_empty + p.stages;
  uint64_t* a_full = x_full + kABufs;
  uint64_t* a_empty = a_full + kABufs;
  uint64_t* r_full = a_empty + kABufs;

  const int tid = threadIdx.x, lane = tid & 31;
  // Warp-uniform roles, as the compiler can see: a wgmma on a path it
  // thinks divergent is serialized.
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&b_full[i], 1);
      mbar_init(&b_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kABufs; ++i) {
      mbar_init(&x_full[i], 1);
      mbar_init(&a_full[i], kStagers / 32);
      mbar_init(&a_empty[i], kConsumerWarps);
    }
    mbar_init(r_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // The producer warpgroup needs few registers: the consumers take them.
    setmaxnreg_dec<80>();
  if (warp == 0) {
    // ---- weights: one TMA thread, `stages` units ahead ----------------------
    // (Counters, not divisions, in the per-unit loops: a runtime division is
    // a long dependent chain.)
    if (lane == 0) {
      tma_prefetch_map(&wmap);
      int st = 0, phase = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile q = tile_at<BN>(p, t);
        int j = q.u_lo / 9, tap = q.u_lo - 9 * j;
        for (int u = q.u_lo; u < q.u_hi; ++u) {
          mbar_wait(&b_empty[st], phase ^ 1);
          mbar_expect_tx(&b_full[st], kStageBytes);
          unsigned char* dst = bsm + st * kStageBytes;
#pragma unroll
          for (int qn = 0; qn < BN / 64; ++qn)
            tma_load_2d(dst + qn * CK * 128, &wmap, &b_full[st], q.n0 + 64 * qn,
                        tap * p.c + j * CK);
          if (++tap == 9) {
            tap = 0;
            ++j;
          }
          if (++st == p.stages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- warps 1-3, the stagers: activate each chunk once ----------------------
    // Chunk by chunk in the block's sequence, each after its raw tile's TMA
    // load completes, in the buffer the consumers read it from (kABufs ring).
    // Stager 0 issues those loads, kABufs - 1 chunks ahead: chunk j of tile q
    // is rows y0 - 1 .. y0 + tr of images b0 .. b0 + ni - 1, columns -1 .. W,
    // channels 64j .. 64j + 63 (zeros outside the tensor); a buffer is
    // reloaded once the consumers have read it.
    const int st = tid - 32;
    const uint32_t tile_bytes = (uint32_t)p.npix * 128;
    Cursor c, ld;
    Activator act;
    cursor_at<BN>(p, c, blockIdx.x);
    cursor_at<BN>(p, ld, blockIdx.x);
    int ld_it = 0;
    auto load_next = [&]() {
      if (ld.t >= p.tiles) return;
      const int buf = ld_it % kABufs;
      mbar_wait(&a_empty[buf], ((ld_it / kABufs) & 1) ^ 1);
      mbar_expect_tx(&x_full[buf], tile_bytes);
      tma_load_4d(asm_tiles + buf * p.a_bytes, &xmap, &x_full[buf], ld.j * CK, -1, ld.q.y0 - 1,
                  ld.q.b0);
      ++ld_it;
      cursor_next<BN>(p, ld);
    };
    if (st == 0) {
      tma_prefetch_map(&xmap);
      for (int k = 0; k < kABufs - 1; ++k) load_next();
    }
    for (int it = 0; c.t < p.tiles; ++it, cursor_next<BN>(p, c)) {
      const int buf = it % kABufs;
      mbar_wait(&x_full[buf], (it / kABufs) & 1);
      act.start(p, c.q, c.j, st, it == 0 ? kFirstThreads : kStagers);
      act.run(p, c.q, asm_tiles + buf * p.a_bytes);
      fence_proxy_async();  // these writes before a later TMA write to the buffer
      if (it == 0) first_sync();
      __syncwarp();
      if (lane == 0) mbar_arrive(&a_full[buf]);
      // After this chunk's arrival: the load may wait for the consumers.
      if (st == 0) load_next();
    }
  }
  } else {
    setmaxnreg_inc<208>();
    // ---- consumers: two warpgroups of 64 rows ---------------------------------
    const int cw = warp - 4, ct = tid - 128;  // consumer warp, consumer thread
    const int rbase = (cw >> 2) * 64 + (cw & 3) * 16;  // this warp's 16 rows
    const int r_ld = rbase + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int khalf = lane >> 4;
    const uint32_t a_smem = smem_u32(asm_tiles), b_smem = smem_u32(bsm);
    const long long m_total = (long long)p.nb * p.h * p.w;
    const int rows_box = p.ni * p.tr * p.w;        // GEMM rows an output box holds
    const uint32_t box_bytes = (uint32_t)rows_box * 128;
    int r_phase = 0;
    float acc[BN / 2];
    int a_it = 0;

    if (blockIdx.x < p.tiles) {  // the block's first chunk, with the stagers
      const Tile q0 = tile_at<BN>(p, blockIdx.x);
      Activator act;
      mbar_wait(&x_full[0], 0);
      act.start(p, q0, q0.u_lo / 9, kStagers + ct, kFirstThreads);
      act.run(p, q0, asm_tiles);
      first_sync();
    }

    int bst = 0, bphase = 0;  // the weight ring's stage and phase
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const Tile q = tile_at<BN>(p, t);
      int sb;
      out_pixel(p, q, r_ld, sb);
      // The tile's bias, for the epilogue (its first barrier orders it).
      if (ct < BN / 4) {
        const int n = q.n0 + 4 * ct;
        *reinterpret_cast<float4*>(obias + 4 * ct) =
            n < p.co ? __ldg(reinterpret_cast<const float4*>(p.bias + n))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const bool stored = p.splits == 1;  // the tile leaves through a TMA store
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int u = q.u_lo; u < q.u_hi;) {
        // One chunk: its tap rows in this tile's split, n_rows of them.
        const int j = u / 9;
        const int n_rows = (min(q.u_hi, 9 * j + 9) - u) / 3;
        const int buf = a_it % kABufs;
        const uint32_t abuf = a_smem + buf * p.a_bytes;
        mbar_wait(&a_full[buf], (a_it / kABufs) & 1);
        for (int kr = 0, dy = (u - 9 * j) / 3; kr < n_rows; ++kr, ++dy) {
          // A: the row's three shifted taps, each the chunk's 4 k16 steps
          // (past C, in a half chunk, A is staged as 0 and adds exact zeros).
          uint32_t fr[3][4][4];
          uint64_t dsc[3][4];
          int st[3];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int s = sb + dy * p.pitch + dx;
            const uint32_t row = abuf + s * 128;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              ldmatrix_x4(fr[dx][kk], row + (((2 * kk + khalf) ^ (s & 7)) << 4));
          }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            st[dx] = bst;
            mbar_wait(&b_full[bst], bphase);
            // Every input of the group is computed before it starts: a
            // register defined between wgmmas of one group serializes them.
            const uint32_t bsa = b_smem + bst * kStageBytes;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              dsc[dx][kk] = desc_sw128(bsa + kk * 2048, CK * 128, 1024);
              asm volatile("" : "+l"(dsc[dx][kk]));
            }
            if (++bst == p.stages) {
              bst = 0;
              bphase ^= 1;
            }
          }
          int one = 1;
          asm volatile("" : "+r"(one));
          wgmma_fence();
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) wgmma_rs<BN>(acc, fr[dx][kk], dsc[dx][kk], one);
          wgmma_commit();
          if (stored && ct == 0 && kr == 0 && u + 3 * n_rows == q.u_hi) {
            // The tile's last chunk: the output tile's previous TMA store has
            // read it before anyone writes it (the epilogue's first barrier);
            // the residual goes into it by TMA meanwhile.
            bulk_wait_read<0>();
            if (p.res != nullptr) {
              mbar_expect_tx(r_full, (uint32_t)(BN / 64) * box_bytes);
#pragma unroll
              for (int qn = 0; qn < BN / 64; ++qn)
                tma_load_4d(otile + qn * BM * 128, &rmap, r_full, q.n0 + 64 * qn, 0, q.y0, q.b0);
            }
          }
          wgmma_wait<0>();
          if (lane == 0) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) mbar_arrive(&b_empty[st[dx]]);
          }
        }
        u += 3 * n_rows;
        // The chunk is read: its buffer goes back to stager 0 (after a proxy
        // fence: generic reads before a later TMA write). No barrier of the
        // two warpgroups: each may run a group ahead of the other.
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&a_empty[buf]);
        ++a_it;
      }
      fence_operands(acc);

      if (!stored) {
        // fp32 partials straight from the fragments: (row, 2 columns) a store.
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          int s_unused;
          const long long m = out_pixel(p, q, rbase + (lane >> 2) + 8 * half, s_unused);
          if (m < 0) continue;
          float* dst = p.part + ((long long)q.split * m_total + m) * p.co;
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            const int n = q.n0 + 8 * i + 2 * (lane & 3);
            if (n < p.co)
              *reinterpret_cast<float2*>(dst + n) =
                  make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
          }
        }
        continue;
      }
      // One split: acc + bias (+ residual) in fp32, rounded once, written in
      // place into the output tile, which one TMA store per 64 columns
      // sends out (rows past the image or the batch fall outside the
      // tensor and are not written); the next tile runs meanwhile.
      consumers_sync();
      if (p.res != nullptr) {
        mbar_wait(r_full, r_phase);
        r_phase ^= 1;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rbase + (lane >> 2) + 8 * half;
        if (r >= rows_box) continue;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int c = 8 * i + 2 * (lane & 3), cc = c & 63;
          uint32_t* slot = reinterpret_cast<uint32_t*>(
              otile + (c >> 6) * BM * 128 + r * 128 + ((((cc >> 3) ^ (r & 7))) << 4) + (cc & 7) * 2);
          float v0 = acc[4 * i + 2 * half] + obias[c];
          float v1 = acc[4 * i + 2 * half + 1] + obias[c + 1];
          if (p.res != nullptr) {
            const uint32_t rv = *slot;
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv));
            v0 += f.x;
            v1 += f.y;
          }
          const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
          *slot = *reinterpret_cast<const uint32_t*>(&o);
        }
      }
      fence_proxy_async();  // the tile's generic writes before TMA reads it
      consumers_sync();
      if (ct == 0) {
#pragma unroll
        for (int qn = 0; qn < BN / 64; ++qn)
          tma_store_4d(&omap, otile + qn * BM * 128, q.n0 + 64 * qn, 0, q.y0, q.b0);
        bulk_commit();
      }
    }
    if (ct == 0) bulk_wait<0>();  // the last stores have read shared memory
  }
}

// Sums the splits' fp32 partials in split order, then adds bias and
// residual in fp32 and rounds once: 8 outputs a thread.
__global__ void reduce_kernel(const float* __restrict__ part, int splits, long long mco, int co,
                              const float* __restrict__ bias, const bf16* __restrict__ res,
                              bf16* __restrict__ out) {
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (e >= mco) return;
  const int n = (int)(e % co);
  float4 lo = __ldg(reinterpret_cast<const float4*>(part + e));
  float4 hi = __ldg(reinterpret_cast<const float4*>(part + e + 4));
  float o[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  for (int s = 1; s < splits; ++s) {
    lo = __ldg(reinterpret_cast<const float4*>(part + s * mco + e));
    hi = __ldg(reinterpret_cast<const float4*>(part + s * mco + e + 4));
    o[0] += lo.x; o[1] += lo.y; o[2] += lo.z; o[3] += lo.w;
    o[4] += hi.x; o[5] += hi.y; o[6] += hi.z; o[7] += hi.w;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] += bias[n + k];
  if (res != nullptr) {
    const uint4 rv = __ldg(reinterpret_cast<const uint4*>(res + e));
    const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&rv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(rp[k]);
      o[2 * k] += f.x;
      o[2 * k + 1] += f.y;
    }
  }
  uint4 packed;
  __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int k = 0; k < 4; ++k) pv[k] = __floats2bfloat162_rn(o[2 * k], o[2 * k + 1]);
  *reinterpret_cast<uint4*>(out + e) = packed;
}

// Shared memory of a block: alignment slack, the weight ring, two staged
// activation buffers, the epilogue tiles and the mbarriers (as conv_plan).
int smem_bytes(int bn, int stages, int a_bytes) {
  return kAlign + stages * CK * bn * 2 + kABufs * a_bytes + BM * bn * 2 + bn * 4 +
         (2 * stages + 3 * kABufs + 1) * 8;
}

bool eligible(const void* x, const void* a, const void* off, const void* w, const void* bias,
              const void* res, const void* out, int wd, int c, int co) {
  const unsigned long long ptr = (unsigned long long)x | (unsigned long long)a |
                                 (unsigned long long)off | (unsigned long long)w |
                                 (unsigned long long)bias | (unsigned long long)res |
                                 (unsigned long long)out;
  return c % 32 == 0 && co % 8 == 0 && wd <= BM && (ptr & 15ULL) == 0;
}

template <int BN>
int launch_bn(Params& prm, int grid, int smem, const void* w, cudaStream_t st) {
  hopper::EncodeTiledFn encode = hopper::encode_tiled_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // The weight as its (9*C, Co) row-major matrix; 64 x 64 boxes, 128-byte
  // swizzle (the layout wgmma's descriptor names); rows and columns past
  // the matrix arrive as zeros.
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)prm.co, (cuuint64_t)(9 * prm.c)};
  const cuuint64_t strides[1] = {(cuuint64_t)prm.co * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)CK}, elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return XD_ERR_SHAPE;
  // x as (C, W, H, B); one box is a chunk's halo'd tile: 64 channels, W + 2
  // columns, tr + 2 rows, ni images, each pixel's 128 bytes one swizzled row.
  CUtensorMap xmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)prm.c, (cuuint64_t)prm.w, (cuuint64_t)prm.h,
                               (cuuint64_t)prm.nb};
  const cuuint64_t xstrides[3] = {(cuuint64_t)prm.c * 2, (cuuint64_t)prm.w * prm.c * 2,
                                  (cuuint64_t)prm.h * prm.w * prm.c * 2};
  const cuuint32_t xbox[4] = {(cuuint32_t)CK, (cuuint32_t)prm.pitch, (cuuint32_t)prm.sr,
                              (cuuint32_t)prm.ni},
                   xelem[4] = {1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(prm.x), xdims, xstrides,
             xbox, xelem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return XD_ERR_SHAPE;
  // out and res as (Co, W, H, B); one box: 64 columns of a tile's rows (tr
  // rows of W pixels of ni images), in the 128-byte swizzle.
  CUtensorMap omap, rmap;
  const cuuint64_t odims[4] = {(cuuint64_t)prm.co, (cuuint64_t)prm.w, (cuuint64_t)prm.h,
                               (cuuint64_t)prm.nb};
  const cuuint64_t ostrides[3] = {(cuuint64_t)prm.co * 2, (cuuint64_t)prm.w * prm.co * 2,
                                  (cuuint64_t)prm.h * prm.w * prm.co * 2};
  const cuuint32_t obox[4] = {64, (cuuint32_t)prm.w, (cuuint32_t)prm.tr, (cuuint32_t)prm.ni};
  if (encode(&omap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, prm.out, odims, ostrides, obox, xelem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return XD_ERR_SHAPE;
  rmap = omap;
  if (prm.res != nullptr &&
      encode(&rmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(prm.res), odims,
             ostrides, obox, xelem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return XD_ERR_SHAPE;
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  conv_kernel<BN><<<grid, kThreads, smem, st>>>(prm, map, xmap, omap, rmap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || prm.splits == 1) return (int)e;
  const long long mco = (long long)prm.nb * prm.h * prm.w * prm.co;
  const long long threads = mco / 8;
  reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      prm.part, prm.splits, mco, prm.co, prm.bias, prm.res, prm.out);
  return (int)cudaGetLastError();
}

// plan: {variant, tr, ni, bn, splits, stages, grid, smem} from conv_plan.
int launch(const void* x, const void* a, const void* off, const void* w, const void* bias,
           const void* res, void* out, void* part, int b, int h, int wd, int c, int co,
           int apply_silu, const int* plan, cudaStream_t st) {
  const int tr = plan[1], ni = plan[2], bn = plan[3], splits = plan[4], stages = plan[5];
  const int grid = plan[6], smem = plan[7];
  if (!eligible(x, a, off, w, bias, res, out, wd, c, co)) return XD_ERR_SHAPE;
  if (tr < 1 || tr > h || ni < 1 || ni * tr * wd > BM || (ni > 1 && tr != h) || ni > b ||
      tr + 2 > 256)
    return XD_ERR_SHAPE;
  Params prm;
  prm.x = (const bf16*)x;
  prm.a = (const float*)a;
  prm.off = (const float*)off;
  prm.bias = (const float*)bias;
  prm.res = (const bf16*)res;
  prm.out = (bf16*)out;
  prm.part = (float*)part;
  prm.nb = b;
  prm.h = h;
  prm.w = wd;
  prm.c = c;
  prm.co = co;
  prm.apply_silu = apply_silu;
  prm.tr = tr;
  prm.ni = ni;
  prm.tpi = (h + tr - 1) / tr;
  prm.sr = tr + 2;
  prm.pitch = wd + 2;
  prm.npix = ni * prm.sr * prm.pitch;
  prm.a_bytes = (prm.npix * 128 + kAlign - 1) / kAlign * kAlign;
  prm.n_tiles = (co + bn - 1) / bn;
  prm.splits = splits;
  prm.units = (c + CK - 1) / CK * 9;
  prm.stages = stages;
  const long long tiles = (long long)(b + ni - 1) / ni * prm.tpi * prm.n_tiles * splits;
  prm.tiles = (int)tiles;
  if (splits < 1 || splits > prm.units / 3 || (splits > 1 && part == nullptr)) return XD_ERR_SHAPE;
  if (prm.npix > 64 * kStep) return XD_ERR_SHAPE;  // a stager's passes fit one mask
  // A tap row's group holds three weight stages at once.
  if (stages < 4 || stages > 8 || grid < 1 || grid > tiles || tiles >= (1LL << 31))
    return XD_ERR_SHAPE;
  if (smem != smem_bytes(bn, stages, prm.a_bytes) || smem > kSmemMax) return XD_ERR_SHAPE;
  if (bn == 64) return launch_bn<64>(prm, grid, smem, w, st);
  if (bn == 128) return launch_bn<128>(prm, grid, smem, w, st);
  return XD_ERR_SHAPE;
}

}  // namespace staged

template <typename T>
int launch_generic(const void* x, const void* a, const void* off, const void* w,
                   const void* bias, const void* res, void* out, int b, int h, int wd,
                   int c, int co, int apply_silu, cudaStream_t st) {
  const long long m = (long long)b * h * wd;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
  affine_silu_conv3x3_kernel<T><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const float*)a, (const float*)off, (const T*)w,
      (const float*)bias, (const T*)res, (T*)out, b, h, wd, c, co, apply_silu);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C), w: (3, 3, C, Co) HWIO, res/out: (B, H, W, Co), all
// contiguous in `dtype`; a/off: (B, C) and bias: (Co,) contiguous fp32;
// res may be null. plan: conv_plan's {variant (0 generic, 1 staged), tile
// rows, images, BN, splits, stages, grid, shared bytes}; part: the staged
// path's fp32 workspace of splits x B*H*W x Co, null for one split.
XD_EXPORT int xd_affine_silu_conv3x3(const void* x, const void* a, const void* off,
                                     const void* w, const void* bias,
                                     const void* res, void* out, void* part, int b, int h,
                                     int wd, int c, int co, int apply_silu,
                                     int dtype, const int* plan, void* stream) {
  if (b <= 0 || h <= 0 || wd <= 0 || c <= 0 || co <= 0) return XD_ERR_SHAPE;
  if ((long long)b * h * wd >= (1LL << 31)) return XD_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  if (plan[0] == 1) {
    if (dtype != XD_BF16) return XD_ERR_DTYPE;
    return staged::launch(x, a, off, w, bias, res, out, part, b, h, wd, c, co, apply_silu, plan,
                          st);
  }
  if (plan[0] != 0) return XD_ERR_SHAPE;
  if (dtype == XD_F32)
    return launch_generic<float>(x, a, off, w, bias, res, out, b, h, wd, c, co, apply_silu, st);
  if (dtype == XD_BF16)
    return launch_generic<__nv_bfloat16>(x, a, off, w, bias, res, out, b, h, wd, c, co,
                                         apply_silu, st);
  return XD_ERR_DTYPE;
}
