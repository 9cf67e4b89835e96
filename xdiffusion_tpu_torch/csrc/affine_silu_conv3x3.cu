// K4: out = conv3x3_same(silu(x * a + off), w) + bias [+ residual], NHWC.
//
// Replaces the Pallas kernel xdiffusion_tpu/ops/fused_resblock.py:62
// (`_kernel`, wrapper `affine_silu_conv3x3` :252, `pallas_call` :145). The
// per-(batch, channel) affine a/off carries the block's GroupNorm (and its
// folded timestep scale-shift), so the normalized activation is never
// written to device memory.
//
// Bound on the H100: operations. At the UNet's shapes (B*H*W = 65,536 or
// 16,384 rows, 9*C = 1,152..4,608, Co = 128 or 256) it does about 2*9*C*Co
// flops per output pixel against (C + Co) * 2 bytes, hundreds of flops per
// byte, above the card's ~295 bf16 flops per byte.
//
// Design: an implicit GEMM with M = B*H*W output pixels, N = Co and
// K = 9*C (tap-major, then input channel: the HWIO weight read as a
// (9*C, Co) row-major matrix), walked in steps of 32. While a block loads
// the A tile it applies the affine and SiLU per (batch, input channel) in
// fp32 and rounds once to the storage type; a tap that falls off the image
// loads 0, the zero padding of the activated map (fused_resblock.py:95-99),
// not silu(off). Bias and the optional residual are added in fp32 in the
// epilogue. Two paths:
// - the bf16 fast path below (`fast::`), taken by every conv of the
//   flagship UNet: 16-byte loads, tensor cores, double buffering;
// - the generic kernel for everything else (fp32, or channel counts that
//   are not multiples of 32): 64 x 64 tiles, one element per load, every
//   edge masked, so any C_in and C_out work. bf16 runs its product on the
//   tensor cores (wmma 16x16x16, fp32 accumulation); fp32 runs it on the
//   CUDA cores in full fp32, so that it matches the plain version without
//   TF32 rounding.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

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
// bf16 fast path (C % 32 == 0, Co % 8 == 0, 16-byte aligned rows): every
// 32-deep k tile then lies inside one tap, so a thread loads 8 channels of
// one pixel with one 16-byte load, applies the affine and SiLU (through one
// tanh.approx: sigmoid(v) = 0.5 + 0.5 tanh(v / 2), relative error ~2^-11,
// below bf16's 2^-8) and stores them with one 16-byte store. BM x BN output
// tiles (128 x 128, or 64 x 64 where the larger tiles would leave SMs idle:
// the 8x8 and 4x4 maps), warps of 32 x BN/2; the next tile's activations
// are loaded into registers and its weights copied with cp.async while the
// tensor cores work on the current one (two shared buffers).
namespace fast {

constexpr int BK = 32;
constexpr int LDA = BK + 8;   // As[m][k], bf16
constexpr int LDS = 16 + 4;   // per-warp epilogue staging, fp32
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ float silu_approx(float v) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * v));
  return v * fmaf(0.5f, t, 0.5f);
}

template <int BM, int BN>
__global__ void __launch_bounds__(BM * 2, 256 / BM)
    conv_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ off, const bf16* __restrict__ w,
                const float* __restrict__ bias, const bf16* __restrict__ res,
                bf16* __restrict__ out, int nb, int h, int wd, int c, int co,
                int apply_silu) {
  constexpr int kThreads = BM * 2;    // (BM / 32) x 2 warps
  constexpr int LDB = BN + 8;         // Bs[k][n], bf16
  constexpr int WN = BN / 2;          // warp tile: 32 x WN
  constexpr int FN = WN / 16;
  constexpr int kBVecs = BN / 8;      // 16-byte vectors per B row
  static_assert(BM == BN, "the loaders give each thread 2 A and 2 B vectors");
  __shared__ __align__(128) bf16 As[2][BM * LDA];
  __shared__ __align__(128) bf16 Bs[2][BK * LDB];
  __shared__ int row_b[BM], row_y[BM], row_x[BM];

  const int m_total = nb * h * wd;
  const int ktiles = 9 * c / BK;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;

  if (tid < BM) {
    const int m = m0 + tid;
    const int hw = h * wd;
    const int bb = m / hw, rem = m - (m / hw) * hw;
    row_b[tid] = m < m_total ? bb : -1;
    row_y[tid] = rem / wd;
    row_x[tid] = rem - (rem / wd) * wd;
  }
  __syncthreads();

  // A: 128 rows x 4 vectors of 8 channels, two per thread.
  uint4 araw[2];
  int abase[2];  // offset of the 8 channels in a/off, or -1 for a zero tap
  auto load_a = [&](int kt) {
    const int k0 = kt * BK;
    const int tap = k0 / c, ci0 = k0 - (k0 / c) * c;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + kThreads * j, r = e >> 2, cv = e & 3;
      const int bb = row_b[r], yy = row_y[r] + dy, xx = row_x[r] + dx;
      const bool valid = bb >= 0 && yy >= 0 && yy < h && xx >= 0 && xx < wd;
      const int ci = ci0 + cv * 8;
      araw[j] = valid ? *reinterpret_cast<const uint4*>(
                            x + (((long long)bb * h + yy) * wd + xx) * c + ci)
                      : make_uint4(0u, 0u, 0u, 0u);
      abase[j] = valid ? bb * c + ci : -1;
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + kThreads * j, r = e >> 2, cv = e & 3;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (abase[j] >= 0) {
        const float4* ap = reinterpret_cast<const float4*>(a + abase[j]);
        const float4* op = reinterpret_cast<const float4*>(off + abase[j]);
        const float4 a0 = ap[0], a1 = ap[1], o0 = op[0], o1 = op[1];
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float ov[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
        const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&araw[j]);
        __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(xv[q]);
          float v0 = fmaf(f.x, av[2 * q], ov[2 * q]);
          float v1 = fmaf(f.y, av[2 * q + 1], ov[2 * q + 1]);
          if (apply_silu) {
            v0 = silu_approx(v0);
            v1 = silu_approx(v1);
          }
          pv[q] = __floats2bfloat162_rn(v0, v1);
        }
      }
      *reinterpret_cast<uint4*>(&As[buf][r * LDA + cv * 8]) = packed;
    }
  };
  // B: 32 k rows x 16 vectors of 8 output channels, two per thread.
  auto load_b = [&](int kt, int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + kThreads * j, kr = e / kBVecs, nv = e % kBVecs;
      const int n = n0 + nv * 8;
      bf16* dst = &Bs[buf][kr * LDB + nv * 8];
      if (n < co)
        cp_async16(dst, w + (long long)(kt * BK + kr) * co + n);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][FN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_b(0, 0);
  load_a(0);
  store_a(0);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) {
      load_b(kt + 1, cur ^ 1);
      load_a(kt + 1);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[cur][(wm * 32 + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[cur][kk * LDB + wn * WN + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    if (more) {
      store_a(cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  // Epilogue: each warp stages one 16 x 16 accumulator at a time in the
  // (now unused) A buffers and writes 8 outputs per lane with 16-byte
  // stores, adding bias and residual in fp32.
  float* stage = reinterpret_cast<float*>(&As[0][0]) + warp * 16 * LDS;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], LDS, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * WN + j * 16 + c0;
      if (m < m_total && n < co) {
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = stage[r * LDS + c0 + q] + bias[n + q];
        const long long o = (long long)m * co + n;
        if (res != nullptr) {
          const uint4 rv = *reinterpret_cast<const uint4*>(res + o);
          const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&rv);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f = __bfloat1622float2(rp[q]);
            v[2 * q] += f.x;
            v[2 * q + 1] += f.y;
          }
        }
        uint4 packed;
        __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int q = 0; q < 4; ++q) pv[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
        *reinterpret_cast<uint4*>(out + o) = packed;
      }
      __syncwarp();
    }
  }
}

bool eligible(const void* x, const void* a, const void* off, const void* w,
              const void* res, const void* out, int c, int co) {
  const unsigned long long p = (unsigned long long)x | (unsigned long long)a |
                               (unsigned long long)off | (unsigned long long)w |
                               (unsigned long long)res | (unsigned long long)out;
  return c % BK == 0 && co % 8 == 0 && (p & 15ULL) == 0;
}

template <int BM, int BN>
int launch(const void* x, const void* a, const void* off, const void* w,
           const void* bias, const void* res, void* out, int b, int h, int wd,
           int c, int co, int apply_silu, cudaStream_t st) {
  const long long m = (long long)b * h * wd;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
  conv_kernel<BM, BN><<<grid, BM * 2, 0, st>>>(
      (const bf16*)x, (const float*)a, (const float*)off, (const bf16*)w,
      (const float*)bias, (const bf16*)res, (bf16*)out, b, h, wd, c, co, apply_silu);
  return (int)cudaGetLastError();
}

// 128 x 128 tiles where they give at least one block per SM, else 64 x 64.
int launch_best(const void* x, const void* a, const void* off, const void* w,
                const void* bias, const void* res, void* out, int b, int h, int wd,
                int c, int co, int apply_silu, cudaStream_t st) {
  const long long m = (long long)b * h * wd;
  const long long blocks = ((m + 127) / 128) * ((co + 127) / 128);
  if (blocks >= 132)
    return launch<128, 128>(x, a, off, w, bias, res, out, b, h, wd, c, co, apply_silu, st);
  return launch<64, 64>(x, a, off, w, bias, res, out, b, h, wd, c, co, apply_silu, st);
}

}  // namespace fast

template <typename T>
int launch(const void* x, const void* a, const void* off, const void* w,
           const void* bias, const void* res, void* out, int b, int h, int wd,
           int c, int co, int apply_silu, cudaStream_t st) {
  const long long m = (long long)b * h * wd;
  if (std::is_same<T, __nv_bfloat16>::value && fast::eligible(x, a, off, w, res, out, c, co))
    return fast::launch_best(x, a, off, w, bias, res, out, b, h, wd, c, co, apply_silu, st);
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
  affine_silu_conv3x3_kernel<T><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const float*)a, (const float*)off, (const T*)w,
      (const float*)bias, (const T*)res, (T*)out, b, h, wd, c, co, apply_silu);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C), w: (3, 3, C, Co) HWIO, res/out: (B, H, W, Co), all
// contiguous in `dtype`; a/off: (B, C) and bias: (Co,) contiguous fp32;
// res may be null.
XD_EXPORT int xd_affine_silu_conv3x3(const void* x, const void* a, const void* off,
                                     const void* w, const void* bias,
                                     const void* res, void* out, int b, int h,
                                     int wd, int c, int co, int apply_silu,
                                     int dtype, void* stream) {
  if (b <= 0 || h <= 0 || wd <= 0 || c <= 0 || co <= 0) return XD_ERR_SHAPE;
  if ((long long)b * h * wd >= (1LL << 31)) return XD_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == XD_F32)
    return launch<float>(x, a, off, w, bias, res, out, b, h, wd, c, co, apply_silu, st);
  if (dtype == XD_BF16)
    return launch<__nv_bfloat16>(x, a, off, w, bias, res, out, b, h, wd, c, co,
                                 apply_silu, st);
  return XD_ERR_DTYPE;
}
