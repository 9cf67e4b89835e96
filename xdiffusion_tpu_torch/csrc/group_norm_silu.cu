// K3: GroupNorm (+ SiLU) over the trailing channel axis of an NHWC map.
//
// Replaces the Pallas kernel xdiffusion_tpu/ops/group_norm.py:29
// (`_gn_silu_kernel`, wrapper `group_norm_silu` :116): per-(batch, group)
// mean and variance in fp32 (two passes, as the TPU kernel), then
// normalize, affine and optional SiLU in one pass, eps 1e-5.
//
// Bound on the H100: bytes. It reads x once and writes the output once
// (10 flops per element against 4-8 bytes), far below the card's
// operations-per-byte line. Design: one block per (batch, group). In NHWC a
// group's C/G channels are contiguous and strided by C across pixels, so
// the block walks its HW x C/G elements with neighbouring threads on
// neighbouring channels. The two statistic passes and the output pass re-read
// the group from global memory; a group is a few KB to a few hundred KB, so
// the re-reads are served by L2 and device memory sees about one read.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Sum over the block; every thread gets the total (fixed order: deterministic).
__device__ float block_sum(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // sh may still be read by a previous call
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float t = 0.0f;
  for (int i = 0; i < kThreads / 32; ++i) t += sh[i];
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_silu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out, int hw,
                   int c, int groups, float eps, int apply_silu) {
  __shared__ float sh[kThreads / 32];
  const int g = blockIdx.x;
  const long long base = (long long)blockIdx.y * hw * c + (long long)g * (c / groups);
  const int cg = c / groups;
  const int n = hw * cg;
  const T* xb = x + base;
  T* ob = out + base;

  float s = 0.0f;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int p = e / cg;
    s += to_f<T>(xb[(long long)p * c + (e - p * cg)]);
  }
  const float mean = block_sum(s, sh) / (float)n;

  float q = 0.0f;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int p = e / cg;
    const float d = to_f<T>(xb[(long long)p * c + (e - p * cg)]) - mean;
    q += d * d;
  }
  const float inv = rsqrtf(block_sum(q, sh) / (float)n + eps);

  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int p = e / cg;
    const int ch = e - p * cg;
    const long long off = (long long)p * c + ch;
    float v = (to_f<T>(xb[off]) - mean) * inv * scale[g * cg + ch] + bias[g * cg + ch];
    if (apply_silu) v = silu_f(v);
    ob[off] = from_f<T>(v);
  }
}

}  // namespace

// x, out: (B, HW, C) contiguous; scale, bias: (C,) fp32.
XD_EXPORT int xd_group_norm_silu(const void* x, const void* scale, const void* bias,
                                 void* out, int b, int hw, int c, int groups,
                                 float eps, int apply_silu, int dtype, void* stream) {
  if (groups <= 0 || c % groups != 0 || b <= 0 || hw <= 0) return XD_ERR_SHAPE;
  const dim3 grid(groups, b);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == XD_F32) {
    gn_silu_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)scale, (const float*)bias, (float*)out, hw,
        c, groups, eps, apply_silu);
  } else if (dtype == XD_BF16) {
    gn_silu_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias,
        (__nv_bfloat16*)out, hw, c, groups, eps, apply_silu);
  } else {
    return XD_ERR_DTYPE;
  }
  return (int)cudaGetLastError();
}
