// K3: GroupNorm (+ SiLU) over the trailing channel axis of an NHWC map.
//
// Replaces the Pallas kernel xdiffusion_tpu/ops/group_norm.py:29
// (`_gn_silu_kernel`, wrapper `group_norm_silu` :116): per-(batch, group)
// mean and variance in fp32 (two passes, as the TPU kernel: the mean, then
// the centered squares), then normalize, affine and optional SiLU, eps 1e-5,
// the result rounded once to the storage type.
//
// Bound on the H100: bytes. It reads x once and writes the output once (10
// flops per element against 4-8 bytes). The TPU kernel holds a batch
// element's whole (HW, C) slab in VMEM and reads it once; an SM's shared
// memory is too small for the flagship's slabs (128-512 KB), so here a
// thread-block cluster holds it: the grid is (k, B), a cluster of k blocks
// per batch element, block `rank` taking the pixel rows
// [rank * HW / k, (rank + 1) * HW / k), one contiguous byte range of the
// NHWC slab. `gn_plan` (ops/group_norm.py) picks k, the threads, the vector
// width and the variant:
// - staged: the block's rows arrive in shared memory by 1-D bulk copies in
//   `pieces` pieces, each on its own mbarrier, so that summing one piece
//   overlaps the loads of the next; every later pass reads shared memory.
//   One read of HBM, one write.
// - stream: the same kernel where the share does not fit (or the vector
//   does not divide C, with scalar loads): each pass re-reads its rows from
//   global memory.
// Each thread owns fixed channel vectors (16 bytes: 8 bf16 or 4 fp32) and
// walks pixel rows, so a warp reads whole contiguous rows (coalesced, free
// of bank conflicts) and no element costs a division. Statistics: sums per
// channel in registers, per row lane and channel in shared memory, per group
// in a fixed order; then a cluster barrier, and every block sums the k
// blocks' group partials over distributed shared memory in rank order, so
// all blocks of a batch element hold the same bits of the mean (and of the
// variance after the centered pass, exchanged the same way). No atomics:
// the result is identical from run to run.
#include "common.cuh"
#include "hopper.cuh"

namespace {

enum { STAGED = 0, STREAM = 1 };  // ops/group_norm.py VARIANTS
constexpr int kMaxThreads = 512;
constexpr int kMaxPieces = 8;
constexpr int kSmemLimit = 232448;

// A block's dynamic shared memory in bytes, as ops/group_norm.py `gn_smem`:
// the staged rows (ceil(HW / k) of C), the row lanes' channel partials,
// scale and bias, four per-group arrays (sum and centered-square partials,
// mean, inverse deviation), then the pieces' mbarriers, 8-byte aligned.
long long gn_smem(int variant, int hw, int c, int groups, int esize, int k, int threads, int vec,
                  int pieces) {
  const int nv = c / vec;
  const int cols = nv < threads ? nv : threads;
  long long bytes = variant == STAGED ? (long long)((hw + k - 1) / k) * c * esize : 0;
  bytes += ((long long)(threads / cols) + 2) * c * 4 + 16LL * groups;
  return (bytes + 7) / 8 * 8 + 8LL * pieces;
}

// VEC channels of T: one 16-byte access (or one element).
template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  }
};
template <typename T>
struct Vec<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&v)[1]) { v[0] = to_f<T>(*p); }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) { *p = from_f<T>(v[0]); }
};

// part (lanes, C): each row lane's per-channel partials. Sums them per
// channel (lane order) into part's first row, then per group (channel
// order) into out. The loops are unrolled so that their loads issue
// together: the sums sit on the kernel's chain of latencies.
__device__ void group_partials(float* part, float* out, int lanes, int c, int groups) {
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float t = part[ch];
#pragma unroll 8
    for (int l = 1; l < lanes; ++l) t += part[(size_t)l * c + ch];
    part[ch] = t;
  }
  __syncthreads();
  const int cg = c / groups;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float t = 0.0f;
#pragma unroll 8
    for (int i = 0; i < cg; ++i) t += part[g * cg + i];
    out[g] = t;
  }
}

// The cluster's sum of a per-group array, over its k (<= 8) blocks in rank
// order; the k remote loads are all issued before the first add.
__device__ __forceinline__ float cluster_sum(const float* a, int k) {
  float v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = q < k ? hopper::ld_cluster(a, q) : 0.0f;
  float t = v[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) t += q < k ? v[q] : 0.0f;
  return t;
}

template <typename T, int VEC, bool STAGE>
__global__ void __launch_bounds__(kMaxThreads)
    gn_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ out, int hw, int c, int groups,
              float eps, int apply_silu, int pieces) {
  const int k = (int)hopper::cluster_blocks();
  const int rank = (int)hopper::cluster_rank();
  const int lo = (int)((long long)rank * hw / k);
  const int rows = (int)((long long)(rank + 1) * hw / k) - lo;
  const int nv = c / VEC, threads = (int)blockDim.x;
  const int cols = nv < threads ? nv : threads, lanes = threads / cols;
  const int col0 = threadIdx.x % cols, lane = threadIdx.x / cols;
  const bool walks = lane < lanes;
  const int cg = c / groups;
  const float n = (float)((long long)hw * cg);
  const size_t base = ((size_t)blockIdx.y * hw + lo) * c;

  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = STAGE ? (size_t)((hw + k - 1) / k) * c * sizeof(T) : 0;
  float* part = reinterpret_cast<float*>(smem + off);
  float* scale_s = part + (size_t)lanes * c;
  float* bias_s = scale_s + c;
  float* gsum = bias_s + c;
  float* gsq = gsum + groups;
  float* mean_s = gsq + groups;
  float* inv_s = mean_s + groups;
  off = (off + ((size_t)(lanes + 2) * c + 4 * groups) * 4 + 7) / 8 * 8;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + off);
  // This block's rows, (rows, C) row-major: staged in shared memory, or in x.
  const T* src = STAGE ? reinterpret_cast<const T*>(smem) : x + base;

  if (STAGE) {
    if (threadIdx.x == 0) {
      for (int p = 0; p < pieces; ++p) hopper::mbar_init(&bar[p], 1);
      hopper::fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int p = 0; p < pieces; ++p) {
        const int r0 = p * rows / pieces, r1 = (p + 1) * rows / pieces;
        const uint32_t bytes = (uint32_t)((size_t)(r1 - r0) * c * sizeof(T));
        if (bytes == 0) {
          hopper::mbar_arrive(&bar[p]);
          continue;
        }
        hopper::mbar_expect_tx(&bar[p], bytes);
        hopper::bulk_load(smem + (size_t)r0 * c * sizeof(T), x + base + (size_t)r0 * c, bytes,
                          &bar[p]);
      }
    }
  }
  // Scale and bias, read while the rows are in flight (pass 3 needs them).
  for (int ch = threadIdx.x; ch < c; ch += threads) scale_s[ch] = scale[ch], bias_s[ch] = bias[ch];

  // Pass 1: per-channel sums of the block's rows, piece by piece as they land.
  for (int j = col0; j < nv; j += cols) {
    float acc[VEC] = {};
    if (walks) {
      for (int p = 0; p < pieces; ++p) {
        const int r0 = p * rows / pieces, r1 = (p + 1) * rows / pieces;
        if (STAGE) hopper::mbar_wait(&bar[p], 0);
#pragma unroll 4
        for (int r = r0 + lane; r < r1; r += lanes) {
          float v[VEC];
          Vec<T, VEC>::load(src + (size_t)r * c + j * VEC, v);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += v[e];
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[(size_t)lane * c + j * VEC + e] = acc[e];
    }
  }
  __syncthreads();
  group_partials(part, gsum, lanes, c, groups);
  hopper::cluster_sync();
  for (int g = threadIdx.x; g < groups; g += threads) mean_s[g] = cluster_sum(gsum + g, k) / n;
  __syncthreads();

  // Pass 2: per-channel sums of the centered squares.
  for (int j = col0; j < nv; j += cols) {
    float m[VEC], acc[VEC] = {};
#pragma unroll
    for (int e = 0; e < VEC; ++e) m[e] = mean_s[(j * VEC + e) / cg];
    if (walks) {
#pragma unroll 4
      for (int r = lane; r < rows; r += lanes) {
        float v[VEC];
        Vec<T, VEC>::load(src + (size_t)r * c + j * VEC, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float d = v[e] - m[e];
          acc[e] += d * d;
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[(size_t)lane * c + j * VEC + e] = acc[e];
    }
  }
  __syncthreads();
  group_partials(part, gsq, lanes, c, groups);
  hopper::cluster_sync();
  for (int g = threadIdx.x; g < groups; g += threads)
    inv_s[g] = rsqrtf(cluster_sum(gsq + g, k) / n + eps);
  // This block has read the others' partials; none may exit before all have.
  hopper::cluster_arrive();
  __syncthreads();

  // Pass 3: normalize, affine, SiLU; 16-byte stores.
  T* dst = out + base;
  for (int j = col0; j < nv; j += cols) {
    float m[VEC], iv[VEC], sc[VEC], bi[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int ch = j * VEC + e;
      m[e] = mean_s[ch / cg], iv[e] = inv_s[ch / cg], sc[e] = scale_s[ch], bi[e] = bias_s[ch];
    }
    if (walks) {
#pragma unroll 4
      for (int r = lane; r < rows; r += lanes) {
        float v[VEC];
        Vec<T, VEC>::load(src + (size_t)r * c + j * VEC, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float y = (v[e] - m[e]) * iv[e] * sc[e] + bi[e];
          v[e] = apply_silu ? silu_f(y) : y;
        }
        Vec<T, VEC>::store(dst + (size_t)r * c + j * VEC, v);
      }
    }
  }
  hopper::cluster_wait();
}

using KernelFn = void (*)(const void*, const float*, const float*, void*, int, int, int, float,
                          int, int);

template <typename T, int VEC, bool STAGE>
KernelFn kernel_of() {
  return reinterpret_cast<KernelFn>(gn_kernel<T, VEC, STAGE>);
}

// The instantiation a plan names, or null: bf16 and fp32; staged with the
// 16-byte vector; stream with it or scalar.
KernelFn select(int dtype, int variant, int vec) {
  if (dtype == XD_BF16) {
    if (vec == 8) return variant == STAGED ? kernel_of<__nv_bfloat16, 8, true>()
                                           : kernel_of<__nv_bfloat16, 8, false>();
    if (vec == 1 && variant == STREAM) return kernel_of<__nv_bfloat16, 1, false>();
  } else if (dtype == XD_F32) {
    if (vec == 4) return variant == STAGED ? kernel_of<float, 4, true>()
                                           : kernel_of<float, 4, false>();
    if (vec == 1 && variant == STREAM) return kernel_of<float, 1, false>();
  }
  return nullptr;
}

// Checks a plan against the shape; returns the kernel or sets *err.
KernelFn checked(const int* plan, int b, int hw, int c, int groups, int dtype, int* err) {
  *err = XD_ERR_SHAPE;
  if (dtype != XD_F32 && dtype != XD_BF16) {
    *err = XD_ERR_DTYPE;
    return nullptr;
  }
  const int variant = plan[0], k = plan[1], threads = plan[2], vec = plan[3], pieces = plan[4],
            smem = plan[5];
  const int esize = dtype == XD_F32 ? 4 : 2;
  if (b <= 0 || b > 65535 || hw <= 0 || c <= 0 || groups <= 0 || c % groups) return nullptr;
  if ((k != 1 && k != 2 && k != 4 && k != 8) || k > hw) return nullptr;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return nullptr;
  if (vec <= 0 || c % vec) return nullptr;
  if (variant == STAGED ? (pieces < 1 || pieces > kMaxPieces) : pieces != 1) return nullptr;
  if (smem > kSmemLimit || smem < gn_smem(variant, hw, c, groups, esize, k, threads, vec, pieces))
    return nullptr;
  KernelFn fn = select(dtype, variant, vec);
  if (fn != nullptr) *err = 0;
  return fn;
}

// The plan's launch: grid (k, B), clusters of (k, 1, 1); with `plain`, k = 1
// launches without the cluster attribute (a block is its own cluster).
cudaLaunchConfig_t config(const int* plan, int b, cudaStream_t st, cudaLaunchAttribute* attr,
                          bool plain) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan[1], b);
  cfg.blockDim = dim3(plan[2]);
  cfg.dynamicSmemBytes = plan[5];
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = plan[1];
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = plain && plan[1] == 1 ? 0 : 1;
  return cfg;
}

// Lets every instantiation take the largest dynamic shared memory, once each.
int raise_smem_limit(KernelFn fn) {
  static KernelFn raised[6] = {};
  for (KernelFn& r : raised) {
    if (r == fn) return 0;
    if (r == nullptr) {
      const cudaError_t e = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(fn), cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemLimit);
      if (e != cudaSuccess) return (int)e;
      r = fn;
      return 0;
    }
  }
  return 0;
}

}  // namespace

// x, out: (B, HW, C) contiguous, 16-byte aligned where the plan's vector is;
// scale, bias: (C,) fp32; plan: the six ints of ops/group_norm.py
// `GnPlan.as_ints` (variant, k, threads, vec, pieces, smem).
XD_EXPORT int xd_group_norm_silu(const void* x, const void* scale, const void* bias, void* out,
                                 int b, int hw, int c, int groups, float eps, int apply_silu,
                                 int dtype, const int* plan, void* stream) {
  int err;
  const KernelFn fn = checked(plan, b, hw, c, groups, dtype, &err);
  if (fn == nullptr) return err;
  if ((err = raise_smem_limit(fn)) != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(plan, b, (cudaStream_t)stream, &attr, true);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, x, (const float*)scale, (const float*)bias,
                                           out, hw, c, groups, eps, apply_silu, plan[4]);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// How many clusters of the plan's geometry the card can hold at once
// (cudaOccupancyMaxActiveClusters) into *clusters: 0 means the launch could
// never be scheduled.
XD_EXPORT int xd_group_norm_silu_clusters(int b, int hw, int c, int groups, int dtype,
                                          const int* plan, int* clusters) {
  int err;
  const KernelFn fn = checked(plan, b, hw, c, groups, dtype, &err);
  if (fn == nullptr) return err;
  if ((err = raise_smem_limit(fn)) != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(plan, b, nullptr, &attr, false);
  return (int)cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(fn), &cfg);
}
