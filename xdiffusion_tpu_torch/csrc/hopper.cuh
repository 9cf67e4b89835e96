// Hopper (sm_90a) building blocks of the port's kernels: mbarriers, TMA tile
// loads and 1-D bulk copies, thread-block cluster barriers and distributed
// shared memory reads, ldmatrix, and wgmma with A from registers and B from
// shared memory through a matrix descriptor.
//
// The descriptors here describe B tiles as TMA writes them with a 128-byte
// swizzle: rows of 64 bf16 (128 bytes), eight rows to a 1024-byte swizzle
// atom. B is N-major (the weight's rows are K, its columns N contiguous),
// so every wgmma below runs with B transposed: the leading byte offset (LBO)
// steps from one 64-column atom to the next along N, the stride byte offset
// (SBO) from one group of 8 K rows to the next.
#pragma once

#include <cuda.h>  // CUtensorMap (types only; the encoder is looked up at run time)
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <mutex>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Adds `bytes` to the transaction count of the current phase, without an
// arrival (the arrival follows once the thread's other writes are done).
__device__ __forceinline__ void mbar_add_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed. A wait past about
// ten seconds traps (the launch then fails with an error) instead of hanging
// the card on a lost arrival.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  } while (!done);
}

// ---- TMA -----------------------------------------------------------------------

// A 2-D tile of `map` at (c0 = column, c1 = row) into shared memory; the
// bytes complete on `bar`. Out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// A 4-D tile of `map` at (c0, c1, c2, c3), innermost first; coordinates may
// be negative (the elements there arrive as zeros).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// A 4-D tile from shared memory to `map` at (c0, c1, c2, c3); elements
// outside the tensor are not written. Completes in this thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's bulk groups are pending: with
// `read`, only until their shared memory has been read.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's earlier generic-proxy accesses of shared memory
// before later async-proxy ones (TMA writes into a buffer just read).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// `bytes` contiguous bytes of global memory into this block's shared memory
// (both 16-byte aligned, bytes a multiple of 16); they complete on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- thread-block clusters -------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// Every thread of every block of the cluster calls both: arrive publishes
// this thread's earlier writes (release), wait returns once all have
// arrived and makes their writes visible (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// The float at `p` in the shared memory of the cluster's block `rank`
// (p: an address in this block's shared memory; the same offset there).
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// ---- ldmatrix ------------------------------------------------------------------

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ---- wgmma ---------------------------------------------------------------------

// Descriptor of a B tile in the 128-byte swizzled layout (see the note at
// the top): start address, LBO and SBO in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Descriptor of a K-major tile in the 128-byte swizzled layout: rows of 64
// bf16 along K (128 bytes, 16-byte chunks swizzled by the row's index mod
// 8), one row per M (or N) index, eight rows to a 1024-byte atom: SBO steps
// from one group of 8 rows to the next; LBO is unused. A k16 step inside
// the 128-byte row moves the start address by 32 bytes (the swizzle is a
// function of the address, so the tile must start on 1024 bytes).
__device__ __forceinline__ uint64_t desc_k_sw128(uint32_t saddr) {
  return desc_sw128(saddr, 16, 1024);
}

// The descriptors of N k16 steps, computed before a group's fence: a
// register defined between the wgmmas of one group serializes them (ptxas
// C7513). K-major tiles step 32 bytes along the swizzled row; N-major ones
// (B transposed) step 16 rows of 128 bytes.
template <int N>
__device__ __forceinline__ void descs_k(uint64_t (&d)[N], uint32_t saddr) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    d[i] = desc_k_sw128(saddr + 32 * i);
    asm volatile("" : "+l"(d[i]));
  }
}
template <int N>
__device__ __forceinline__ void descs_n(uint64_t (&d)[N], uint32_t saddr, uint32_t lbo) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    d[i] = desc_sw128(saddr + 2048 * i, lbo, 1024);
    asm volatile("" : "+l"(d[i]));
  }
}
// The scale-d operands 0 (the first k step overwrites D) and 1, as
// registers defined before a group's fence.
struct ScaleD {
  int zero = 0, one = 1;
  __device__ __forceinline__ ScaleD() { asm volatile("" : "+r"(zero), "+r"(one)); }
  __device__ __forceinline__ int operator()(int k) const { return k ? one : zero; }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Hands registers between warpgroups (all four warps of one call it).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// Keeps the compiler from moving accesses of v across this point (the
// accumulators of an asynchronous wgmma).
template <int N>
__device__ __forceinline__ void fence_operands(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}

// D(64 x 64, fp32) += A(64 x 16, bf16, registers) * B(16 x 64, bf16, shared,
// N-major: transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D(64 x 128, fp32) += A(64 x 16, bf16, registers) * B(16 x 128, bf16, shared,
// N-major: transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D(64 x 64, fp32) (+)= A(64 x 16, bf16, shared, K-major) * B(16 x 64, bf16,
// shared, K-major): both operands by descriptor, neither transposed.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 128, fp32) (+)= A(64 x 16, shared, K-major) * B(16 x 128, shared,
// K-major), bf16.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N of 64 or 128");
  if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b, scale_d);
  else wgmma_rs_n128(d, a, desc_b, scale_d);
}

// ---- host: the tensor-map encoder ----------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime so that the library
// links no libcuda; null where it is missing.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 4-D bf16 tensor map of (B, H, S, D) operands read through their
// strides, 64 columns of D by `rows` rows of S a box in the 128-byte
// swizzle; rows past S arrive as zeros. Maps are kept by (address, sizes,
// strides, box): a wrapper called again on the same tensors, or on the
// caching allocator's reused blocks, does not encode again. Returns 0 or
// an error code.
inline int bf16_rows_map(CUtensorMap* out, const void* ptr, long long b, long long h,
                         long long s, long long d, const long long* strides, int rows) {
  struct Entry {
    const void* ptr;
    long long key[8];
    CUtensorMap map;
  };
  constexpr int kEntries = 64;
  static Entry cache[kEntries];
  static int used = 0, next = 0;
  static std::mutex mu;
  const long long key[8] = {b, h, s, d, strides[0], strides[1], strides[2], rows};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (cache[i].ptr == ptr && std::memcmp(cache[i].key, key, sizeof(key)) == 0) {
      *out = cache[i].map;
      return 0;
    }
  }
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t gstr[3] = {(cuuint64_t)strides[2] * 2, (cuuint64_t)strides[1] * 2,
                              (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1}, elem[4] = {1, 1, 1, 1};
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, gstr, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return 1002;  // XD_ERR_SHAPE
  Entry& e = cache[next];
  e.ptr = ptr;
  std::memcpy(e.key, key, sizeof(key));
  e.map = *out;
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return 0;
}

}  // namespace hopper
