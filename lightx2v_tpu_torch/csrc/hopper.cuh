// Hopper (sm_90a) pieces shared by the wgmma kernels (int4_matmul.cu,
// flash_attention.cu and sage_attention.cu through flash_wgmma.cuh,
// w8a8_matmul.cu, w4a8_matmul.cu): the wgmma fences, the shared-memory
// descriptors of the 128- and 64-byte swizzles, the accumulator operand
// lists of the 8-bit wgmma shapes, shared-memory loads and stores by 32-bit
// address, mbarriers, cluster ranks, barriers and distributed shared memory,
// the unit walk and launch of the cluster kernels (the FFNs' first GEMMs in
// w8a8_matmul.cu and w4a8_matmul.cu), TMA copies in both directions, tensor
// maps, and cuTensorMapEncodeTiled looked up through the CUDA runtime's
// entry-point query (so no library needs -lcuda).
//
// Each .cu that includes this file gets its own copy (anonymous namespace).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "int8_mma.cuh"  // smem_u32, set_smem

namespace {

// wgmma shared-memory descriptor, 128-byte swizzle, 8-row groups 1024 bytes
// apart (the stride byte offset). K-major (the K dimension contiguous), the
// leading offset is unused. MN-major (the M or N dimension contiguous), the
// 8-row groups run along K and the leading offset steps from one 64-element
// swizzle atom of M or N to the next: unused while an operand spans one atom.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// The same for a K-major operand in the 64-byte swizzle (rows of 64 bytes,
// 8-row groups 512 bytes apart), as TMA writes a box with
// CU_TENSOR_MAP_SWIZZLE_64B: layout type 2, stride byte offset 512. A k32
// step of 8-bit values moves the start 32 bytes inside the swizzle row.
__device__ __forceinline__ uint64_t make_desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(512 >> 4) << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads above the wait that
// completes them (the asm emits nothing, but it counts as a use: ptxas
// inserts a wait before any use of registers a wgmma in flight still writes)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Accumulator operand lists of wgmma.m64nNk32 (8-bit operands) at N = 128,
// 192 and 256: "{%0, ..., %(N/2 - 1)}" in the asm text and the matching
// constraints, "+f" (W8_F) or "+r" (W8_R) for each of a thread's N/2
// registers; the operands after them start at %(N/2).
#define W8_D64 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}"
#define W8_D96 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" \
  "}"
#define W8_D128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
  "}"
#define W8_F(x) "+f"(x)
#define W8_R(x) "+r"(x)
#define W8_OP8(C, d, o) \
  C(d[o]), C(d[o + 1]), C(d[o + 2]), C(d[o + 3]), C(d[o + 4]), C(d[o + 5]), C(d[o + 6]), C(d[o + 7])
#define W8_OP64(C, d) \
  W8_OP8(C, d, 0), W8_OP8(C, d, 8), W8_OP8(C, d, 16), W8_OP8(C, d, 24), W8_OP8(C, d, 32), W8_OP8(C, d, 40), \
      W8_OP8(C, d, 48), W8_OP8(C, d, 56)
#define W8_OP96(C, d) W8_OP64(C, d), W8_OP8(C, d, 64), W8_OP8(C, d, 72), W8_OP8(C, d, 80), W8_OP8(C, d, 88)
#define W8_OP128(C, d) W8_OP96(C, d), W8_OP8(C, d, 96), W8_OP8(C, d, 104), W8_OP8(C, d, 112), W8_OP8(C, d, 120)

// ---- shared memory by 32-bit address ----
__device__ __forceinline__ void st_shared_b8(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b8 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_b16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_v2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ uint2 ld_shared_v2(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// ---- thread block clusters (1-D) ----
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_size() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_id() {
  int r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_count() {
  int r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster; orders shared-memory accesses
// across the cluster (not .aligned: the callers need not be converged)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// the same shared-memory location in the cluster's CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster_v2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z),
               "f"(v.w)
               : "memory");
}
// an arrive on a barrier of any CTA of the cluster (addr from map_rank),
// releasing this thread's earlier stores to the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr) : "memory");
}
// a wait that acquires what the arrivals released at cluster scope
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// ---- the cluster kernels' persistent walk ----
// A unit is one token tile x one hidden group, covered by a cluster of CTAs
// side by side along the hidden axis; every CTA of a cluster walks the same
// units, cluster c taking units c, c + clusters, ...
constexpr int MAX_CLUSTER = 4;  // CTAs a cluster
constexpr int GB = 8;           // hidden groups in a block of the unit walk

// unit u -> (token tile, hidden group): blocks of GB groups over every token
// tile, token tile outer and group inner inside a block, so the clusters in
// flight share GB groups of the weights and a few token tiles in L2
__device__ __forceinline__ int2 unit_coords(int u, int n_mt, int n_g) {
  const int blk = u / (GB * n_mt), r = u - blk * GB * n_mt;
  const int g0 = blk * GB, gw = min(GB, n_g - g0);
  return make_int2(r / gw, g0 + r % gw);
}

// Launches kern on 1-D clusters of cs CTAs, one cluster for each that the
// card holds at once (at most `units`). max_clusters caches that count for
// this kernel and cluster size (cudaOccupancyMaxActiveClusters, asked once).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kern)(Params...), int& max_clusters, int threads, int smem, int cs, int units,
                            cudaStream_t s, Args... args) {
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (max_clusters == 0) {
    cfg.gridDim = dim3(cs);
    err = cudaOccupancyMaxActiveClusters(&max_clusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (max_clusters == 0) return cudaErrorInvalidConfiguration;
  }
  cfg.gridDim = dim3(min(units, max_clusters) * cs);
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- TMA ----
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// shared -> global; elements past the tensor's extent are not written. The
// writes to `src` must be made visible to the async proxy first
// (fence.proxy.async.shared::cta), and `src` must stay untouched until
// tma_store_wait() returns.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a tensor map of `rank` dimensions, innermost first: extents dims[],
// byte strides of dimensions 1.. in strides[], boxes of box[] elements
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return enc(map, type, rank, const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 2-D tensor map of `rows` x `cols` elements (row pitch `pitch` bytes),
// boxes of box_rows x box_cols
bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rows, int cols, long long pitch,
                 int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  return make_map(map, type, base, 2, dims, strides, box, swizzle);
}

}  // namespace
