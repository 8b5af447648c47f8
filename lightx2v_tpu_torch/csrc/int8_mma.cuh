// Pieces shared by the 8-bit tensor-core kernels (w8a8_matmul.cu,
// w4a8_matmul.cu): tanh-GELU in the TPU kernels' evaluation order, the
// code kinds' rounding, and the dynamic per-(row, group) activation
// quantization pass to int8 or e4m3 codes.
//
// Each .cu that includes this file gets its own copy (anonymous namespace),
// so every shared library stays self-contained.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the wgmma kernels' accumulators (int32 or fp32) as fp32
__device__ __forceinline__ float acc_to_float(int a) { return __int2float_rn(a); }
__device__ __forceinline__ float acc_to_float(float a) { return a; }

// tanh-GELU evaluated in the TPU kernel's order:
// 0.5*y*(1 + tanh(0.7978845608028654*(y + 0.044715*y*y*y)))
__device__ __forceinline__ float gelu_tanh(float y) {
  float y3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y), y), y);
  float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(y, y3));
  return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.0f, tanhf(inner)));
}

__device__ __forceinline__ int8_t quant1(float x, float s) {
  float r = rintf(__fdiv_rn(x, s));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// The two code kinds: scale = max(absmax, 1e-8) * INV_MAX, and a pair of
// codes (first value in the low byte) from x / scale with IEEE division.
// int8 rounds half to even and clips at +-127; e4m3 rounds to nearest even
// and saturates at +-448 (cvt.rn.satfinite, the rounding of torch's cast;
// x / scale <= 448 up to one fp32 ulp, so saturation never decides a code).
template <bool FP8>
struct Codes;
template <>
struct Codes<false> {
  using Acc = int;
  static constexpr float INV_MAX = 1.0f / 127.0f;
  __device__ static __forceinline__ uint16_t pair(float a, float b, float s) {
    return static_cast<uint16_t>(static_cast<uint8_t>(quant1(a, s)) |
                                 (static_cast<uint16_t>(static_cast<uint8_t>(quant1(b, s))) << 8));
  }
};
template <>
struct Codes<true> {
  using Acc = float;
  static constexpr float INV_MAX = 1.0f / 448.0f;
  __device__ static __forceinline__ uint16_t pair(float a, float b, float s) {
    return static_cast<uint16_t>(
        __nv_cvt_float2_to_fp8x2(make_float2(__fdiv_rn(a, s), __fdiv_rn(b, s)), __NV_SATFINITE, __NV_E4M3));
  }
};

// ---------------------------------------------------------------------------
// per-(row, group) absmax quantization: x bf16 (M, K) -> q (M, K) int8 or
// e4m3 codes and scale (M, K / group) fp32, one 128-thread block per (row,
// group), with the codes of Codes<FP8> (the TPU kernels' rounding). group ==
// K gives the per-token contract. group % 8 == 0.

template <bool FP8>
__global__ void __launch_bounds__(128) quant_groups_kernel(const __nv_bfloat16* __restrict__ x,
                                                            uint8_t* __restrict__ q, float* __restrict__ scale,
                                                            int M, int K, int group) {
  const int row = blockIdx.x, grp = blockIdx.y;
  if (row >= M) return;
  const long long off = (long long)row * K + (long long)grp * group;
  const __nv_bfloat16* xr = x + off;
  uint8_t* qr = q + off;
  const int nchunk = group / 8;
  float amax = 0.f;
  for (int c = threadIdx.x; c < nchunk; c += blockDim.x) {
    uint4 u = __ldg(reinterpret_cast<const uint4*>(xr) + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  __shared__ float red[4];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffff, amax, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  const float s = __fmul_rn(fmaxf(amax, 1e-8f), Codes<FP8>::INV_MAX);
  for (int c = threadIdx.x; c < nchunk; c += blockDim.x) {
    uint4 u = __ldg(reinterpret_cast<const uint4*>(xr) + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    uint32_t p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      p[i] = Codes<FP8>::pair(f.x, f.y, s);
    }
    reinterpret_cast<uint2*>(qr)[c] = make_uint2(p[0] | (p[1] << 16), p[2] | (p[3] << 16));
  }
  if (threadIdx.x == 0) scale[(long long)row * (K / group) + grp] = s;
}

template <bool FP8 = false>
int launch_quant_groups(const void* x, void* q, void* scale, int M, int K, int group, void* stream) {
  if (M == 0) return 0;
  if (group <= 0 || K % group || group % 8) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(M, K / group);
  quant_groups_kernel<FP8><<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<uint8_t*>(q), static_cast<float*>(scale), M, K, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kern>
cudaError_t set_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
