// int8 x int8 GEMMs with dynamic per-token activation quantization for
// Hopper (sm_90a).
//
// Replaces: lightx2v_tpu/ops/pallas/w8a8_matmul.py:w8a8_matmul_fullk
//           (_w8a8_fullk_kernel) and :ffn_w8a8 (_ffn_w8a8_kernel), int8 kind.
//
// What bounds it on this card: operations. The 14B q/k/v/o projection
// (M=32,760, N=K=5120) is 1.7e12 int8 ops against 0.7 GB, and the FFN
// (K=5120, H=13,824) 9.3e12 ops against ~1.7 GB with the int8 hidden round
// trip; both sit far above the H100's ridge of ~590 int8 ops per byte. The
// cross-attention k/v projections (M=512) are weight-read bound.
//
// What the design does about it: products run on the int8 tensor cores with
// mma.sync.m16n8k32.s8.s8.s32; operand tiles stream through a 3-stage
// cp.async ring in shared memory (rows padded to 80 bytes so ldmatrix is
// conflict-free). The TPU kernel quantizes x inside the GEMM once per
// s-block; here that is a separate pass (quant_rows_kernel) that writes
// int8 codes and one fp32 scale per row, so the GEMM reads x once as int8.
// Rounding follows the TPU kernel: scale = max(absmax, 1e-8) * (1/127),
// q = clip(rint(x / scale), +-127) with IEEE division and round-half-even.
// The epilogue is fp32, in the TPU order acc*xs*ws + b, then the optional
// tanh-GELU, stored as bf16.
//
// The fused FFN cannot keep the TPU's (512, 5120) fp32 accumulator (100 MB
// VMEM there, 227 KB of shared memory here), so it is two GEMMs around an
// int8 hidden: ffn_gemm1_kernel's CTA N-tile is exactly one bh-wide hidden
// group (bh = 512 at H = 13,824), so its epilogue can apply *xs*ws0 + b0,
// tanh-GELU in fp32, the per-(token, bh) absmax and the requantization,
// writing int8 h and fp32 hs (S, H/bh). The second GEMM (gemm_s8_kernel with
// groups) rescales each bh-group's int32 partial by hs[row, g] into an fp32
// accumulator, then applies *ws2 + b2. h never exists in fp32 or bf16 in
// device memory; the int8 round trip costs ~0.9 GB (~0.27 ms at 3.35 TB/s)
// against a 4.69 ms operation bound. Not yet used: wgmma, TMA, warp
// specialisation, persistence (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int BK = 64;          // bytes of K per pipeline stage
constexpr int LDSB = BK + 16;   // padded smem row (80 bytes)
constexpr int STAGES = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// ---------------------------------------------------------------------------
// per-row absmax quantization: x bf16 (M, K) -> q int8 (M, K), scale (M,)

__global__ void __launch_bounds__(128) quant_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                                          int8_t* __restrict__ q, float* __restrict__ scale,
                                                          int M, int K) {
  const int row = blockIdx.x;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + (long long)row * K;
  int8_t* qr = q + (long long)row * K;
  const int nchunk = K / 8;
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
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffff, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  const float s = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
  for (int c = threadIdx.x; c < nchunk; c += blockDim.x) {
    uint4 u = __ldg(reinterpret_cast<const uint4*>(xr) + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    char4 lo, hi;
    float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    lo.x = quant1(f0.x, s); lo.y = quant1(f0.y, s); lo.z = quant1(f1.x, s); lo.w = quant1(f1.y, s);
    hi.x = quant1(f2.x, s); hi.y = quant1(f2.y, s); hi.z = quant1(f3.x, s); hi.w = quant1(f3.y, s);
    uint2 out;
    out.x = *reinterpret_cast<uint32_t*>(&lo);
    out.y = *reinterpret_cast<uint32_t*>(&hi);
    reinterpret_cast<uint2*>(qr)[c] = out;
  }
  if (threadIdx.x == 0) scale[row] = s;
}

// ---------------------------------------------------------------------------
// shared GEMM main loop pieces. A (M, K) and B (N, K) are row-major int8;
// the CTA owns rows [m0, m0+BM) of A and [n0, n0+BN) of B.

template <int BM, int BN>
__device__ __forceinline__ void load_stage(int8_t* sA, int8_t* sB, const int8_t* __restrict__ A,
                                           const int8_t* __restrict__ B, int M, int N, int K, int m0, int n0,
                                           int k0, int tid) {
#pragma unroll
  for (int i = 0; i < (BM * 4 + NTHREADS - 1) / NTHREADS; ++i) {
    int c = tid + i * NTHREADS;
    if (c < BM * 4) {
      int r = c >> 2, kc = (c & 3) * 16;
      int gr = m0 + r, gk = k0 + kc;
      bool ok = gr < M && gk < K;
      cp_async16(sA + r * LDSB + kc, ok ? A + (long long)gr * K + gk : A, ok);
    }
  }
#pragma unroll
  for (int i = 0; i < (BN * 4 + NTHREADS - 1) / NTHREADS; ++i) {
    int c = tid + i * NTHREADS;
    if (c < BN * 4) {
      int r = c >> 2, kc = (c & 3) * 16;
      int gr = n0 + r, gk = k0 + kc;
      bool ok = gr < N && gk < K;
      cp_async16(sB + r * LDSB + kc, ok ? B + (long long)gr * K + gk : B, ok);
    }
  }
}

// one BK-deep stage: warp tile (MT*16) x (NT*8) at (wr0, wc0) in the CTA tile
template <int MT, int NT>
__device__ __forceinline__ void mma_stage(const int8_t* sA, const int8_t* sB, int wr0, int wc0, int lane,
                                          int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int ks = 0; ks < BK / 32; ++ks) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ldmatrix_x4(af[mt], sA + (wr0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDSB + ks * 32 + (lane >> 4) * 16);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, sB + (wc0 + np * 16 + (lane & 7) + (lane >> 4) * 8) * LDSB + ks * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_s8(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
        mma_s8(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// out (M, N) bf16 = act( (sum_g float(int32 partial_g) * a_scale[m, g]) * ws[n] + bias[n] )
// group_tiles BK-tiles per group; G = 1 gives the plain per-token contract.

constexpr int G_BM = 128, G_BN = 128, G_WM = 2, G_WN = 4;
constexpr int G_MT = G_BM / G_WM / 16;  // 4
constexpr int G_NT = G_BN / G_WN / 8;   // 4
constexpr int G_SMEM = STAGES * (G_BM + G_BN) * LDSB;

template <bool GELU>
__global__ void __launch_bounds__(NTHREADS) gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                                                           const float* __restrict__ a_scale, int G, int group_tiles,
                                                           const float* __restrict__ ws,
                                                           const float* __restrict__ bias,
                                                           __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / G_WN, wn = warp % G_WN;
  const int n0 = blockIdx.x * G_BN, m0 = blockIdx.y * G_BM;
  const int wr0 = wm * G_MT * 16, wc0 = wn * G_NT * 8;
  const int g = lane >> 2, tq = lane & 3;
  const int KT = (K + BK - 1) / BK;

  int acc[G_MT][G_NT][4];
  float facc[G_MT][G_NT][4];
#pragma unroll
  for (int a = 0; a < G_MT; ++a)
#pragma unroll
    for (int b = 0; b < G_NT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) { acc[a][b][c] = 0; facc[a][b][c] = 0.f; }

  auto sA = [&](int st) { return smem + st * (G_BM + G_BN) * LDSB; };
  auto sB = [&](int st) { return smem + st * (G_BM + G_BN) * LDSB + G_BM * LDSB; };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load_stage<G_BM, G_BN>(sA(st), sB(st), A, B, M, N, K, m0, n0, st * BK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    int nk = kt + STAGES - 1;
    if (nk < KT) load_stage<G_BM, G_BN>(sA(nk % STAGES), sB(nk % STAGES), A, B, M, N, K, m0, n0, nk * BK, tid);
    cp_async_commit();
    mma_stage<G_MT, G_NT>(sA(kt % STAGES), sB(kt % STAGES), wr0, wc0, lane, acc);
    if ((kt + 1) % group_tiles == 0 || kt + 1 == KT) {
      const int grp = kt / group_tiles;
#pragma unroll
      for (int mt = 0; mt < G_MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int r = m0 + wr0 + mt * 16 + g + h * 8;
          float sc = r < M ? __ldg(a_scale + (long long)r * G + grp) : 0.f;
#pragma unroll
          for (int nt = 0; nt < G_NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              facc[mt][nt][h * 2 + e] =
                  __fadd_rn(facc[mt][nt][h * 2 + e], __fmul_rn(__int2float_rn(acc[mt][nt][h * 2 + e]), sc));
              acc[mt][nt][h * 2 + e] = 0;
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < G_NT; ++nt) {
    int c = n0 + wc0 + nt * 8 + 2 * tq;
    float w0 = c < N ? __ldg(ws + c) : 0.f, w1 = c + 1 < N ? __ldg(ws + c + 1) : 0.f;
    float b0 = c < N ? __ldg(bias + c) : 0.f, b1 = c + 1 < N ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < G_MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r = m0 + wr0 + mt * 16 + g + h * 8;
        if (r >= M) continue;
        float y0 = __fadd_rn(__fmul_rn(facc[mt][nt][h * 2], w0), b0);
        float y1 = __fadd_rn(__fmul_rn(facc[mt][nt][h * 2 + 1], w1), b1);
        if (GELU) { y0 = gelu_tanh(y0); y1 = gelu_tanh(y1); }
        __nv_bfloat16* orow = out + (long long)r * N;
        if (c + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(y0, y1);
        } else if (c < N) {
          orow[c] = __float2bfloat16_rn(y0);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// FFN first GEMM: hq (M, H) int8 and hs (M, H/bh) from
// gelu(float(xq . w0) * xs * ws0 + b0), requantized per (row, bh group).
// The CTA tile is 64 rows x one bh group (8 warps side by side, NT*8 columns
// each), so the group absmax never leaves the CTA.

template <int NT>
struct Gemm1Cfg {
  static constexpr int BM = 64, MT = 4, BN = 8 * NT * 8;
  static constexpr int SMEM = STAGES * (BM + BN) * LDSB;
};

template <int NT>
__global__ void __launch_bounds__(NTHREADS, 1) ffn_gemm1_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                                                                const float* __restrict__ xs,
                                                                const float* __restrict__ ws0,
                                                                const float* __restrict__ b0,
                                                                int8_t* __restrict__ hq, float* __restrict__ hs,
                                                                int M, int H, int K) {
  using C = Gemm1Cfg<NT>;
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ float red[8][C::BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM;
  const int wc0 = warp * NT * 8;
  const int g = lane >> 2, tq = lane & 3;
  const int KT = (K + BK - 1) / BK;
  const int n_groups = H / C::BN;

  int acc[C::MT][NT][4];
#pragma unroll
  for (int a = 0; a < C::MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

  auto sA = [&](int st) { return smem + st * (C::BM + C::BN) * LDSB; };
  auto sB = [&](int st) { return smem + st * (C::BM + C::BN) * LDSB + C::BM * LDSB; };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load_stage<C::BM, C::BN>(sA(st), sB(st), A, B, M, H, K, m0, n0, st * BK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    int nk = kt + STAGES - 1;
    if (nk < KT) load_stage<C::BM, C::BN>(sA(nk % STAGES), sB(nk % STAGES), A, B, M, H, K, m0, n0, nk * BK, tid);
    cp_async_commit();
    mma_stage<C::MT, NT>(sA(kt % STAGES), sB(kt % STAGES), 0, wc0, lane, acc);
  }
  cp_async_wait<0>();

  // epilogue 1: h = gelu(acc*xs*ws0 + b0) in fp32, kept in registers
  float hf[C::MT][NT][4];
  float amax[C::MT][2];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
    amax[mt][0] = amax[mt][1] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r = m0 + mt * 16 + g + h * 8;
      float sx = r < M ? __ldg(xs + r) : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int c = n0 + wc0 + nt * 8 + 2 * tq + e;
          float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][h * 2 + e]), sx), __ldg(ws0 + c));
          y = gelu_tanh(__fadd_rn(y, __ldg(b0 + c)));
          hf[mt][nt][h * 2 + e] = y;
          amax[mt][h] = fmaxf(amax[mt][h], fabsf(y));
        }
      }
    }
  }
  // group absmax: quad lanes, then the 8 warps through shared memory
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = amax[mt][h];
      a = fmaxf(a, __shfl_xor_sync(0xffffffff, a, 1));
      a = fmaxf(a, __shfl_xor_sync(0xffffffff, a, 2));
      if (tq == 0) red[warp][mt * 16 + g + h * 8] = a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int lr = mt * 16 + g + h * 8;
      int r = m0 + lr;
      float a = red[0][lr];
#pragma unroll
      for (int w = 1; w < 8; ++w) a = fmaxf(a, red[w][lr]);
      const float s = __fmul_rn(fmaxf(a, 1e-8f), 1.0f / 127.0f);
      if (r >= M) continue;
      if (warp == 0 && tq == 0) hs[(long long)r * n_groups + blockIdx.x] = s;
      int8_t* hrow = hq + (long long)r * H;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int c = n0 + wc0 + nt * 8 + 2 * tq;
        char2 pair;
        pair.x = quant1(hf[mt][nt][h * 2], s);
        pair.y = quant1(hf[mt][nt][h * 2 + 1], s);
        *reinterpret_cast<char2*>(hrow + c) = pair;
      }
    }
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int NT>
int launch_gemm1(const void* xq, const void* w0, const void* xs, const void* ws0, const void* b0, void* hq,
                 void* hs, int M, int H, int K, cudaStream_t stream) {
  using C = Gemm1Cfg<NT>;
  auto kern = ffn_gemm1_kernel<NT>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H / C::BN, (M + C::BM - 1) / C::BM);
  kern<<<grid, NTHREADS, C::SMEM, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w0), static_cast<const float*>(xs),
      static_cast<const float*>(ws0), static_cast<const float*>(b0), static_cast<int8_t*>(hq),
      static_cast<float*>(hs), M, H, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int w8a8_quant_rows(const void* x, void* q, void* scale, int M, int K, void* stream) {
  if (M == 0) return 0;
  quant_rows_kernel<<<M, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), M, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int w8a8_gemm(const void* a, const void* b, const void* a_scale, int G, int group, const void* ws,
                         const void* bias, void* out, int M, int N, int K, int gelu, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group_tiles = (G == 1) ? (K + BK - 1) / BK : group / BK;
  dim3 grid((N + G_BN - 1) / G_BN, (M + G_BM - 1) / G_BM);
  cudaError_t err;
  if (gelu) {
    err = set_smem(gemm_s8_kernel<true>, G_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    gemm_s8_kernel<true><<<grid, NTHREADS, G_SMEM, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<const float*>(a_scale), G,
        group_tiles, static_cast<const float*>(ws), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), M, N, K);
  } else {
    err = set_smem(gemm_s8_kernel<false>, G_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    gemm_s8_kernel<false><<<grid, NTHREADS, G_SMEM, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<const float*>(a_scale), G,
        group_tiles, static_cast<const float*>(ws), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ffn_w8a8_gemm1(const void* xq, const void* w0, const void* xs, const void* ws0, const void* b0,
                              void* hq, void* hs, int M, int H, int K, int bh, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bh) {
    case 512: return launch_gemm1<8>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, s);
    case 256: return launch_gemm1<4>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, s);
    case 128: return launch_gemm1<2>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
