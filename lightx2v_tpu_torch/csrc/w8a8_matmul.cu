// 8-bit GEMMs with dynamic per-token activation quantization for Hopper
// (sm_90a), in two kinds: int8 x int8 with int32 sums, and e4m3 x e4m3
// (fp8) with fp32 sums.
//
// Replaces: lightx2v_tpu/ops/pallas/w8a8_matmul.py:w8a8_matmul_fullk
//           (_w8a8_fullk_kernel), :w8a8_matmul (_w8a8_kernel, the k-blocked
//           form with per-(token, k-block) activation scales) and :ffn_w8a8
//           (_ffn_w8a8_kernel), both kinds (the Pallas kernels' ``kind``
//           argument, "int8" or "fp8").
//
// What bounds it on this card: operations, for both kinds (1979 TOP/s int8
// and 1979 TFLOP/s dense fp8, the same bytes). The 14B q/k/v/o projection
// (M=32,760, N=K=5120) is 1.7e12 ops against 0.7 GB, and the FFN
// (K=5120, H=13,824) 9.3e12 ops against ~1.7 GB with the 8-bit hidden round
// trip; both sit far above the H100's ridge of ~590 ops per byte. The
// cross-attention k/v projections (M=512) and the UMT5-XXL linears (M=512)
// are near the ridge.
//
// What the design does about it: products run on the tensor cores with
// mma.sync.m16n8k32 (.s8.s8.s32, or .f32.e4m3.e4m3.f32, whose operand and
// accumulator fragments have the same layout); operand tiles stream through
// a 3-stage cp.async ring in shared memory (rows padded to 80 bytes so
// ldmatrix is conflict-free). Every kernel is a template on the kind
// (Codes<FP8> in int8_mma.cuh), so both kinds share one schedule. The TPU
// kernel quantizes x inside the GEMM once per s-block; here that is a
// separate pass (quant_groups_kernel in int8_mma.cuh) that writes 8-bit codes
// and one fp32 scale per row, so the GEMM reads x once at one byte a value.
// The k-blocked form is the same pass with one scale per (row, 1024-wide
// k-block) feeding the grouped GEMM below, whose fp32 accumulator adds
// float(partial) * xs[row, kb] block by block in k order, then applies
// *ws + b: the TPU kernel's order. The UMT5-XXL fc2 (M=512, K=10,240,
// N=4096) takes it: 43 GOP against 42 MB, bound by operations at ~0.022 ms.
// Rounding follows the TPU kernel: scale = max(absmax, 1e-8) * (1/127) or
// * (1/448); int8 codes are clip(rint(x / scale), +-127), e4m3 codes are
// x / scale rounded to nearest even (cvt.rn.satfinite), both with IEEE
// division. The epilogue is fp32, in the TPU order acc*xs*ws + b, then the
// optional tanh-GELU, stored as bf16.
//
// Accumulation: an int32 partial is exact. An e4m3 partial is summed by the
// tensor cores in fp32 registers over a whole scale group (all of K = 5120 in
// the full-K form). Folding it into a separate fp32 sum every 128 or 512 K
// values, tried at 32,760 x 5120 x 5120 on the H100, left the largest
// difference from the plain version (the exact sum) at one bf16 ulp, as
// without it, and cost 17% or 3% of the time (PERF.md, PR 6), so the
// kernels do not fold.
//
// The fused FFN cannot keep the TPU's (512, 5120) fp32 accumulator (100 MB
// VMEM there, 227 KB of shared memory here), so it is two GEMMs around an
// 8-bit hidden: ffn_gemm1_kernel's CTA N-tile is exactly one bh-wide hidden
// group (bh = 512 at H = 13,824), so its epilogue can apply *xs*ws0 + b0,
// tanh-GELU in fp32, the per-(token, bh) absmax and the requantization,
// writing 8-bit h and fp32 hs (S, H/bh). The second GEMM (the grouped GEMM)
// rescales each bh-group's partial by hs[row, g] into an fp32 accumulator,
// then applies *ws2 + b2. h never exists in fp32 or bf16 in device memory;
// the 8-bit round trip costs ~0.9 GB (~0.27 ms at 3.35 TB/s) against a
// 4.69 ms operation bound. Not yet used: wgmma, TMA, warp specialisation,
// persistence (later work).

#include "int8_mma.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int BK = 64;          // bytes of K per pipeline stage
constexpr int LDSB = BK + 16;   // padded smem row (80 bytes)
constexpr int STAGES = 3;

// ---------------------------------------------------------------------------
// shared GEMM main loop pieces. A (M, K) and B (N, K) are row-major 8-bit codes;
// the CTA owns rows [m0, m0+BM) of A and [n0, n0+BN) of B.

template <int BM, int BN>
__device__ __forceinline__ void load_stage(uint8_t* sA, uint8_t* sB, const uint8_t* __restrict__ A,
                                           const uint8_t* __restrict__ B, int M, int N, int K, int m0, int n0,
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
template <int MT, int NT, typename Acc>
__device__ __forceinline__ void mma_stage(const uint8_t* sA, const uint8_t* sB, int wr0, int wc0, int lane,
                                          Acc (&acc)[MT][NT][4]) {
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
        mma8(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
        mma8(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// out (M, N) bf16 = act( (sum_g float(partial_g) * a_scale[m, g]) * ws[n] + bias[n] )
// group_tiles BK-tiles per scale group; G = 1 gives the plain per-token
// contract.

constexpr int G_BM = 128, G_BN = 128, G_WM = 2, G_WN = 4;
constexpr int G_MT = G_BM / G_WM / 16;  // 4
constexpr int G_NT = G_BN / G_WN / 8;   // 4
constexpr int G_SMEM = STAGES * (G_BM + G_BN) * LDSB;

template <bool FP8, bool GELU>
__global__ void __launch_bounds__(NTHREADS) gemm_8bit_kernel(const uint8_t* __restrict__ A,
                                                             const uint8_t* __restrict__ B,
                                                             const float* __restrict__ a_scale, int G,
                                                             int group_tiles, const float* __restrict__ ws,
                                                             const float* __restrict__ bias,
                                                             __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using Acc = typename Codes<FP8>::Acc;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / G_WN, wn = warp % G_WN;
  const int n0 = blockIdx.x * G_BN, m0 = blockIdx.y * G_BM;
  const int wr0 = wm * G_MT * 16, wc0 = wn * G_NT * 8;
  const int g = lane >> 2, tq = lane & 3;
  const int KT = (K + BK - 1) / BK;

  Acc acc[G_MT][G_NT][4];
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
                  __fadd_rn(facc[mt][nt][h * 2 + e], __fmul_rn(acc_to_float(acc[mt][nt][h * 2 + e]), sc));
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
// FFN first GEMM: hq (M, H) 8-bit codes and hs (M, H/bh) from
// gelu(float(xq . w0) * xs * ws0 + b0), requantized per (row, bh group).
// The CTA tile is 64 rows x one bh group (8 warps side by side, NT*8 columns
// each), so the group absmax never leaves the CTA.

template <int NT>
struct Gemm1Cfg {
  static constexpr int BM = 64, MT = 4, BN = 8 * NT * 8;
  static constexpr int SMEM = STAGES * (BM + BN) * LDSB;
};

template <bool FP8, int NT>
__global__ void __launch_bounds__(NTHREADS, 1) ffn_gemm1_kernel(const uint8_t* __restrict__ A,
                                                                const uint8_t* __restrict__ B,
                                                                const float* __restrict__ xs,
                                                                const float* __restrict__ ws0,
                                                                const float* __restrict__ b0,
                                                                uint8_t* __restrict__ hq, float* __restrict__ hs,
                                                                int M, int H, int K) {
  using C = Gemm1Cfg<NT>;
  using Acc = typename Codes<FP8>::Acc;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red[8][C::BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM;
  const int wc0 = warp * NT * 8;
  const int g = lane >> 2, tq = lane & 3;
  const int KT = (K + BK - 1) / BK;
  const int n_groups = H / C::BN;

  Acc acc[C::MT][NT][4];
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
          float y = __fmul_rn(__fmul_rn(acc_to_float(acc[mt][nt][h * 2 + e]), sx), __ldg(ws0 + c));
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
      const float s = __fmul_rn(fmaxf(a, 1e-8f), Codes<FP8>::INV_MAX);
      if (r >= M) continue;
      if (warp == 0 && tq == 0) hs[(long long)r * n_groups + blockIdx.x] = s;
      uint8_t* hrow = hq + (long long)r * H;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int c = n0 + wc0 + nt * 8 + 2 * tq;
        *reinterpret_cast<uint16_t*>(hrow + c) = Codes<FP8>::pair(hf[mt][nt][h * 2], hf[mt][nt][h * 2 + 1], s);
      }
    }
  }
}

template <bool FP8, int NT>
int launch_gemm1(const void* xq, const void* w0, const void* xs, const void* ws0, const void* b0, void* hq,
                 void* hs, int M, int H, int K, cudaStream_t stream) {
  using C = Gemm1Cfg<NT>;
  auto kern = ffn_gemm1_kernel<FP8, NT>;
  cudaError_t err = set_smem(kern, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H / C::BN, (M + C::BM - 1) / C::BM);
  kern<<<grid, NTHREADS, C::SMEM, stream>>>(
      static_cast<const uint8_t*>(xq), static_cast<const uint8_t*>(w0), static_cast<const float*>(xs),
      static_cast<const float*>(ws0), static_cast<const float*>(b0), static_cast<uint8_t*>(hq),
      static_cast<float*>(hs), M, H, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool FP8>
int launch_gemm1_bh(const void* xq, const void* w0, const void* xs, const void* ws0, const void* b0, void* hq,
                    void* hs, int M, int H, int K, int bh, cudaStream_t s) {
  switch (bh) {
    case 512: return launch_gemm1<FP8, 8>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, s);
    case 256: return launch_gemm1<FP8, 4>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, s);
    case 128: return launch_gemm1<FP8, 2>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool FP8, bool GELU>
int launch_gemm(const void* a, const void* b, const void* a_scale, int G, int group_tiles, const void* ws,
                const void* bias, void* out, int M, int N, int K, cudaStream_t s) {
  auto kern = gemm_8bit_kernel<FP8, GELU>;
  cudaError_t err = set_smem(kern, G_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + G_BN - 1) / G_BN, (M + G_BM - 1) / G_BM);
  kern<<<grid, NTHREADS, G_SMEM, s>>>(static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
                                      static_cast<const float*>(a_scale), G, group_tiles,
                                      static_cast<const float*>(ws), static_cast<const float*>(bias),
                                      static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 = int8, 1 = e4m3. Codes are one byte a value either way.
extern "C" int w8a8_quant_groups(int kind, const void* x, void* q, void* scale, int M, int K, int group,
                                 void* stream) {
  return kind ? launch_quant_groups<true>(x, q, scale, M, K, group, stream)
              : launch_quant_groups<false>(x, q, scale, M, K, group, stream);
}

// G scale groups of `group` values along K (G = 1: one scale per row over
// all of K).
extern "C" int w8a8_gemm(const void* a, const void* b, const void* a_scale, int G, int group, const void* ws,
                         const void* bias, void* out, int M, int N, int K, int gelu, int kind, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group_tiles = (G == 1) ? (K + BK - 1) / BK : group / BK;
  if (kind) {
    return gelu ? launch_gemm<true, true>(a, b, a_scale, G, group_tiles, ws, bias, out, M, N, K, s)
                : launch_gemm<true, false>(a, b, a_scale, G, group_tiles, ws, bias, out, M, N, K, s);
  }
  return gelu ? launch_gemm<false, true>(a, b, a_scale, G, group_tiles, ws, bias, out, M, N, K, s)
              : launch_gemm<false, false>(a, b, a_scale, G, group_tiles, ws, bias, out, M, N, K, s);
}

extern "C" int ffn_w8a8_gemm1(const void* xq, const void* w0, const void* xs, const void* ws0, const void* b0,
                              void* hq, void* hs, int M, int H, int K, int bh, int kind, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kind ? launch_gemm1_bh<true>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, bh, s)
              : launch_gemm1_bh<false>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, bh, s);
}
