// SageAttention-style int8-QK flash attention for Hopper (sm_90a), bf16 in /
// bf16 out, head dim 128.
//
// Replaces: lightx2v_tpu/ops/pallas/sage_attention.py:sage_attention
//           (_sage_kernel).
//
// What it computes: q and k are quantized to int8 per token row over the 128
// features (sc = max(absmax, 1e-6) * (1/127), code = clip(rint(x / sc),
// +-127), from the raw bf16 values); the logits are the exact int32 product
// of the codes times (q_sc * scale * log2e) times k_sc, in that order in
// fp32; the softmax runs in the exp2 domain in fp32 with an online max/sum;
// P is rounded to bf16 and P.V runs in bf16 with fp32 accumulation; the
// output is acc / max(l, 1e-30). Keys at or past kv_len are masked by their
// index (the TPU kernel instead subtracts its zero pad rows' mass in closed
// form; the sums are the same).
//
// What bounds it on this card: operations. Self-attention at B=2, 32,760
// tokens, 40 heads is 2*B*N*S^2*D int8 ops (QK^T, 1979 TOP/s peak) plus the
// same count of bf16 FLOP (P.V, 989 TFLOP/s peak) against 0.7 GB of q/k/v/o.
//
// What the design does about it: QK^T runs on the int8 tensor cores
// (mma.sync.m16n8k32.s8.s8.s32, twice the bf16 rate and half the shared
// memory traffic for K), P.V on the bf16 ones (mma.sync.m16n8k16). The row
// quantization is a pre-pass of its own (one warp per token row, codes and
// scales written once: 0.17 GB per tensor at the main shape) so that the
// 256 CTAs that sweep a head's keys do not each re-quantize them; the
// attention kernel then has the flash kernel's shape: a CTA of 8 warps owns
// 128 query rows whose int8 fragments stay in registers, and tiles of 64
// keys (int8 K, its 64 scales, bf16 V) stream through a double-buffered
// cp.async ring. v and o are addressed by strides in the caller's
// (B, S, N, D) layout. Not yet used: wgmma, TMA, warp specialisation.

#include "int8_mma.cuh"

#define NEG_INF (-INFINITY)

namespace {

constexpr int HD = 128;
constexpr int BQ = 128;
constexpr int BKV = 64;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDQ = HD + 16;  // int8 tile row in bytes (144): ldmatrix is conflict-free
constexpr int LDV = HD + 8;   // bf16 tile row in elements (272 bytes)
constexpr int Q_BYTES = BQ * LDQ;
constexpr int QS_BYTES = BQ * 4;
constexpr int K_BYTES = BKV * LDQ;
constexpr int V_BYTES = BKV * LDV * 2;
constexpr int KS_BYTES = BKV * 4;
constexpr int STAGE_BYTES = K_BYTES + V_BYTES + KS_BYTES;
constexpr int SMEM_BYTES = Q_BYTES + QS_BYTES + 2 * STAGE_BYTES;

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// per-token-row quantization: x (B, S, N, 128) bf16 by strides -> codes
// (B, S, N, 128) int8 and scales (B, S, N) fp32, both contiguous. One warp
// per row, four features per lane.

__global__ void __launch_bounds__(NTHREADS) sage_quant_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                                                   int8_t* __restrict__ codes,
                                                                   float* __restrict__ scales, long long rows,
                                                                   int s_len, int n_heads, long long x_b,
                                                                   long long x_s, long long x_n) {
  const long long row = (long long)blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int n = static_cast<int>(row % n_heads);
  const long long bs = row / n_heads;
  const int s = static_cast<int>(bs % s_len);
  const long long b = bs / s_len;
  const __nv_bfloat16* xr = x + b * x_b + s * x_s + n * x_n;
  uint2 u = __ldg(reinterpret_cast<const uint2*>(xr) + lane);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
  float amax = fmaxf(fmaxf(fabsf(f0.x), fabsf(f0.y)), fmaxf(fabsf(f1.x), fabsf(f1.y)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffff, amax, o));
  const float sc = __fmul_rn(fmaxf(amax, 1e-6f), 1.0f / 127.0f);
  char4 c;
  c.x = quant1(f0.x, sc);
  c.y = quant1(f0.y, sc);
  c.z = quant1(f1.x, sc);
  c.w = quant1(f1.y, sc);
  reinterpret_cast<char4*>(codes + row * HD)[lane] = c;
  if (lane == 0) scales[row] = sc;
}

// ---------------------------------------------------------------------------

struct Strides {
  long long v_b, v_s, v_n;
  long long o_b, o_s, o_n;
};

__global__ void __launch_bounds__(NTHREADS, 1)
sage_fwd_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qsc, const int8_t* __restrict__ k8,
                const float* __restrict__ ksc, const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                int n_heads, int sq, int sk, int kv_limit, Strides st, float gain) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem_raw);
  float* Qsc = reinterpret_cast<float*>(smem_raw + Q_BYTES);
  unsigned char* stages = smem_raw + Q_BYTES + QS_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int n = bh % n_heads;

  const long long row_bytes = (long long)n_heads * HD;  // codes: one token of all heads
  const int8_t* qb = q8 + ((long long)b * sq * n_heads + n) * HD;
  const int8_t* kb = k8 + ((long long)b * sk * n_heads + n) * HD;
  const float* qsb = qsc + (long long)b * sq * n_heads + n;
  const float* ksb = ksc + (long long)b * sk * n_heads + n;
  const __nv_bfloat16* vb = v + b * st.v_b + n * st.v_n;
  __nv_bfloat16* ob = o + b * st.o_b + n * st.o_n;

  const int n_tiles = (kv_limit + BKV - 1) / BKV;

  auto load_kv = [&](int t, int buf) {
    unsigned char* base = stages + buf * STAGE_BYTES;
    int8_t* Ks = reinterpret_cast<int8_t*>(base);
    __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(base + K_BYTES);
    float* Kss = reinterpret_cast<float*>(base + K_BYTES + V_BYTES);
    const int r0 = t * BKV;
#pragma unroll
    for (int i = 0; i < (BKV * 8) / NTHREADS; ++i) {
      int c = tid + i * NTHREADS;
      int r = c >> 3, col = (c & 7) * 16;
      int gr = r0 + r;
      bool ok = gr < sk;
      cp_async16(Ks + r * LDQ + col, ok ? kb + gr * row_bytes + col : kb, ok);
    }
#pragma unroll
    for (int i = 0; i < (BKV * 16) / NTHREADS; ++i) {
      int c = tid + i * NTHREADS;
      int r = c >> 4, col = (c & 15) * 8;
      int gr = r0 + r;
      bool ok = gr < sk;
      cp_async16(Vs + r * LDV + col, ok ? vb + gr * st.v_s + col : vb, ok);
    }
    if (tid < BKV) {
      int gr = r0 + tid;
      bool ok = gr < sk;
      cp_async4(Kss + tid, ok ? ksb + (long long)gr * n_heads : ksb, ok);
    }
  };

  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // q codes and their scales (times scale*log2e) for this CTA's 128 rows
#pragma unroll
  for (int i = 0; i < (BQ * 8) / NTHREADS; ++i) {
    int c = tid + i * NTHREADS;
    int r = c >> 3, col = (c & 7) * 16;
    int gr = q0 + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (gr < sq) u = __ldg(reinterpret_cast<const uint4*>(qb + gr * row_bytes + col));
    *reinterpret_cast<uint4*>(Qs + r * LDQ + col) = u;
  }
  if (tid < BQ) {
    int gr = q0 + tid;
    Qsc[tid] = gr < sq ? __fmul_rn(__ldg(qsb + (long long)gr * n_heads), gain) : 0.f;
  }
  __syncthreads();

  uint32_t qf[HD / 32][4];
#pragma unroll
  for (int kk = 0; kk < HD / 32; ++kk) {
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + kk * 32 + (lane >> 4) * 16);
  }
  const int g = lane >> 2;
  const int tq = lane & 3;
  const float qa[2] = {Qsc[warp * 16 + g], Qsc[warp * 16 + g + 8]};

  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    unsigned char* base = stages + buf * STAGE_BYTES;
    const int8_t* Ks = reinterpret_cast<const int8_t*>(base);
    const __nv_bfloat16* Vs = reinterpret_cast<const __nv_bfloat16*>(base + K_BYTES);
    const float* Kss = reinterpret_cast<const float*>(base + K_BYTES + V_BYTES);
    const int key0 = t * BKV;

    // int32 logits of this warp's 16 rows x 64 keys
    int si[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < HD / 32; ++kk) {
#pragma unroll
      for (int jp = 0; jp < BKV / 16; ++jp) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, Ks + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LDQ + kk * 32 + ((lane >> 3) & 1) * 16);
        mma_s8(si[2 * jp], qf[kk], bfr[0], bfr[1]);
        mma_s8(si[2 * jp + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // s = float(si) * (q_sc * scale * log2e) * k_sc, masked by key index
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      const float2 kv2 = *reinterpret_cast<const float2*>(Kss + j * 8 + 2 * tq);
      s[j][0] = __fmul_rn(__fmul_rn(__int2float_rn(si[j][0]), qa[0]), kv2.x);
      s[j][1] = __fmul_rn(__fmul_rn(__int2float_rn(si[j][1]), qa[0]), kv2.y);
      s[j][2] = __fmul_rn(__fmul_rn(__int2float_rn(si[j][2]), qa[1]), kv2.x);
      s[j][3] = __fmul_rn(__fmul_rn(__int2float_rn(si[j][3]), qa[1]), kv2.y);
    }
    if (key0 + BKV > kv_limit) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        int key = key0 + j * 8 + 2 * tq;
        if (key >= kv_limit) { s[j][0] = NEG_INF; s[j][2] = NEG_INF; }
        if (key + 1 >= kv_limit) { s[j][1] = NEG_INF; s[j][3] = NEG_INF; }
      }
    }

    // online softmax (exp2 domain); row g uses s[..][0..1], row g+8 uses [2..3]
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      tmax[0] = fmaxf(tmax[0], fmaxf(s[j][0], s[j][1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], msafe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffff, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffff, tmax[h], 2));
      float m_new = fmaxf(m_run[h], tmax[h]);
      msafe[h] = (m_new == NEG_INF) ? 0.f : m_new;
      alpha[h] = exp2f(m_run[h] - msafe[h]);
      m_run[h] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - msafe[0]);
      s[j][1] = exp2f(s[j][1] - msafe[0]);
      s[j][2] = exp2f(s[j][2] - msafe[1]);
      s[j][3] = exp2f(s[j][3] - msafe[1]);
      psum[0] += s[j][0] + s[j][1];
      psum[1] += s[j][2] + s[j][3];
    }
    l_run[0] = l_run[0] * alpha[0] + psum[0];
    l_run[1] = l_run[1] * alpha[1] + psum[1];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // acc += bf16(P) . V
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, bfr[0], bfr[1]);
        mma_bf16(acc[2 * dp + 1], pa, bfr[2], bfr[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffff, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffff, l_run[h], 2);
    l_run[h] = fmaxf(l_run[h], 1e-30f);
  }
  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int row = row0 + h * 8;
    if (row < sq) {
      __nv_bfloat16* orow = ob + row * st.o_s;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        int col = i * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16x2(acc[i][2 * h] / l_run[h], acc[i][2 * h + 1] / l_run[h]);
      }
    }
  }
}

}  // namespace

// x (batch, s_len, n_heads, 128) bf16 by strides -> codes int8 and scales
// fp32, contiguous in that order of axes
extern "C" int sage_quant_rows(const void* x, void* codes, void* scales, int batch, int s_len, int n_heads,
                               long long x_b, long long x_s, long long x_n, void* stream) {
  const long long rows = (long long)batch * s_len * n_heads;
  if (rows == 0) return 0;
  const long long blocks = (rows + NWARPS - 1) / NWARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sage_quant_rows_kernel<<<static_cast<unsigned>(blocks), NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(codes), static_cast<float*>(scales), rows, s_len,
      n_heads, x_b, x_s, x_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sage_attention_fwd(const void* q8, const void* qsc, const void* k8, const void* ksc, const void* v,
                                  void* o, int batch, int n_heads, int sq, int sk, int kv_limit, long long v_b,
                                  long long v_s, long long v_n, long long o_b, long long o_s, long long o_n,
                                  float gain, void* stream) {
  if (batch == 0 || sq == 0) return 0;
  cudaError_t err = set_smem(sage_fwd_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  Strides st{v_b, v_s, v_n, o_b, o_s, o_n};
  dim3 grid((sq + BQ - 1) / BQ, batch * n_heads);
  sage_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const float*>(qsc), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ksc), static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n_heads,
      sq, sk, kv_limit, st, gain);
  return static_cast<int>(cudaGetLastError());
}
