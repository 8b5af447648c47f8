// Weight-only int4 GEMM for Hopper (sm_90a): bf16 activations x nibble-packed
// int4 weights with per-(output channel, group) fp32 scales, bf16 out.
//
// Replaces: lightx2v_tpu/ops/pallas/int4_matmul.py:int4_matmul
//           (_int4_kernel).
//
// What it computes: out[m, n] = bf16( sum_g ( sum_{k in g} x[m, k] * w[n, k] )
// * scale[n, g] ), the inner sum a bf16 x bf16 product with fp32
// accumulation (w's int4 values -8..7 are exact in bf16) and the per-group
// rescale and the sum over groups in fp32. An optional bias is added after
// that first rounding, in fp32, and the sum rounded to bf16 again, as the
// linear layer around the TPU kernel does. Weights arrive as quantize_int4
// writes them: row n of w is K/2 bytes; within each group of `group`
// columns, byte j holds column j in its low nibble and column j + group/2 in
// its high nibble, both stored +8.
//
// What bounds it on this card: operations. At M = 65,520 (two CFG branches
// of 32,760 tokens) a 5120 x 5120 projection is 3.4e12 bf16 FLOP against
// 1.4 GB of x, packed w and out; the FFN GEMMs 9.3e12 each.
//
// What the design does about it: the products run on the bf16 tensor cores
// (mma.sync.m16n8k16). The packed weight tile goes to shared memory as it is
// (a quarter of bf16's bytes) and is never unpacked there: ldmatrix hands
// each thread four packed bytes of one weight row, i.e. four consecutive
// low-half columns and the four matching high-half columns, and the nibbles
// become bf16 pairs in registers (nibble | 0x4300 is the bf16 128 + nibble;
// minus 136 gives nibble - 8 exactly, two values per instruction). The mma's
// k slots are a permutation of the tile's columns (slots 2t, 2t+1, 2t+8,
// 2t+9 of thread t take columns 4t..4t+3), which is free because the x
// fragment is read with the same permutation: one 8-byte shared load of four
// consecutive bf16 per row instead of ldmatrix. A pipeline stage is 64 packed
// bytes of each weight row (128 columns: 64 of the group's low half and the
// matching 64 of its high half) and the two 64-column slices of the x rows,
// three stages deep on cp.async. The scales vary along K, so the fp32 mma
// accumulator holds one group only: after the group's last stage it is
// added, times scale[n, g], into a second fp32 accumulator and cleared.
// Not yet used: wgmma, TMA, warp specialisation, persistence (later work).

#include "int8_mma.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int BM = 128, BN = 128, WN = 4;
constexpr int MT = BM / 2 / 16;   // 4 m-tiles per warp (2 warps down)
constexpr int NT = BN / WN / 8;   // 4 n-tiles per warp (4 warps across)
constexpr int BKP = 64;           // packed bytes of a weight row per stage (128 columns)
constexpr int LDA = BKP * 2 + 32; // x slice row: 64 bf16 + pad (160 bytes): 8-byte fragment loads are conflict-free
constexpr int LDB = BKP + 16;     // packed row + pad (80 bytes): ldmatrix is conflict-free
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 2 * BM * LDA + BN * LDB;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two nibbles (0..15), one in the low byte of each 16-bit half of x -> two
// bf16 values nibble - 8
__device__ __forceinline__ uint32_t nib2_to_bf16x2(uint32_t x) {
  uint32_t biased = x | 0x43004300u;  // bf16 (128 + nibble) twice
  uint32_t off = 0x43084308u;         // bf16 136 twice
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&biased), *reinterpret_cast<__nv_bfloat162*>(&off));
  return *reinterpret_cast<uint32_t*>(&r);
}

// one stage: x rows [m0, m0+BM) at the two 64-column slices of packed chunk
// kt, weight rows [n0, n0+BN) at packed bytes [kt*64, kt*64+64)
__device__ __forceinline__ void load_stage(unsigned char* sAlo, unsigned char* sAhi, unsigned char* sB,
                                           const __nv_bfloat16* __restrict__ A, const uint8_t* __restrict__ Bp, int M,
                                           int N, int K, int group, int m0, int n0, int kt, int tid) {
  const int half = group >> 1;
  const int pc0 = kt * BKP;
  const int g = pc0 / half;
  const int klo = g * group + (pc0 - g * half);
  const int khi = klo + half;
#pragma unroll
  for (int i = 0; i < (BM * 8) / NTHREADS; ++i) {
    int c = tid + i * NTHREADS;
    int r = c >> 3, kc = (c & 7) * 8;  // 8 bf16 = 16 bytes
    bool ok = m0 + r < M;
    const __nv_bfloat16* row = A + (long long)(m0 + r) * K;
    cp_async16(sAlo + r * LDA + kc * 2, ok ? row + klo + kc : A, ok);
    cp_async16(sAhi + r * LDA + kc * 2, ok ? row + khi + kc : A, ok);
  }
#pragma unroll
  for (int i = 0; i < (BN * 4) / NTHREADS; ++i) {
    int c = tid + i * NTHREADS;
    int r = c >> 2, kc = (c & 3) * 16;
    bool ok = n0 + r < N;
    cp_async16(sB + r * LDB + kc, ok ? Bp + (long long)(n0 + r) * (K / 2) + pc0 + kc : Bp, ok);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) int4_gemm_kernel(const __nv_bfloat16* __restrict__ A,
                                                                const uint8_t* __restrict__ Bp,
                                                                const float* __restrict__ ws,
                                                                const float* __restrict__ bias,
                                                                __nv_bfloat16* __restrict__ out, int M, int N, int K,
                                                                int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wr0 = wm * MT * 16, wc0 = wn * NT * 8;
  const int g = lane >> 2, tq = lane & 3;
  const int KT = K / (2 * BKP);
  const int spg = group / (2 * BKP);  // stages per quant group
  const int G = K / group;

  float acc[MT][NT][4];
  float facc[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) { acc[a][b][c] = 0.f; facc[a][b][c] = 0.f; }

  auto sAlo = [&](int st) { return smem + st * STAGE_BYTES; };
  auto sAhi = [&](int st) { return smem + st * STAGE_BYTES + BM * LDA; };
  auto sB = [&](int st) { return smem + st * STAGE_BYTES + 2 * BM * LDA; };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load_stage(sAlo(st), sAhi(st), sB(st), A, Bp, M, N, K, group, m0, n0, st, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    int nk = kt + STAGES - 1;
    if (nk < KT)
      load_stage(sAlo(nk % STAGES), sAhi(nk % STAGES), sB(nk % STAGES), A, Bp, M, N, K, group, m0, n0, nk, tid);
    cp_async_commit();

    const unsigned char* a_lo = sAlo(kt % STAGES);
    const unsigned char* a_hi = sAhi(kt % STAGES);
    const unsigned char* b_s = sB(kt % STAGES);
#pragma unroll
    for (int ks = 0; ks < BKP / 32; ++ks) {
      // packed bytes [ks*32, ks*32+32) of this warp's NT*8 weight rows
      uint32_t bq[NT / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        ldmatrix_x4(bq[np], b_s + (wc0 + np * 16 + (lane & 7) + (lane >> 4) * 8) * LDB + ks * 32 +
                                ((lane >> 3) & 1) * 16);
      }
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {      // 16-byte chunk: 16 low-half and 16 high-half columns
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const unsigned char* sA = hi ? a_hi : a_lo;
          const int col = (ks * 2 + cc) * 16 + 4 * tq;  // this thread's four columns of the slice
          uint32_t af[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint2 r0 = *reinterpret_cast<const uint2*>(sA + (wr0 + mt * 16 + g) * LDA + col * 2);
            uint2 r1 = *reinterpret_cast<const uint2*>(sA + (wr0 + mt * 16 + g + 8) * LDA + col * 2);
            af[mt][0] = r0.x; af[mt][1] = r1.x; af[mt][2] = r0.y; af[mt][3] = r1.y;
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t r = bq[nt >> 1][(nt & 1) * 2 + cc];
            uint32_t nib = (hi ? (r >> 4) : r) & 0x0F0F0F0Fu;
            uint32_t b0 = nib2_to_bf16x2(__byte_perm(nib, 0u, 0x4140));
            uint32_t b1 = nib2_to_bf16x2(__byte_perm(nib, 0u, 0x4342));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
          }
        }
      }
    }

    if ((kt + 1) % spg == 0) {
      const int grp = kt / spg;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int c = n0 + wc0 + nt * 8 + 2 * tq;
        float w0 = c < N ? __ldg(ws + (long long)c * G + grp) : 0.f;
        float w1 = c + 1 < N ? __ldg(ws + (long long)(c + 1) * G + grp) : 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          facc[mt][nt][0] = __fadd_rn(facc[mt][nt][0], __fmul_rn(acc[mt][nt][0], w0));
          facc[mt][nt][1] = __fadd_rn(facc[mt][nt][1], __fmul_rn(acc[mt][nt][1], w1));
          facc[mt][nt][2] = __fadd_rn(facc[mt][nt][2], __fmul_rn(acc[mt][nt][2], w0));
          facc[mt][nt][3] = __fadd_rn(facc[mt][nt][3], __fmul_rn(acc[mt][nt][3], w1));
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();

  // out = bf16(facc); with a bias, bf16(float(bf16(facc)) + bias)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    int c = n0 + wc0 + nt * 8 + 2 * tq;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = c < N ? __ldg(bias + c) : 0.f;
      b1 = c + 1 < N ? __ldg(bias + c + 1) : 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r = m0 + wr0 + mt * 16 + g + h * 8;
        if (r >= M) continue;
        __nv_bfloat162 y = __floats2bfloat162_rn(facc[mt][nt][h * 2], facc[mt][nt][h * 2 + 1]);
        if (bias != nullptr) {
          float2 yf = __bfloat1622float2(y);
          y = __floats2bfloat162_rn(__fadd_rn(yf.x, b0), __fadd_rn(yf.y, b1));
        }
        __nv_bfloat16* orow = out + (long long)r * N;
        if (c + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) = y;
        } else if (c < N) {
          orow[c] = __low2bfloat16(y);
        }
      }
    }
  }
}

}  // namespace

// a (M, K) bf16, bp (N, K/2) packed uint8, ws (N, K/group) fp32, bias (N,)
// fp32 or null -> out (M, N) bf16. group % 128 == 0, K % group == 0, N even.
extern "C" int int4_gemm(const void* a, const void* bp, const void* ws, const void* bias, void* out, int M, int N,
                         int K, int group, void* stream) {
  if (M == 0) return 0;
  if (group <= 0 || group % (2 * BKP) || K % group || (N & 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(int4_gemm_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int4_gemm_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint8_t*>(bp), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), M, N, K, group);
  return static_cast<int>(cudaGetLastError());
}
