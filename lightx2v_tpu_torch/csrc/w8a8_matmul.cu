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
// Quantization: the TPU kernel quantizes x inside the GEMM once per s-block;
// here that is a separate pass (quant_groups_kernel in int8_mma.cuh) that
// writes 8-bit codes and one fp32 scale per row (per (row, k-block) for the
// k-blocked form), so the GEMM reads x once at one byte a value. Rounding
// follows the TPU kernel: scale = max(absmax, 1e-8) * (1/127) or * (1/448);
// int8 codes are clip(rint(x / scale), +-127), e4m3 codes are x / scale
// rounded to nearest even (cvt.rn.satfinite), both with IEEE division.
//
// The GEMM (w8a8_wgmma_kernel, behind the w8a8_gemm entry point: the full-K
// form, the k-blocked form and the FFN's second GEMM, both kinds):
//  - Products run on wgmma.m64nNk32 (.s32.s8.s8 or .f32.e4m3.e4m3), the only
//    path to the card's 8-bit rate. 8-bit wgmma has no transpose, so both
//    operands are K-major in shared memory, as they are stored: A the (M, K)
//    codes, B the weights (N, K).
//  - A CTA is a producer warpgroup and two consumer warpgroups of 64 token
//    rows each (setmaxnreg 24 / 240; at 40 / 232 the folding int8 kernel
//    spilled). One producer thread issues TMA copies (UINT8 tensor maps,
//    boxes of 128 bytes of K by 128 token rows or BN weight rows, 128-byte
//    swizzle: the layout make_desc describes, 8 rows of 128 bytes per
//    1024-byte atom) into a ring of stages with full and empty mbarriers.
//    TMA zero-fills past M, N and K. A stage is 128 values of K, four k32
//    steps; each step moves the descriptors' start 32 bytes inside the
//    swizzle row.
//  - A warpgroup keeps one stage's batch of four products in flight
//    (wgmma.wait_group 1) while it issues the next, and hands a stage back
//    once the batch after it has been issued. The consumers never meet at a
//    barrier inside the loop.
//  - The fold: wgmma cannot scale its accumulator. In the grouped form (G >
//    1: the k-blocked form, the FFN's second GEMM) the warpgroup waits at
//    each group boundary (wgmma.wait_group 0), adds float(acc) *
//    a_scale[row, g] into an fp32 register sum and starts the next group with
//    scale-d 0; the other warpgroup's products run meanwhile. The sum doubles
//    the registers, so the folding kernel's tile is 128 x 192 (m64n192 a
//    warpgroup, 96 + 96 registers a thread, five 40 KB stages). Without a
//    fold (int8 with G = 1: int32 sums are exact) a warpgroup holds m64n256,
//    128 registers, and the tile is 128 x 256 (four 48 KB stages).
//  - What bounds the tile: shared memory. At the full rate a warpgroup's
//    m64nNk32 reads 2 KB of A and N * 32 bytes of B a step and the ring takes
//    the stage's TMA writes: about 127 bytes a clock at 128 x 256, 138 at
//    128 x 192 and 160 at 128 x 128, against the SM's 128. 128 x 128 took
//    1.64 ms where 128 x 256 took 1.33 at the fp8 main shape (one fold at
//    the end), and 128 x 192 beat 128 x 128 by 8-13% at every folding shape;
//    a 2-CTA cluster that multicast the weight tile (a third fewer L2 bytes,
//    the same shared-memory bytes) ran 1.4-1.7x slower (PERF.md).
//  - fp8 accumulation: e4m3 wgmma does not add in full fp32 (the partial
//    sum keeps about 14 bits, truncated), so fp8 partials are promoted into
//    the fp32 sum every FP8_FOLD_K = 256 values of K (8 k32 steps): a fold
//    with scale 1, the row scale applied in the epilogue as without it. The
//    second warpgroup's promotion points sit half an interval later, so the
//    two drain at different times. Measured on an H100 at M = 32,760, N = K
//    = 5120 against the exact sum (tools/w8a8_fold.py), as max |error| over
//    the bar 2^-7 * max |ref|: without promotion 11.6 on one-signed inputs
//    (x = |randn|, positive codes) and 0.88 on signed ones; promoting every
//    2048 / 1024 / 512 / 256 / 128 values, 4.5 / 2.7 / 1.34 / 0.90 / 0.90
//    one-signed and 0.44 signed, where 0.90 is one bf16 ulp of the largest
//    output: the floor. The GEMM takes 1.33 ms without promotion, 1.88 at
//    256 and 2.36 at 128. The FFN's second GEMM (K = 13,824, 27 groups of
//    512) measured 1.38 at 512 and 0.69 at 256 and 128 one-signed.
//  - An earlier form of this GEMM on mma.sync.m16n8k32.e4m3 needed no
//    promotion: sm_90 runs that instruction as two HMMA.16816.F32, which add
//    in full fp32. wgmma does not.
//  - Epilogue: acc * xs * ws + b in fp32 in the TPU order (sum * ws + b after
//    a fold), the optional tanh-GELU, bf16 staged through a 64 x 64 buffer
//    of the warpgroup's own and written with 16-byte stores.
//  - Persistent: one CTA an SM walks the output tiles, weight tile fastest:
//    the CTAs in flight cover a few token tiles, each read from device
//    memory once, and every weight tile, which stay in L2 where they fit
//    (26 MB at N = K = 5120). The ring runs on from tile to tile: the
//    producer loads the next tile's first stages while the consumers store
//    the last one (8% off the int8 GEMM at the main shape; a tie where the
//    kernel folds).
//  - At M = 512 (cross-attention k/v, the UMT5-XXL linears) the grid is 4
//    token tiles by 20 (or 40) weight tiles, fewer CTAs than the 132 SMs:
//    one partial wave, each CTA walking all of K.
//
// The fused FFN cannot keep the TPU's (512, 5120) fp32 accumulator (100 MB
// VMEM there, 227 KB of shared memory here), so it is two GEMMs around an
// 8-bit hidden: ffn_gemm1_kernel's CTA N-tile is exactly one bh-wide hidden
// group (bh = 512 at H = 13,824), so its epilogue can apply *xs*ws0 + b0,
// tanh-GELU in fp32, the per-(token, bh) absmax and the requantization,
// writing 8-bit h and fp32 hs (S, H/bh). The second GEMM is the grouped
// form above with hs as a_scale, then *ws2 + b2. h never exists in fp32 or
// bf16 in device memory; the 8-bit round trip costs ~0.9 GB (~0.27 ms at
// 3.35 TB/s) against a 4.69 ms operation bound. ffn_gemm1_kernel still runs
// mma.sync.m16n8k32 on a 3-stage cp.async ring (rows padded to 80 bytes so
// ldmatrix is conflict-free); on sm_90 its e4m3 product runs at the fp16
// rate (int8_mma.cuh).

#include "hopper.cuh"

namespace {

// fp8 wgmma partials are promoted into the fp32 sum every FP8_FOLD_K values
// of K (the note above)
constexpr int FP8_FOLD_K = 256;

// ---------------------------------------------------------------------------
// wgmma.m64nNk32 on 8-bit operands, both K-major in shared memory:
// d (64 x N) = (scale_d ? d : 0) + a (64 x 32) . b (32 x N)

template <int N>
struct Wgmma8;
template <>
struct Wgmma8<192> {
  __device__ static __forceinline__ void mma(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.f32.e4m3.e4m3 " W8_D96 ", %96, %97, p, 1, 1;\n}\n"
        : W8_OP96(W8_F, d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ static __forceinline__ void mma(int (&d)[96], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 " W8_D96 ", %96, %97, p;\n}\n"
        : W8_OP96(W8_R, d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct Wgmma8<256> {
  __device__ static __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.f32.e4m3.e4m3 " W8_D128 ", %128, %129, p, 1, 1;\n}\n"
        : W8_OP128(W8_F, d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ static __forceinline__ void mma(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " W8_D128 ", %128, %129, p;\n}\n"
        : W8_OP128(W8_R, d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// ---------------------------------------------------------------------------
// out (M, N) bf16 = act( (sum_g float(partial_g) * a_scale[m, g]) * ws[n] + bias[n] ),
// G scale groups of `group` values of K (G = 1: one scale per row). FOLD
// folds every `fold` values of K (a divisor of the group) into an fp32 sum;
// without it the one partial is scaled in the epilogue.

template <bool FOLD>
struct Tile {
  static constexpr int THREADS = 384;  // a producer warpgroup, then two consumer warpgroups
  static constexpr int CONSUMERS = 256;
  static constexpr int BM = 128;               // token rows, 64 per consumer warpgroup
  static constexpr int BN = FOLD ? 192 : 256;  // weight rows: the wgmma N
  static constexpr int BK = 128;               // values (bytes) of K a stage: one swizzle row
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK;
  static constexpr int STAGES = FOLD ? 5 : 4;
  static constexpr int NACC = BN / 2;  // accumulator registers a thread
  static constexpr int EP_LD = 64 * 2 + 16;    // a staged output row: 64 bf16 + pad (conflict-free)
  static constexpr int EP_BYTES = 64 * EP_LD;  // a warpgroup's 64 rows x 64 columns
  // the ring, a staging buffer per consumer warpgroup, slack to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * EP_BYTES + 1024;
  static_assert(STAGE_BYTES % 1024 == 0, "swizzle atoms must stay 1024-byte aligned");
  static_assert(BN % 64 == 0, "the epilogue stages 64 columns at a time");
};

// amap: codes (M, K), boxes of 128 bytes x 128 rows; bmap: w (N, K), boxes
// of 128 bytes x BN rows; both 128B-swizzled. Persistent: CTA c takes
// output tiles c, c + gridDim.x, ..., tile w at token tile w / n_tiles_n and
// weight tile w % n_tiles_n; the ring runs on across tiles, and the producer
// loads the next tile's first stages while the consumers store the last one.
template <bool FP8, bool GELU, bool FOLD>
__global__ void __launch_bounds__(384, 1)
    w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                      const float* __restrict__ a_scale, int G, int group, int fold, const float* __restrict__ ws,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using T = Tile<FOLD>;
  using Acc = typename Codes<FP8>::Acc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[T::STAGES], empty[T::STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int KT = (K + T::BK - 1) / T::BK;
  const int n_tiles_n = (N + T::BN - 1) / T::BN, n_tiles = n_tiles_n * ((M + T::BM - 1) / T::BM);
  auto stage = [&](int s) { return smem + s * T::STAGE_BYTES; };  // the A box, then the B box

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::CONSUMERS / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < T::THREADS - T::CONSUMERS) {
    // producer warpgroup: hands most of its registers to the consumers; one
    // thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int w = blockIdx.x, q = 0; w < n_tiles; w += gridDim.x) {
        const int m0 = w / n_tiles_n * T::BM, n0 = w % n_tiles_n * T::BN;
        for (int kt = 0; kt < KT; ++kt, ++q) {  // q: stages loaded so far, over all tiles
          const int s = q % T::STAGES;
          mbar_wait(&empty[s], ((q / T::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], T::STAGE_BYTES);
          tma_load(stage(s), &amap, &full[s], kt * T::BK, m0);
          tma_load(stage(s) + T::A_BYTES, &bmap, &full[s], kt * T::BK, n0);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x - (T::THREADS - T::CONSUMERS), lane = tid & 31, wg = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = ((tid >> 5) & 3) * 16 + g;  // this thread's rows wrow and wrow + 8 of its warpgroup's 64
  // value 4j + e of an accumulator is (row wrow + 8 * (e >> 1), column 8j + 2t + (e & 1))
  const int tw = tid & 127;
  // 32-bit shared-memory addresses: the ring, this warpgroup's staging buffer
  const uint32_t ring = smem_u32(smem), ep = ring + T::STAGES * T::STAGE_BYTES + wg * T::EP_BYTES;

  Acc acc[T::NACC];
  float sum[T::NACC];  // the fp32 sum of the folds (unused without FOLD)
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0;

  const int group_tiles = G > 1 ? group / T::BK : KT;
  const int fold_tiles = FOLD ? fold / T::BK : KT;
  const int off = (FOLD && FP8 && wg) ? fold_tiles / 2 : 0;
  // q: stages consumed before this tile, over all tiles
  for (int w = blockIdx.x, q = 0; w < n_tiles; w += gridDim.x, q += KT) {
    const int m0 = w / n_tiles_n * T::BM, n0 = w % n_tiles_n * T::BN;
    const int ra = m0 + wg * 64 + wrow, rb = ra + 8;
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) sum[i] = 0.f;

    // one fold interval per outer iteration (all of K without FOLD); acc is
    // touched outside the wgmma only after the interval's wait_group 0. An
    // interval ends at a scale-group boundary or, for fp8, at a promotion
    // point; the second warpgroup's promotion points sit half an interval
    // later, so the two drain and fold at different times.
    for (int f0 = 0, kt = 0; f0 < KT;) {
      const int next_group = (f0 / group_tiles + 1) * group_tiles;
      const int next_promotion = ((f0 + off) / fold_tiles + 1) * fold_tiles - off;
      const int f1 = min(KT, min(next_group, next_promotion));
      for (; kt < f1; ++kt) {
        const int s = (q + kt) % T::STAGES;
        mbar_wait(&full[s], ((q + kt) / T::STAGES) & 1);
        const uint32_t a_addr = ring + s * T::STAGE_BYTES + wg * 64 * T::BK;
        const uint32_t b_addr = ring + s * T::STAGE_BYTES + T::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::BK / 32; ++kk)
          Wgmma8<T::BN>::mma(acc, make_desc(a_addr + kk * 32), make_desc(b_addr + kk * 32),
                             (kk == 0 && kt == f0) ? 0 : 1);
        wgmma_commit();
        wgmma_wait<1>();
        // the batch of stage kt - 1 is done: hand its slot back
        if (kt > f0 && lane == 0) mbar_arrive(&empty[(q + kt - 1) % T::STAGES]);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[(q + kt - 1) % T::STAGES]);
      if constexpr (FOLD) {
        if (G > 1) {  // sum += partial * a_scale[row, g] of the group this interval lies in
          const int grp = f0 / group_tiles;
          const float sa = ra < M ? __ldg(a_scale + (long long)ra * G + grp) : 0.f;
          const float sb = rb < M ? __ldg(a_scale + (long long)rb * G + grp) : 0.f;
#pragma unroll
          for (int j = 0; j < T::NACC / 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sum[4 * j + e] = __fadd_rn(sum[4 * j + e], __fmul_rn(acc_to_float(acc[4 * j + e]), (e >> 1) ? sb : sa));
          }
        } else {  // a promotion: the row scale comes in the epilogue
#pragma unroll
          for (int i = 0; i < T::NACC; ++i) sum[i] = __fadd_rn(sum[i], acc_to_float(acc[i]));
        }
      }
      f0 = f1;
    }
    // y = acc * xs * ws + b (with G > 1, sum * 1 * ws + b), the optional
    // GELU, staged 64 columns at a time in this warpgroup's buffer as [row][column]
    // bf16, then written with 16-byte stores
    const float xa = (FOLD && G > 1) ? 1.f : (ra < M ? __ldg(a_scale + ra) : 0.f);
    const float xb = (FOLD && G > 1) ? 1.f : (rb < M ? __ldg(a_scale + rb) : 0.f);
    const bool vec = (N & 7) == 0;
#pragma unroll
    for (int c0 = 0; c0 < T::BN; c0 += 64) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = c0 / 8 + jj, c = n0 + 8 * j + 2 * t;
        const float w0 = c < N ? __ldg(ws + c) : 0.f, w1 = c + 1 < N ? __ldg(ws + c + 1) : 0.f;
        const float b0 = c < N ? __ldg(bias + c) : 0.f, b1 = c + 1 < N ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const float v0 = __fmul_rn(FOLD ? sum[i] : acc_to_float(acc[i]), h ? xb : xa);
          const float v1 = __fmul_rn(FOLD ? sum[i + 1] : acc_to_float(acc[i + 1]), h ? xb : xa);
          float y0 = __fadd_rn(__fmul_rn(v0, w0), b0), y1 = __fadd_rn(__fmul_rn(v1, w1), b1);
          if (GELU) {
            y0 = gelu_tanh(y0);
            y1 = gelu_tanh(y1);
          }
          const __nv_bfloat162 y = __floats2bfloat162_rn(y0, y1);
          st_shared_b32(ep + (wrow + 8 * h) * T::EP_LD + (8 * jj + 2 * t) * 2, *reinterpret_cast<const uint32_t*>(&y));
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // 64 rows x 8 chunks of 16 bytes
        const int r = (tw >> 3) + 16 * i, ch = tw & 7;
        const int m = m0 + wg * 64 + r, n = n0 + c0 + ch * 8;
        if (m >= M || n >= N) continue;
        const uint4 v = ld_shared_v4(ep + r * T::EP_LD + ch * 16);
        __nv_bfloat16* dst = out + (long long)m * N + n;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (n + k < N) dst[k] = e[k];
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
  }
}

template <bool FP8, bool GELU, bool FOLD>
int launch_gemm(const void* a, const void* b, const void* a_scale, int G, int group, int fold, const void* ws,
                const void* bias, void* out, int M, int N, int K, cudaStream_t s) {
  using T = Tile<FOLD>;
  CUtensorMap amap, bmap;
  if (!make_map_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, M, K, K, T::BM, T::BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&bmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, N, K, K, T::BN, T::BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = w8a8_wgmma_kernel<FP8, GELU, FOLD>;
  cudaError_t err = set_smem(kern, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int sms = 0;  // one CTA an SM
  if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) != cudaSuccess) sms = 132;
  const int tiles = ((N + T::BN - 1) / T::BN) * ((M + T::BM - 1) / T::BM);
  kern<<<min(tiles, sms), T::THREADS, T::SMEM, s>>>(amap, bmap, static_cast<const float*>(a_scale), G, group, fold,
                                         static_cast<const float*>(ws), static_cast<const float*>(bias),
                                         static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool FP8>
int launch_gemm_kind(const void* a, const void* b, const void* a_scale, int G, int group, int fold, const void* ws,
                     const void* bias, void* out, int M, int N, int K, int gelu, cudaStream_t s) {
  if (fold == 0)
    return gelu ? launch_gemm<FP8, true, false>(a, b, a_scale, G, group, 0, ws, bias, out, M, N, K, s)
                : launch_gemm<FP8, false, false>(a, b, a_scale, G, group, 0, ws, bias, out, M, N, K, s);
  return gelu ? launch_gemm<FP8, true, true>(a, b, a_scale, G, group, fold, ws, bias, out, M, N, K, s)
              : launch_gemm<FP8, false, true>(a, b, a_scale, G, group, fold, ws, bias, out, M, N, K, s);
}

// ---------------------------------------------------------------------------
// FFN first GEMM on mma.sync: main loop pieces. A (M, K) and B (N, K) are
// row-major 8-bit codes; the CTA owns rows [m0, m0+BM) of A and [n0, n0+BN)
// of B.

constexpr int NTHREADS = 256;
constexpr int BK = 64;          // bytes of K per pipeline stage
constexpr int LDSB = BK + 16;   // padded smem row (80 bytes)
constexpr int STAGES = 3;

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


}  // namespace

// kind: 0 = int8, 1 = e4m3. Codes are one byte a value either way.
extern "C" int w8a8_quant_groups(int kind, const void* x, void* q, void* scale, int M, int K, int group,
                                 void* stream) {
  return kind ? launch_quant_groups<true>(x, q, scale, M, K, group, stream)
              : launch_quant_groups<false>(x, q, scale, M, K, group, stream);
}

// w8a8_gemm with the fold interval given: `fold` values of K (a multiple of
// 128 dividing the group when G > 1) per fold into the fp32 sum, or 0 for no
// fold (G = 1 only; the 128 x 256 tile). a and b 16-byte aligned, K % 16 == 0.
extern "C" int w8a8_gemm_fold(const void* a, const void* b, const void* a_scale, int G, int group, const void* ws,
                              const void* bias, void* out, int M, int N, int K, int gelu, int kind, int fold,
                              void* stream) {
  if (M == 0) return 0;
  const bool grouped = G > 1;
  if (K <= 0 || K % 16 || (reinterpret_cast<uintptr_t>(a) & 15) || (reinterpret_cast<uintptr_t>(b) & 15) ||
      (grouped && (group % 128 || (long long)G * group != K)) || fold < 0 || fold % 128 ||
      (fold == 0 && grouped) || (grouped && group % fold))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kind ? launch_gemm_kind<true>(a, b, a_scale, G, group, fold, ws, bias, out, M, N, K, gelu, s)
              : launch_gemm_kind<false>(a, b, a_scale, G, group, fold, ws, bias, out, M, N, K, gelu, s);
}

// G scale groups of `group` values along K (G = 1: one scale per row over
// all of K): int8 folds at each group boundary, fp8 also every FP8_FOLD_K
// values.
extern "C" int w8a8_gemm(const void* a, const void* b, const void* a_scale, int G, int group, const void* ws,
                         const void* bias, void* out, int M, int N, int K, int gelu, int kind, void* stream) {
  int fold = G > 1 ? group : 0;
  if (kind && FP8_FOLD_K > 0 && (fold == 0 || fold > FP8_FOLD_K)) fold = FP8_FOLD_K;
  return w8a8_gemm_fold(a, b, a_scale, G, group, ws, bias, out, M, N, K, gelu, kind, fold, stream);
}

extern "C" int ffn_w8a8_gemm1(const void* xq, const void* w0, const void* xs, const void* ws0, const void* b0,
                              void* hq, void* hs, int M, int H, int K, int bh, int kind, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kind ? launch_gemm1_bh<true>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, bh, s)
              : launch_gemm1_bh<false>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, bh, s);
}
