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
// 8-bit hidden. The first (ffn_gemm1_wgmma_kernel) applies *xs*ws0 + b0,
// tanh-GELU in fp32, the per-(token, bh) absmax and the requantization in
// its epilogue, writing 8-bit h and fp32 hs (S, H/bh). The second GEMM is
// the grouped form above with hs as a_scale, then *ws2 + b2. h never exists
// in fp32 or bf16 in device memory; the 8-bit round trip costs ~0.9 GB
// (~0.27 ms at 3.35 TB/s) against a 4.69 ms operation bound.
//
// The first GEMM runs the main loop above (produce_tile / consume_tile, the
// same ring, the fp8 promotion every FP8_FOLD_K) on a (token tile, hidden
// group) unit. A group's absmax needs all bh of a row's hidden values, and
// no CTA holds 128 rows x 512 (int8: m64n256 is 128 accumulator registers a
// thread; fp8: the promotion sum doubles them, so a warpgroup holds at most
// m64n192, which does not divide 512). So a cluster of bh / BN CTAs covers
// one unit: int8 128 x 256 CTAs (bh 512: 2 CTAs; bh 256: 1), fp8 and int8
// at bh = 128 128 x 128 CTAs (fp8 bh 512: 4 CTAs).
//  - Absmax exchange: in wgmma's accumulator layout a row's columns sit in
//    the 4 lanes of a quad, so a row's partial over the CTA's columns takes
//    two shfl_xor. Each quad's first lane writes its two rows' partials into
//    every CTA of the cluster (st.shared::cluster into the slot of its rank)
//    and arrives on that CTA's mbarrier with release at cluster scope; the
//    warpgroup waits on its own barrier (acquire) and takes the max over the
//    ranks. Slots and barriers are per consumer warpgroup (the two
//    warpgroups run up to a ring apart) and per unit parity: a CTA writes
//    unit i + 2's partials only after every peer's unit i + 1 partials
//    arrived, which the peers sent after reading unit i's.
//  - fp8: two accumulators take the promotion intervals in turn
//    (consume_tile's TWO; 64 + 64 + 64 registers at 128 x 128), so a
//    warpgroup folds one interval while the next one's products run and
//    never drains before the unit's end: 5% off the fp8 GEMM1 (PERF.md).
//  - Epilogue: h overwrites the accumulator (or the promotion sum) in place,
//    so no second 128-register array is live; the codes are staged 128
//    columns at a time through the warpgroup's buffer and written with
//    16-byte stores. The TPU order and the port's rounding are kept
//    (__fmul_rn/__fadd_rn, tanhf, Codes<FP8>::pair's IEEE division), so the
//    int8 codes and scales match the mma.sync kernel this one replaced bit
//    for bit (tools/ffn_gemm1_tile.py --parent checks it).
//  - Walk (unit_coords and launch_clusters, hopper.cuh): persistent, one
//    cluster for every bh / BN SMs (cudaOccupancyMaxActiveClusters); unit u
//    lies in a block of GB = 8 groups, token tile outer and group inner
//    inside the block, so the clusters in flight share 8 groups of w0 (21
//    MB at K = 5120) and a few token tiles in L2 where group-fastest order
//    streamed all 71 MB of w0 for every few token tiles. Every CTA of a
//    cluster walks the same units.
//  - The producer warpgroup stays to the end: the kernel ends with a
//    cluster barrier, so no CTA exits while a peer may still write into its
//    shared memory.
//  - Measured on an H100 at M = 32,760, K = 5120, H = 13,824 (PERF.md):
//    int8 4.1-4.4 ms, fp8 6.2-6.6 ms against a 2.34 ms operation bound. A
//    single CTA of 64 tokens x 512 (both warpgroups side by side on the same
//    rows, no cluster; 3 stages of 72 KB) took 5.8-5.9 ms where the int8
//    cluster took 4.5. A tile costs ~20K cycles more than the GEMM's (the
//    GELU, IEEE division and absmax of 128 values a thread, both
//    warpgroups at once); ping-pong warpgroups could hide that only with
//    an operand stream each, at 160 bytes of shared memory a clock.

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
struct Wgmma8<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 " W8_D64 ", %64, %65, p, 1, 1;\n}\n"
        : W8_OP64(W8_F, d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ static __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " W8_D64 ", %64, %65, p;\n}\n"
        : W8_OP64(W8_R, d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
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
// The tile: a producer warpgroup and two consumer warpgroups of 64 token
// rows each, BN weight rows, a ring of STAGES stages of 128 values of K.

template <int BN_, int STAGES_>
struct Tile {
  static constexpr int THREADS = 384;  // a producer warpgroup, then two consumer warpgroups
  static constexpr int CONSUMERS = 256;
  static constexpr int BM = 128;       // token rows, 64 per consumer warpgroup
  static constexpr int BN = BN_;       // weight rows: the wgmma N
  static constexpr int BK = 128;       // values (bytes) of K a stage: one swizzle row
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK;
  static constexpr int STAGES = STAGES_;
  static constexpr int NACC = BN / 2;  // accumulator registers a thread
  // a staged output row: 64 bf16 or 128 8-bit codes, + 16 bytes of pad (conflict-free)
  static constexpr int EP_LD = 128 + 16;
  static constexpr int EP_BYTES = 64 * EP_LD;  // a warpgroup's 64 rows
  // the ring, a staging buffer per consumer warpgroup, slack to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * EP_BYTES + 1024;
  static_assert(STAGE_BYTES % 1024 == 0, "swizzle atoms must stay 1024-byte aligned");
  static_assert(BN % 128 == 0 || BN == 192, "the epilogues stage 64 or 128 columns at a time");
};

// the GEMM's tile: FOLD needs the fp32 sum beside the accumulator, so 192
// weight rows (96 + 96 registers a thread) in five 40 KB stages; without it
// 256 (128 registers) in four 48 KB stages
template <bool FOLD>
using GemmTile = Tile<FOLD ? 192 : 256, FOLD ? 5 : 4>;

// The producer's part of one output tile: all KT stages of the A box at
// token row m0 and the B box at weight row n0 into the ring, after the q
// stages loaded before (over all tiles). Returns q + KT.
template <class T>
__device__ __forceinline__ int produce_tile(const CUtensorMap* amap, const CUtensorMap* bmap, unsigned char* smem,
                                            uint64_t* full, uint64_t* empty, int q, int KT, int m0, int n0) {
  for (int kt = 0; kt < KT; ++kt, ++q) {
    const int s = q % T::STAGES;
    mbar_wait(&empty[s], ((q / T::STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[s], T::STAGE_BYTES);
    tma_load(smem + s * T::STAGE_BYTES, amap, &full[s], kt * T::BK, m0);
    tma_load(smem + s * T::STAGE_BYTES + T::A_BYTES, bmap, &full[s], kt * T::BK, n0);
  }
  return q;
}

// One stage's batch of products on a consumer warpgroup: four k32 steps.
// The first batch of a fold interval starts from scale-d 0, a constant here:
// ptxas then knows that it does not read the accumulator's registers, which
// the epilogue may have written since the last batch (else C7515).
template <class T, bool FIRST, class Acc>
__device__ __forceinline__ void issue_stage(Acc (&acc)[T::NACC], uint32_t a_addr, uint32_t b_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BK / 32; ++kk)
    Wgmma8<T::BN>::mma(acc, make_desc(a_addr + kk * 32), make_desc(b_addr + kk * 32), (FIRST && kk == 0) ? 0 : 1);
  wgmma_commit();
}

// A consumer warpgroup's part of one output tile: the products of all of K
// into acc, after the q stages consumed before (over all tiles). With FOLD,
// sum ends as the fp32 sum of the fold intervals: float(acc) * a_scale[row,
// g] where G > 1 (the group this interval lies in), float(acc) for an fp8
// promotion; without it, acc holds the tile's one partial.
//
// An interval ends at a scale-group boundary or, for fp8, at a promotion
// point; the second warpgroup's promotion points sit `off` stages later, so
// the two fold at different times. With one accumulator (TWO false; acc2
// unused) the warpgroup drains at the end of each interval (wait_group 0)
// and folds, the other warpgroup's products running meanwhile. With TWO, acc
// and acc2 take the intervals in turn: an interval's partial is folded once
// the next interval's first batch is issued, so the warpgroup never drains
// before the tile's end (a third NACC registers).
template <class T, bool FP8, bool FOLD, bool TWO = false>
__device__ __forceinline__ void consume_tile(typename Codes<FP8>::Acc (&acc)[T::NACC],
                                             typename Codes<FP8>::Acc (&acc2)[T::NACC], float (&sum)[T::NACC],
                                             uint32_t ring, uint64_t* full, uint64_t* empty, int q, int KT, int wg,
                                             int lane, int group_tiles, int fold_tiles, int off,
                                             const float* __restrict__ a_scale, int G, int ra, int rb, int M) {
  using Acc = typename Codes<FP8>::Acc;
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) sum[i] = 0.f;
  // the ring slot of stage kt of this tile, once its loads have landed
  auto ready = [&](int kt) {
    const int s = (q + kt) % T::STAGES;
    mbar_wait(&full[s], ((q + kt) / T::STAGES) & 1);
    return ring + s * T::STAGE_BYTES;
  };
  // the batch of stage kt is done: hand its slot back
  auto release = [&](int kt) {
    if (lane == 0) mbar_arrive(&empty[(q + kt) % T::STAGES]);
  };
  auto interval_end = [&](int f0) {
    const int next_group = (f0 / group_tiles + 1) * group_tiles;
    const int next_promotion = ((f0 + off) / fold_tiles + 1) * fold_tiles - off;
    return min(KT, min(next_group, next_promotion));
  };
  // sum += the partial in a of the interval that starts at stage f0
  auto fold = [&](Acc (&a)[T::NACC], int f0) {
    fence_acc(a);
    if constexpr (FOLD) {
      if (G > 1) {  // * a_scale[row, g] of the group this interval lies in
        const int grp = f0 / group_tiles;
        const float sa = ra < M ? __ldg(a_scale + (long long)ra * G + grp) : 0.f;
        const float sb = rb < M ? __ldg(a_scale + (long long)rb * G + grp) : 0.f;
#pragma unroll
        for (int j = 0; j < T::NACC / 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sum[4 * j + e] = __fadd_rn(sum[4 * j + e], __fmul_rn(acc_to_float(a[4 * j + e]), (e >> 1) ? sb : sa));
        }
      } else {  // a promotion: the row scale comes in the epilogue
#pragma unroll
        for (int i = 0; i < T::NACC; ++i) sum[i] = __fadd_rn(sum[i], acc_to_float(a[i]));
      }
    }
  };
  // issues stages f0 .. f1 - 1 into a; `between` runs once the first batch is issued
  auto interval = [&](Acc (&a)[T::NACC], int f0, int f1, auto between) {
    uint32_t st = ready(f0);
    issue_stage<T, true>(a, st + wg * 64 * T::BK, st + T::A_BYTES);
    between();
    for (int kt = f0 + 1; kt < f1; ++kt) {
      st = ready(kt);
      issue_stage<T, false>(a, st + wg * 64 * T::BK, st + T::A_BYTES);
      wgmma_wait<1>();
      release(kt - 1);
    }
  };
  if constexpr (!TWO) {
    for (int f0 = 0; f0 < KT;) {
      const int f1 = interval_end(f0);
      interval(acc, f0, f1, [] {});
      wgmma_wait<0>();
      release(f1 - 1);
      fold(acc, f0);
      f0 = f1;
    }
  } else {
    // the previous interval [p0, p1) sits in one accumulator while the next
    // one's first batch runs in the other
    int p0 = 0, p1 = interval_end(0);
    interval(acc, p0, p1, [] {});
    while (true) {
      if (p1 >= KT) {
        wgmma_wait<0>();
        release(p1 - 1);
        fold(acc, p0);
        break;
      }
      const int n0 = p1, n1 = interval_end(n0);
      interval(acc2, n0, n1, [&] {
        wgmma_wait<1>();
        release(n0 - 1);
        fold(acc, p0);
      });
      if (n1 >= KT) {
        wgmma_wait<0>();
        release(n1 - 1);
        fold(acc2, n0);
        break;
      }
      p0 = n1;
      p1 = interval_end(p0);
      interval(acc, p0, p1, [&] {
        wgmma_wait<1>();
        release(p0 - 1);
        fold(acc2, n0);
      });
    }
  }
}

// ---------------------------------------------------------------------------
// out (M, N) bf16 = act( (sum_g float(partial_g) * a_scale[m, g]) * ws[n] + bias[n] ),
// G scale groups of `group` values of K (G = 1: one scale per row). FOLD
// folds every `fold` values of K (a divisor of the group) into an fp32 sum;
// without it the one partial is scaled in the epilogue.
//
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
  using T = GemmTile<FOLD>;
  using Acc = typename Codes<FP8>::Acc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[T::STAGES], empty[T::STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int KT = (K + T::BK - 1) / T::BK;
  const int n_tiles_n = (N + T::BN - 1) / T::BN, n_tiles = n_tiles_n * ((M + T::BM - 1) / T::BM);

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
      for (int w = blockIdx.x, q = 0; w < n_tiles; w += gridDim.x)
        q = produce_tile<T>(&amap, &bmap, smem, full, empty, q, KT, w / n_tiles_n * T::BM, w % n_tiles_n * T::BN);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x - (T::THREADS - T::CONSUMERS), lane = tid & 31, wg = tid >> 7;
  const int t = lane & 3;
  const int wrow = ((tid >> 5) & 3) * 16 + (lane >> 2);  // this thread's rows wrow and wrow + 8 of its warpgroup's 64
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
    consume_tile<T, FP8, FOLD>(acc, acc, sum, ring, full, empty, q, KT, wg, lane, group_tiles, fold_tiles, off,
                               a_scale, G, ra, rb, M);
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
  using T = GemmTile<FOLD>;
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
// FFN first GEMM: hq (M, H) 8-bit codes and hs (M, H/bh) from
// gelu(float(xq . w0) * xs * ws0 + b0), requantized per (row, bh group). A
// unit is 128 token rows x one bh group, covered by a cluster of bh / BN
// CTAs side by side along the hidden axis (the note at the top).

// int8 (no fold) at bh >= 256: 128 x 256 in four 48 KB stages; fp8 (the
// promotion sum beside the accumulator) and int8 at bh = 128: 128 x 128 in
// six 32 KB stages
template <int BN>
using Gemm1Tile = Tile<BN, BN == 256 ? 4 : 6>;

template <bool FP8, int BN>
__global__ void __launch_bounds__(384, 1)
    ffn_gemm1_wgmma_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                           const float* __restrict__ xs, const float* __restrict__ ws0,
                           const float* __restrict__ b0, uint8_t* __restrict__ hq, float* __restrict__ hs, int M,
                           int H, int K, int bh) {
  using T = Gemm1Tile<BN>;
  constexpr bool FOLD = FP8;  // fp8 promotes into the fp32 sum; int8's int32 sums are exact
  using Acc = typename Codes<FP8>::Acc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[T::STAGES], empty[T::STAGES], xbar[2][2];
  // [unit parity][consumer warpgroup][source rank][quad]: a quad's two rows' partial absmax
  __shared__ float2 xch[2][2][MAX_CLUSTER][32];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int KT = (K + T::BK - 1) / T::BK;
  const int cs = cluster_size(), rank = cluster_rank();
  const int n_mt = (M + T::BM - 1) / T::BM, n_g = H / bh, units = n_mt * n_g;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::CONSUMERS / 32);  // one arrive per consumer warp
    }
    for (int p = 0; p < 2; ++p)
      for (int w = 0; w < 2; ++w) mbar_init(&xbar[p][w], 32 * cs);  // 32 quads of each rank's warpgroup
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every peer's barriers are initialised before anyone arrives on them

  if (threadIdx.x < T::THREADS - T::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int u = cluster_id(), q = 0; u < units; u += cluster_count()) {
        const int2 mg = unit_coords(u, n_mt, n_g);
        q = produce_tile<T>(&amap, &bmap, smem, full, empty, q, KT, mg.x * T::BM, mg.y * bh + rank * BN);
      }
    }
    cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x - (T::THREADS - T::CONSUMERS), lane = tid & 31, wg = tid >> 7;
  const int t = lane & 3, quad = ((tid >> 5) & 3) * 8 + (lane >> 2);
  const int wrow = ((tid >> 5) & 3) * 16 + (lane >> 2);  // this thread's rows wrow and wrow + 8 of its warpgroup's 64
  // value 4j + e of an accumulator is (row wrow + 8 * (e >> 1), column 8j + 2t + (e & 1))
  const int tw = tid & 127;
  const uint32_t ring = smem_u32(smem), ep = ring + T::STAGES * T::STAGE_BYTES + wg * T::EP_BYTES;

  const int fold_tiles = FOLD ? FP8_FOLD_K / T::BK : KT;
  const int off = (FOLD && wg) ? fold_tiles / 2 : 0;
  for (int u = cluster_id(), i = 0; u < units; u += cluster_count(), ++i) {
    // a unit's first product starts with scale-d 0 (a constant, issue_stage),
    // so nothing is carried from the last unit and h may take the
    // accumulator's registers
    Acc acc[T::NACC], acc2[T::NACC];  // acc2: fp8's second accumulator
    float sum[T::NACC];               // fp8: the promotion sum, then h (unused for int8)
    const int2 mg = unit_coords(u, n_mt, n_g);
    const int m0 = mg.x * T::BM, n0 = mg.y * bh + rank * BN;
    const int ra = m0 + wg * 64 + wrow, rb = ra + 8;
    consume_tile<T, FP8, FOLD, FP8>(acc, acc2, sum, ring, full, empty, i * KT, KT, wg, lane, KT, fold_tiles, off, xs,
                                    1, ra, rb, M);

    // h = gelu(acc * xs * ws0 + b0) in place, and the rows' absmax over this CTA's columns
    const float xa = ra < M ? __ldg(xs + ra) : 0.f, xb = rb < M ? __ldg(xs + rb) : 0.f;
    float ma = 0.f, mb = 0.f;
#pragma unroll
    for (int j = 0; j < T::NACC / 4; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      // c is even and ws0, b0 8-byte aligned: one load a pair (with scalar
      // loads the int8 128 x 256 kernel spilled 56 bytes, with these 8)
      const float2 wp = __ldg(reinterpret_cast<const float2*>(ws0 + c)), bp = __ldg(reinterpret_cast<const float2*>(b0 + c));
      const float w[2] = {wp.x, wp.y}, b[2] = {bp.x, bp.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * j + e;
        const float v = FOLD ? sum[k] : acc_to_float(acc[k]);
        const float h = gelu_tanh(__fadd_rn(__fmul_rn(__fmul_rn(v, (e >> 1) ? xb : xa), w[e & 1]), b[e & 1]));
        if constexpr (FOLD) sum[k] = h;
        else acc[k] = __float_as_int(h);
        if (e >> 1) mb = fmaxf(mb, fabsf(h));
        else ma = fmaxf(ma, fabsf(h));
      }
    }
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffff, ma, 1));
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffff, ma, 2));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffff, mb, 1));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffff, mb, 2));
    // the group's absmax: every rank's partials, through each CTA's slots
    const int p = i & 1;
    if (t == 0) {
      const uint32_t slot = smem_u32(&xch[p][wg][rank][quad]), bar = smem_u32(&xbar[p][wg]);
      for (int r = 0; r < cs; ++r) {
        st_cluster_v2(map_rank(slot, r), ma, mb);
        mbar_arrive_cluster(map_rank(bar, r));
      }
    }
    mbar_wait_cluster(&xbar[p][wg], (i >> 1) & 1);
    for (int r = 0; r < cs; ++r) {
      const float2 v = xch[p][wg][r][quad];
      ma = fmaxf(ma, v.x);
      mb = fmaxf(mb, v.y);
    }
    const float sa = __fmul_rn(fmaxf(ma, 1e-8f), Codes<FP8>::INV_MAX);
    const float sb = __fmul_rn(fmaxf(mb, 1e-8f), Codes<FP8>::INV_MAX);
    if (rank == 0 && t == 0) {
      if (ra < M) hs[(long long)ra * n_g + mg.y] = sa;
      if (rb < M) hs[(long long)rb * n_g + mg.y] = sb;
    }
    // the codes, staged 128 columns at a time as [row][column], then 16-byte stores
#pragma unroll
    for (int c0 = 0; c0 < BN; c0 += 128) {
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int k = 4 * (c0 / 8 + jj);
        float h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (FOLD) h[e] = sum[k + e];
          else h[e] = __int_as_float(acc[k + e]);
        }
        st_shared_b16(ep + wrow * T::EP_LD + 8 * jj + 2 * t, Codes<FP8>::pair(h[0], h[1], sa));
        st_shared_b16(ep + (wrow + 8) * T::EP_LD + 8 * jj + 2 * t, Codes<FP8>::pair(h[2], h[3], sb));
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // 64 rows x 8 chunks of 16 bytes
        const int r = (tw >> 3) + 16 * k, ch = tw & 7, m = m0 + wg * 64 + r;
        if (m < M)
          *reinterpret_cast<uint4*>(hq + (long long)m * H + n0 + c0 + ch * 16) = ld_shared_v4(ep + r * T::EP_LD + ch * 16);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still write into its slots
}

template <bool FP8, int BN>
int launch_gemm1(const void* xq, const void* w0, const void* xs, const void* ws0, const void* b0, void* hq,
                 void* hs, int M, int H, int K, int bh, cudaStream_t s) {
  using T = Gemm1Tile<BN>;
  CUtensorMap amap, bmap;
  if (!make_map_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, K, T::BM, T::BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&bmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w0, H, K, K, BN, T::BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ffn_gemm1_wgmma_kernel<FP8, BN>;
  const int cs = bh / BN;
  static int max_clusters[MAX_CLUSTER + 1] = {};  // by cluster size: one CTA an SM
  const int units = ((M + T::BM - 1) / T::BM) * (H / bh);
  return static_cast<int>(launch_clusters(kern, max_clusters[cs], T::THREADS, T::SMEM, cs, units, s, amap, bmap,
                                          static_cast<const float*>(xs), static_cast<const float*>(ws0),
                                          static_cast<const float*>(b0), static_cast<uint8_t*>(hq),
                                          static_cast<float*>(hs), M, H, K, bh));
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

// The FFN's first GEMM. bh is 512, 256 or 128 and divides H; xq, w0 and hq
// 16-byte aligned, K % 16 == 0 (TMA's row pitch); ws0 and b0 8-byte aligned.
extern "C" int ffn_w8a8_gemm1(const void* xq, const void* w0, const void* xs, const void* ws0, const void* b0,
                              void* hq, void* hs, int M, int H, int K, int bh, int kind, void* stream) {
  if (M == 0) return 0;
  const uintptr_t a16 = reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(w0) | reinterpret_cast<uintptr_t>(hq);
  const uintptr_t a8 = reinterpret_cast<uintptr_t>(ws0) | reinterpret_cast<uintptr_t>(b0);
  if (K <= 0 || K % 16 || (bh != 512 && bh != 256 && bh != 128) || H <= 0 || H % bh || (a16 & 15) || (a8 & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind) return launch_gemm1<true, 128>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, bh, s);
  return bh == 128 ? launch_gemm1<false, 128>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, bh, s)
                   : launch_gemm1<false, 256>(xq, w0, xs, ws0, b0, hq, hs, M, H, K, bh, s);
}
