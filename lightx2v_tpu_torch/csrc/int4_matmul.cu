// Weight-only int4 GEMM for Hopper (sm_90a): bf16 activations x nibble-packed
// int4 weights with per-(output channel, group) fp32 scales, bf16 out.
//
// Replaces: lightx2v_tpu/ops/pallas/int4_matmul.py:102 (int4_matmul, whose
//           _int4_kernel is the pallas_call at :131).
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
// of 32,760 tokens) a 5120 x 5120 projection is 3.4e12 bf16 FLOP (3.47 ms at
// 989 TFLOP/s) against 1.4 GB of x, packed w and out (0.4 ms); the FFN GEMMs
// 9.3e12 each. Below the tensor cores sit two other limits: the x tiles that
// every CTA pulls from L2 (a 128-token tile is reused by only 128 weight
// rows) and the instructions that unpack the weights.
//
// What the design does about it: the products run on wgmma, the only path to
// the card's full bf16 rate, with the operands swapped: the CTA computes the
// transposed tile out^T[n, m] = w[n, :] . x[m, :]^T, 128 weight rows by 128
// tokens, as two consumer warpgroups of 64 weight rows that each issue
// wgmma.m64n128k16 with A in registers and B in shared memory.
//  - A, the weights, is the operand that needs converting, and registers are
//    where it is converted: the packed tile sits in shared memory as it came
//    (a quarter of bf16's bytes) and each thread turns its fragment's nibbles
//    into bf16 pairs (nibble | 0x4300 is the bf16 128 + nibble; minus 136
//    gives nibble - 8 exactly, two values per instruction). Thread t of a
//    warp needs columns 2t, 2t+1, 2t+8, 2t+9 of a 16-column k-step for its
//    two rows; for the low-half k-step s of a stage those are packed bytes
//    16s+2t, 16s+2t+1, 16s+2t+8, 16s+2t+9, whose high nibbles are the same
//    columns of the matching high-half k-step. So two 16-bit shared loads per
//    row feed two k-steps in the natural k order, and x needs no permutation.
//  - B, the x tile, is K-major in the 128-byte swizzle (64 bf16 of a token
//    row make one swizzle row), read by the tensor cores through a
//    descriptor; both warpgroups read the same tile.
//  - The scales vary along K, so the wgmma accumulator holds one group: at
//    each group boundary the warpgroup waits for its products
//    (wgmma.wait_group 0), adds the partial times scale[n, g] into a second
//    fp32 accumulator and starts the next group with scale-d 0. A thread
//    owns two weight rows, so that is two scales a thread per group. 64 + 64
//    fp32 registers a thread: a 256-token tile would need 256.
//  - Loads: a producer warpgroup, one thread of which issues TMA copies into
//    a five-stage ring of mbarriers. With 384 threads ptxas caps a thread at
//    168 registers, where the two accumulators and the fragments do not fit,
//    so the producer hands most of its registers to the two consumer
//    warpgroups (setmaxnreg: 40 against 232 a thread). Issuing the copies
//    from a consumer thread instead makes ptxas serialise every wgmma.
//    A stage is 128 columns of one group: two 64-column boxes of x,
//    128B-swizzled, the layout the descriptor reads, and one box of 64
//    packed bytes of 128 weight rows, 64B-swizzled so the fragment loads are
//    conflict-free. TMA zero-fills past M and N. The consumers never meet at
//    a CTA barrier inside the loop, so one warpgroup's group-boundary drain
//    overlaps the other's products. A stage's eight k-steps go out as two
//    batches of four; wgmma.wait_group 1 keeps one batch in flight while the
//    next fragments are unpacked, and each warp hands a stage back to the
//    producer once the batch after its last one has been issued.
//  - The epilogue stages the bf16 tile through shared memory (the ring is
//    free by then) and writes token rows with 16-byte stores.
// Not yet used: clusters with multicast x tiles, persistent CTAs (later work).

#include <cuda.h>
#include <cudaTypedefs.h>

#include "int8_mma.cuh"

namespace {

constexpr int NTHREADS = 384;                       // a producer warpgroup, then two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int BN = 128;                             // weight rows per CTA, 64 per warpgroup
constexpr int BM = 128;                             // tokens per CTA: the wgmma N
constexpr int BKP = 64;                             // packed bytes of a weight row per stage (128 columns)
constexpr int XTILE = BM * 128;                     // one 64-column x box (16 KB)
constexpr int WTILE = BN * BKP;                     // the packed weight box (8 KB)
constexpr int STAGE_BYTES = 2 * XTILE + WTILE;      // 40,960: keeps every box 1024-byte aligned
constexpr int STAGES = 5;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1024 bytes
constexpr int LDO = BN * 2 + 16;                    // epilogue row: 128 bf16 + pad (272 bytes)
static_assert(STAGE_BYTES % 1024 == 0, "swizzle atoms must stay 1024-byte aligned");
static_assert(BM * LDO <= STAGES * STAGE_BYTES, "epilogue tile must fit in the ring");

// two nibbles (0..15) in bytes b0 and b1 of `nib` (selector 0x4140) or b2 and
// b3 (0x4342) -> two bf16 values nibble - 8
__device__ __forceinline__ uint32_t nib2_to_bf16x2(uint32_t nib, uint32_t sel) {
  uint32_t biased = __byte_perm(nib, 0x43434343u, sel);  // bf16 (128 + nibble) twice
  uint32_t off = 0x43084308u;                            // bf16 136 twice
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&biased), *reinterpret_cast<__nv_bfloat162*>(&off));
  return *reinterpret_cast<uint32_t*>(&r);
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused in this layout)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
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
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) = (scale_d ? d : 0) + a (64 x 16 bf16, registers) . b (16 x 128 bf16, descriptor)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// ---- mbarriers and TMA ----
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
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// A fragments of k-steps s = 2h and 2h + 1, low and high half, for this
// thread's weight rows (ra, ra + 8), whose 16-byte chunks sit at chunk
// c ^ swz (the 64-byte swizzle): f[2j] is the low-half k-step 2h + j,
// f[2j + 1] the matching high-half one
__device__ __forceinline__ void unpack_frags(const unsigned char* ra, const unsigned char* rb, int swz, int h, int t,
                                             uint32_t (&f)[4][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int b = (((2 * h + j) ^ swz) << 4) + 2 * t;
    uint32_t wa = __byte_perm(*reinterpret_cast<const uint16_t*>(ra + b), *reinterpret_cast<const uint16_t*>(ra + b + 8),
                              0x5410);
    uint32_t wb = __byte_perm(*reinterpret_cast<const uint16_t*>(rb + b), *reinterpret_cast<const uint16_t*>(rb + b + 8),
                              0x5410);
    uint32_t la = wa & 0x0F0F0F0Fu, ha = (wa >> 4) & 0x0F0F0F0Fu;
    uint32_t lb = wb & 0x0F0F0F0Fu, hb = (wb >> 4) & 0x0F0F0F0Fu;
    // registers: (row, cols 2t..2t+1), (row + 8, same), (row, cols 2t+8..2t+9), (row + 8, same)
    f[2 * j][0] = nib2_to_bf16x2(la, 0x4140);
    f[2 * j][1] = nib2_to_bf16x2(lb, 0x4140);
    f[2 * j][2] = nib2_to_bf16x2(la, 0x4342);
    f[2 * j][3] = nib2_to_bf16x2(lb, 0x4342);
    f[2 * j + 1][0] = nib2_to_bf16x2(ha, 0x4140);
    f[2 * j + 1][1] = nib2_to_bf16x2(hb, 0x4140);
    f[2 * j + 1][2] = nib2_to_bf16x2(ha, 0x4342);
    f[2 * j + 1][3] = nib2_to_bf16x2(hb, 0x4342);
  }
}

// xmap: x (M, K) bf16, boxes of 128 tokens x 64 columns, 128B swizzle;
// wmap: w (N, K/2) bytes, boxes of 128 rows x 64 bytes, 64B swizzle
__global__ void __launch_bounds__(NTHREADS, 1)
    int4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ ws, const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                      int M, int N, int K, int group) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = K / (2 * BKP);
  const int spg = group / (2 * BKP);  // stages per quant group
  const int G = K / group;
  auto stage = [&](int st) { return smem + st * STAGE_BYTES; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < NTHREADS - CONSUMERS) {
    // producer warpgroup: hands most of its registers to the consumers; one
    // thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int half = group >> 1;
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        const int pc0 = kt * BKP;
        const int grp = pc0 / half;
        const int klo = grp * group + (pc0 - grp * half);
        unsigned char* st = stage(s);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load(st, &xmap, &full[s], klo, m0);
        tma_load(st + XTILE, &xmap, &full[s], klo + half, m0);
        tma_load(st + 2 * XTILE, &wmap, &full[s], pc0, n0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x - (NTHREADS - CONSUMERS), lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // this thread's weight rows r0 and r0 + 8 of the tile
  const int na = n0 + r0, nb = na + 8;
  const int swz = (g >> 1) & 3;  // 64B swizzle of rows r0 and r0 + 8

  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) { acc[i] = 0.f; sum[i] = 0.f; }

  // one quant group per outer iteration; acc is touched outside the wgmma
  // only after the group's wait_group 0, so no copy of it lands where a
  // batch is still in flight (ptxas would insert a wait there)
  for (int grp = 0, kt = 0; grp < G; ++grp) {
    const float sa = na < N ? __ldg(ws + (long long)na * G + grp) : 0.f;  // scale[n, g] of rows na and nb
    const float sb = nb < N ? __ldg(ws + (long long)nb * G + grp) : 0.f;
    for (int sg = 0; sg < spg; ++sg, ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const unsigned char* st = stage(s);
      const unsigned char* ra = st + 2 * XTILE + r0 * BKP;
      const uint64_t desc = make_desc(smem_u32(st));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t f[4][4];
        unpack_frags(ra, ra + 8 * BKP, swz, h, t, f);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // k-step 2h + j/2 of the low (j even) or high (j odd) box: +32 bytes a k-step inside the swizzle row
          const uint64_t d = desc + static_cast<uint64_t>(((j & 1) * XTILE + (2 * h + (j >> 1)) * 32) >> 4);
          wgmma_m64n128k16(acc, f[j], d, (sg == 0 && h == 0 && j == 0) ? 0 : 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        // the batch before this one, stage kt - 1's last, is done: hand its slot back
        if (h == 0 && kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
      }
    }
    // the group is done: fold its partial into the sum
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sum[4 * j + 0] = __fadd_rn(sum[4 * j + 0], __fmul_rn(acc[4 * j + 0], sa));
      sum[4 * j + 1] = __fadd_rn(sum[4 * j + 1], __fmul_rn(acc[4 * j + 1], sa));
      sum[4 * j + 2] = __fadd_rn(sum[4 * j + 2], __fmul_rn(acc[4 * j + 2], sb));
      sum[4 * j + 3] = __fadd_rn(sum[4 * j + 3], __fmul_rn(acc[4 * j + 3], sb));
    }
  }
  // both consumer warpgroups are done with the ring (every load has landed)
  asm volatile("fence.proxy.async.shared::cta;\nbar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

  // out = bf16(sum); with a bias, bf16(float(bf16(sum)) + bias). Thread
  // value 4j + e is (row r0 + 8 * (e >> 1), token 8j + 2t + (e & 1)); the
  // tile goes to shared memory as [token][row]
  float ba = 0.f, bb = 0.f;
  if (bias != nullptr) {
    ba = na < N ? __ldg(bias + na) : 0.f;
    bb = nb < N ? __ldg(bias + nb) : 0.f;
  }
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat16 y = __float2bfloat16_rn(sum[4 * j + e]);
      if (bias != nullptr) y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), (e >> 1) ? bb : ba));
      so[(8 * j + 2 * t + (e & 1)) * (LDO / 2) + r0 + 8 * (e >> 1)] = y;
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  const bool vec = (N & 7) == 0;
#pragma unroll
  for (int i = 0; i < (BM * BN / 8) / CONSUMERS; ++i) {
    int c = tid + i * CONSUMERS;
    int r = c >> 4, ch = c & 15;  // token row r, 8-column chunk ch
    int m = m0 + r, n = n0 + ch * 8;
    if (m >= M || n >= N) continue;
    uint4 v = *reinterpret_cast<const uint4*>(smem + r * LDO + ch * 16);
    __nv_bfloat16* dst = out + (long long)m * N + n;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (n + q < N) dst[q] = e[q];
    }
  }
}

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

// a 2-D tensor map of `rows` x `cols` elements (row pitch `pitch` bytes),
// boxes of box_rows x box_cols
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rows, int cols, long long pitch,
              int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = encode_fn();
  if (enc == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  cuuint32_t estr[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// a (M, K) bf16, bp (N, K/2) packed uint8, ws (N, K/group) fp32, bias (N,)
// fp32 or null -> out (M, N) bf16. group % 128 == 0, K % group == 0, N even;
// a and bp 16-byte aligned.
extern "C" int int4_gemm(const void* a, const void* bp, const void* ws, const void* bias, void* out, int M, int N,
                         int K, int group, void* stream) {
  if (M == 0) return 0;
  if (group <= 0 || group % (2 * BKP) || K % group || (N & 1) || (reinterpret_cast<uintptr_t>(a) & 15) ||
      (reinterpret_cast<uintptr_t>(bp) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  if (!make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, M, K, 2LL * K, BM, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, bp, N, K / 2, K / 2, BN, BKP, CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(int4_wgmma_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int4_wgmma_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const float*>(ws), static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), M,
      N, K, group);
  return static_cast<int>(cudaGetLastError());
}
