// The attention body on wgmma + TMA, shared by flash_attention.cu (bf16
// Q.K^T over all keys: flash_wgmma_kernel; over a list of selected key
// superblocks: sparse_wgmma_kernel) and sage_attention.cu (int8 Q.K^T with
// per-row scales: sage_wgmma_kernel). Each kernel is a thin wrapper that
// calls attention_wgmma<D, INT8, SPARSE> with its tensor maps, so the
// producer, the ring, the persistent walk, the S(t) / P.V(t - 1) schedule,
// the softmax and the TMA-store epilogue are one piece of code.
// flash_attention.cu's note describes the design and what the sparse walk
// changes; sage_attention.cu's what the int8 form adds.
//
// The dense forms sweep key tiles 0 .. ceil(kv_limit / 128) of every work
// tile; the sparse form sweeps the tiles of the work tile's KeyList row,
// placed by the producer, which hands each tile's first key and mask limit
// to the consumers in a slot of its stage. Nothing else differs.
//
// Each .cu that includes this file gets its own copy (anonymous namespace).

#pragma once

#include "hopper.cuh"

#define NEG_INF (-INFINITY)

namespace {

constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  u.x = pack_bf16x2(f[0], f[1]);
  u.y = pack_bf16x2(f[2], f[3]);
  u.z = pack_bf16x2(f[4], f[5]);
  u.w = pack_bf16x2(f[6], f[7]);
  return u;
}

#define WG_D64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "    \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_OP8(C, d, o) \
  C(d[o]), C(d[o + 1]), C(d[o + 2]), C(d[o + 3]), C(d[o + 4]), C(d[o + 5]), C(d[o + 6]), C(d[o + 7])
#define WG_OP32(C, d) WG_OP8(C, d, 0), WG_OP8(C, d, 8), WG_OP8(C, d, 16), WG_OP8(C, d, 24)
#define WG_OP64(C, d) WG_OP32(C, d), WG_OP8(C, d, 32), WG_OP8(C, d, 40), WG_OP8(C, d, 48), WG_OP8(C, d, 56)
#define WG_F(x) "+f"(x)
#define WG_R(x) "+r"(x)

// S (64 x 128, fp32) = (scale_d ? S : 0) + A (64 x 16) . B (16 x 128), both
// operands bf16, K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64 ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OP64(WG_F, d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (64 x 128, int32) = (scale_d ? S : 0) + A (64 x 32) . B (32 x 128), both
// operands int8, K-major in shared memory (8-bit wgmma has no transpose)
__device__ __forceinline__ void wgmma_ss_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_D64 ", %64, %65, p;\n"
      "}\n"
      : WG_OP64(WG_R, d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 64, fp32) += A (64 x 16 bf16, registers) . B (16 x 64), B MN-major
// in shared memory (the transpose-B flag)
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_OP32(WG_F, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit, subnormal results flushed to zero
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (SPARSE) The key superblocks a work tile sweeps. Row (shared ? 0 : bh *
// rows) + q0 / bq of the tables (bq % 128 == 0, so a work tile lies in one
// row) names cnt[row] superblocks of bk keys (bk % 64 == 0) in idx[row,
// :cnt[row]], in any order; each is swept as ceil(bk / 128) tiles of 128
// keys, the last masked at the superblock's end.
struct KeyList {
  const int* idx;
  const int* cnt;
  int rows, nnz, bq, bk, shared;
};

// Q and K codes are bf16 (INT8 false) or int8 with one fp32 scale a row
// (INT8 true); V and O are bf16 either way.
template <int D, bool INT8>
struct Dense {
  static_assert(D % (INT8 ? 128 : 64) == 0, "head dim in 128-byte boxes");
  // The 64-wide bf16 instance has a schedule of its own (flash_attention.cu,
  // HEAD DIM 64): at d = 64 a tile's exp2 on the special-function units
  // take as long as its products on the tensor cores, so three consumer
  // warpgroups (a 192-row work tile: a third less K/V read from L2 a FLOP)
  // take turns, each one's softmax under the others' products; every 2^x
  // stays on the special-function unit (a polynomial share on the FMA pipes
  // measured slower). The 128-wide kernels keep theirs.
  static constexpr bool NARROW = D == 64 && !INT8;
  static constexpr int WGS = NARROW ? 3 : 2;       // consumer warpgroups, 64 query rows each
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = 128 + CONSUMERS;  // a producer warpgroup, then the consumers
  // setmaxnreg of a consumer (the producer keeps 24): 24 * 128 + 240 * 256
  // and 24 * 128 + 160 * 384 fit the SM's 65,536
  static constexpr int CONSUMER_REGS = WGS == 2 ? 240 : 160;
  static constexpr int BM = 64 * WGS;              // query rows per work tile
  static constexpr int BN = 128;                   // keys per tile
  static constexpr int STAGES = 2;
  // the consumer warpgroups take turns to issue their products (int8 and
  // the 64-wide bf16 form: the 128-wide bf16 kernel keeps its own measured
  // schedule)
  static constexpr bool PINGPONG = INT8 || NARROW;
  static constexpr int BOX = 128 * 128;    // a K or V box: 128 rows of 128 bytes
  static constexpr int Q_BOX = BM * 128;   // a Q or O box
  static constexpr int QK_COLS = INT8 ? 128 : 64;  // q/k values in a box row
  static constexpr int QK_BOXES = D / QK_COLS;     // boxes of a q or k row
  static constexpr int V_BOXES = D / 64;           // boxes of a v or o row (bf16)
  static constexpr int Q_BYTES = QK_BOXES * Q_BOX;
  static constexpr int O_BYTES = V_BOXES * Q_BOX;
  static constexpr int K_BYTES = QK_BOXES * BOX;   // one K tile
  static constexpr int V_BYTES = V_BOXES * BOX;    // one V tile
  static constexpr int SC_BYTES = INT8 ? BN * 4 : 0;  // a tile's row scales (BM == BN)
  // a Q buffer also stages the work tile's bf16 O
  static constexpr int QBUF = Q_BYTES > O_BYTES ? Q_BYTES : O_BYTES;
  // K, V, then (int8) the key scales, padded so that the next stage stays 1024-aligned
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES + (INT8 ? 1024 : 0);
  // two Q buffers (the next work tile's Q lands while this one's O is
  // stored), the ring, two Q-scale buffers, slack to align to 1024 bytes
  static constexpr int SMEM = 2 * QBUF + STAGES * STAGE_BYTES + 2 * SC_BYTES + 1024;
};

// qmap/kmap: (D, N, S, B) boxes of QK_COLS x 1 x 128 x 1; vmap/omap: the
// same over bf16 (64-column boxes). qsmap/ksmap (INT8 only): the row scales
// (S, B * N), boxes of 128 x 1. lse (B, sq, N) fp32 or null. Work tile w is
// query tile w % n_qt of (batch, head) w / n_qt; CTA c takes w = c,
// c + gridDim.x, ... (SPARSE) kl names each work tile's key superblocks.
template <int D, bool INT8, bool SPARSE = false>
__device__ __forceinline__ void attention_wgmma(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                                const CUtensorMap* vmap, const CUtensorMap* omap,
                                                const CUtensorMap* qsmap, const CUtensorMap* ksmap,
                                                float* __restrict__ lse, int n_heads, int sq, int kv_limit,
                                                float gain, int n_qt, int n_work, KeyList kl = {}) {
  static_assert(!(SPARSE && INT8), "the sparse form is bf16");
  using C = Dense<D, INT8>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full[2], q_ready[2], o_full[2], q_empty[2], k_full[C::STAGES], v_full[C::STAGES],
      k_empty[C::STAGES], v_empty[C::STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto q_buf = [&](int i) { return smem + i * C::QBUF; };
  // K, then V at + K_BYTES, then (int8) the key scales at + K_BYTES + V_BYTES
  auto k_tile = [&](int st) { return smem + 2 * C::QBUF + st * C::STAGE_BYTES; };
  auto q_scales = [&](int i) {
    return reinterpret_cast<float*>(smem + 2 * C::QBUF + C::STAGES * C::STAGE_BYTES + i * C::SC_BYTES);
  };
  const int n_tiles = (kv_limit + C::BN - 1) / C::BN;
  // (SPARSE) the first key and the mask limit of each stage's tile, written
  // by the producer before it arms k_full and read by the consumers once
  // k_full completes (the mbarrier orders the two): the consumers do no
  // table lookup and no tile arithmetic
  __shared__ int2 key_slot[C::STAGES];
  const int tpb = SPARSE ? (kl.bk + C::BN - 1) / C::BN : 1;  // tiles a superblock
  // the table row of work tile w, and its count of key tiles
  auto list_row = [&](int w) {
    return (kl.shared ? 0LL : (long long)(w / n_qt) * kl.rows) + (w % n_qt) * C::BM / kl.bq;
  };
  auto tiles_of = [&](int w) {
    if constexpr (SPARSE)
      return __ldg(kl.cnt + list_row(w)) * tpb;
    else
      return n_tiles;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_ready[i], 3);                  // one arrive per scaling warp
      mbar_init(&o_full[i], C::CONSUMERS / 32);  // one arrive per consumer warp
      mbar_init(&q_empty[i], 1);                  // the storing thread, once O is read
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], C::CONSUMERS / 32);  // one arrive per consumer warp
      mbar_init(&v_empty[s], C::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < C::THREADS - C::CONSUMERS) {
    // producer warpgroup: hands most of its registers to the consumers; one
    // thread keeps the Q buffers and the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int gt = 0;  // key tiles loaded so far, over all work tiles
      for (int it = 0, w = blockIdx.x; w < n_work; ++it, w += gridDim.x) {
        const int qb = it & 1, q0 = (w % n_qt) * C::BM, bh = w / n_qt, b = bh / n_heads, n = bh % n_heads;
        mbar_wait(&q_empty[qb], ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(&q_full[qb], C::Q_BYTES + C::SC_BYTES);
        for (int x = 0; x < C::QK_BOXES; ++x)
          tma_load_4d(q_buf(qb) + x * C::Q_BOX, qmap, &q_full[qb], C::QK_COLS * x, n, q0, b);
        if constexpr (INT8) tma_load(q_scales(qb), qsmap, &q_full[qb], q0, bh);
        const int nt = tiles_of(w);
        // (SPARSE) the list entry of tile t and the tile's place in its superblock
        const int* e = SPARSE ? kl.idx + list_row(w) * kl.nnz : nullptr;
        int sub = 0;
        for (int t = 0; t < nt; ++t, ++gt) {
          const int s = gt % C::STAGES;
          unsigned char* kt = k_tile(s);
          // (SPARSE) the tile's first key and mask limit, looked up before
          // the wait so that the load's latency hides behind it
          int2 tk;
          if constexpr (SPARSE) {
            const int blk = __ldg(e);
            tk = make_int2(blk * kl.bk + sub * C::BN, min(kv_limit, (blk + 1) * kl.bk));
            if (++sub == tpb) {
              sub = 0;
              ++e;
            }
          }
          mbar_wait(&k_empty[s], ((gt / C::STAGES) & 1) ^ 1);
          if constexpr (SPARSE) key_slot[s] = tk;
          mbar_expect_tx(&k_full[s], C::K_BYTES + C::SC_BYTES);
          for (int x = 0; x < C::QK_BOXES; ++x)
            tma_load_4d(kt + x * C::BOX, kmap, &k_full[s], C::QK_COLS * x, n, SPARSE ? tk.x : t * C::BN, b);
          if constexpr (INT8) tma_load(kt + C::K_BYTES + C::V_BYTES, ksmap, &k_full[s], t * C::BN, bh);
          mbar_wait(&v_empty[s], ((gt / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(&v_full[s], C::V_BYTES);
          for (int x = 0; x < C::V_BOXES; ++x)
            tma_load_4d(kt + C::K_BYTES + x * C::BOX, vmap, &v_full[s], 64 * x, n, SPARSE ? tk.x : t * C::BN, b);
        }
      }
    } else if (threadIdx.x >= 32) {
      // warps 1-3: (bf16) q * gain in fp32, re-rounded to bf16, in place once
      // the Q tile lands (elementwise, so the swizzle does not matter); then
      // visible to the tensor cores' reads. Warp 3 then stores the previous
      // work tile's O (staged by the consumers in its Q buffer) and hands
      // that buffer back once it has been read.
      const int lane = threadIdx.x & 31;
      const bool storer = threadIdx.x >= 96;
      auto store = [&](int it, int w) {
        const int qb = it & 1, q0 = (w % n_qt) * C::BM, bh = w / n_qt, b = bh / n_heads, n = bh % n_heads;
        if (lane == 0) {
          mbar_wait(&o_full[qb], (it >> 1) & 1);
          for (int x = 0; x < C::V_BOXES; ++x) tma_store_4d(omap, q_buf(qb) + x * C::Q_BOX, 64 * x, n, q0, b);
          tma_store_wait();
          mbar_arrive(&q_empty[qb]);
        }
        __syncwarp();
      };
      int it = 0;
      for (int w = blockIdx.x; w < n_work; ++it, w += gridDim.x) {
        const int qb = it & 1;
        mbar_wait(&q_full[qb], (it >> 1) & 1);
        if constexpr (!INT8) {
          if (gain != 1.f) {
            for (int i = threadIdx.x - 32; i < C::Q_BYTES / 16; i += 96) {
              uint4* p = reinterpret_cast<uint4*>(q_buf(qb)) + i;
              float f[8];
              unpack8(*p, f);
#pragma unroll
              for (int j = 0; j < 8; ++j) f[j] = __fmul_rn(f[j], gain);
              *p = pack8(f);
            }
            fence_proxy_async();
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&q_ready[qb]);
        if (storer && it > 0) store(it - 1, w - gridDim.x);
      }
      if (storer && it > 0) store(it - 1, blockIdx.x + (it - 1) * gridDim.x);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS) : "memory");
  const int tid = threadIdx.x - (C::THREADS - C::CONSUMERS);
  const int wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rloc = warp * 16 + g;  // this thread's rows rloc and rloc + 8 of its warpgroup's 64

  float o[C::V_BOXES][32];
  float sc[64];
  int si[INT8 ? 64 : 1];  // (int8) the int32 logits, before their scales
  uint32_t pa[C::BN / 16][4];
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
  float qa[2];  // (int8) q_sc * gain of rows rloc and rloc + 8
  // value 4j + e of an accumulator is (row rloc + 8 * (e >> 1), column 8j + 2 * tq + (e & 1))

  // S = q k^T for this warpgroup's 64 rows x 128 keys of stage s: 32 bytes of
  // each row a step (16 bf16 or 32 int8 values), the next box every 4 steps
  auto issue_s = [&](uint32_t qaddr, int s) {
    const uint32_t kaddr = smem_u32(k_tile(s));
#pragma unroll
    for (int kk = 0; kk < C::QK_BOXES * 4; ++kk) {
      const uint32_t qoff = (kk >> 2) * C::Q_BOX + (kk & 3) * 32, koff = (kk >> 2) * C::BOX + (kk & 3) * 32;
      if constexpr (INT8)
        wgmma_ss_m64n128k32_s8(si, make_desc(qaddr + qoff), make_desc(kaddr + koff), kk > 0);
      else
        wgmma_ss_m64n128k16(sc, make_desc(qaddr + qoff), make_desc(kaddr + koff), kk > 0);
    }
    wgmma_commit();
  };
  // S is done: keep its registers in place, and (int8) turn the int32 sums
  // into y = float(s) * k_sc while the stage's key scales are still held;
  // the softmax applies the row's qa = q_sc * gain (> 0) in its FFMA
  auto take_s = [&](int s) {
    if constexpr (INT8) {
      fence_acc(si);
      const float* ks = reinterpret_cast<const float*>(k_tile(s) + C::K_BYTES + C::V_BYTES);
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j) {
        const float2 k2 = *reinterpret_cast<const float2*>(ks + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = __fmul_rn(__int2float_rn(si[4 * j + e]), (e & 1) ? k2.y : k2.x);
      }
    } else {
      fence_acc(sc);
    }
  };
  // O += bf16(P) . V of stage s, 16 keys a step
  auto issue_pv = [&](int s) {
    const uint32_t vaddr = smem_u32(k_tile(s)) + C::K_BYTES;
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk)
#pragma unroll
      for (int x = 0; x < C::V_BOXES; ++x)
        wgmma_rs_m64n64k16_tb(o[x], pa[kk], make_desc(vaddr + x * C::BOX + kk * 16 * 128));
    wgmma_commit();
  };
  // online softmax of the tile at key0 (exp2 domain), in place in sc, keys
  // at or past lim masked; the row's other columns sit in the quad. (int8)
  // The logit is y * qa: its max is qa * max(y), and 2^(logit - m) is
  // ex2(fma(y, qa, -m))
  auto softmax = [&](int key0, int lim) {
    if (key0 + C::BN > lim) {
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j) {
        const int key = key0 + 8 * j + 2 * tq;
        if (key >= lim) { sc[4 * j] = NEG_INF; sc[4 * j + 2] = NEG_INF; }
        if (key + 1 >= lim) { sc[4 * j + 1] = NEG_INF; sc[4 * j + 3] = NEG_INF; }
      }
    }
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j) {
      tmax[0] = fmaxf(tmax[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float msafe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffff, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffff, tmax[h], 2));
      if constexpr (INT8) tmax[h] = __fmul_rn(tmax[h], qa[h]);
      const float m_new = fmaxf(m_run[h], tmax[h]);
      msafe[h] = (m_new == NEG_INF) ? 0.f : m_new;
      alpha[h] = ex2_ftz(m_run[h] - msafe[h]);
      m_run[h] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j) {
      if constexpr (INT8) {
        sc[4 * j] = ex2_ftz(__fmaf_rn(sc[4 * j], qa[0], -msafe[0]));
        sc[4 * j + 1] = ex2_ftz(__fmaf_rn(sc[4 * j + 1], qa[0], -msafe[0]));
        sc[4 * j + 2] = ex2_ftz(__fmaf_rn(sc[4 * j + 2], qa[1], -msafe[1]));
        sc[4 * j + 3] = ex2_ftz(__fmaf_rn(sc[4 * j + 3], qa[1], -msafe[1]));
      } else {
        sc[4 * j] = ex2_ftz(sc[4 * j] - msafe[0]);
        sc[4 * j + 1] = ex2_ftz(sc[4 * j + 1] - msafe[0]);
        sc[4 * j + 2] = ex2_ftz(sc[4 * j + 2] - msafe[1]);
        sc[4 * j + 3] = ex2_ftz(sc[4 * j + 3] - msafe[1]);
      }
      psum[0] += sc[4 * j] + sc[4 * j + 1];
      psum[1] += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_run[0] = l_run[0] * alpha[0] + psum[0];
    l_run[1] = l_run[1] * alpha[1] + psum[1];
  };
  // rescale O (no product that writes it may be in flight) and pack P: the A
  // fragment of step kk is the accumulator's columns 16kk..16kk+15 as they
  // lie. (int8) A warp whose 16 rows kept their maxima (alpha == 1, most
  // tiles once a row has seen a few) skips the rescale: it would multiply by 1
  auto rescale_pack = [&]() {
    bool rescale = true;
    if constexpr (INT8) rescale = __any_sync(0xffffffff, alpha[0] != 1.f || alpha[1] != 1.f);
    if (rescale) {
#pragma unroll
      for (int x = 0; x < C::V_BOXES; ++x)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[x][i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) {
      pa[kk][0] = pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  // this warp is done with the stage's K (or V)
  auto release_k = [&](int s) {
    if (lane == 0) mbar_arrive(&k_empty[s]);
  };
  auto release_v = [&](int s) {
    if (lane == 0) mbar_arrive(&v_empty[s]);
  };
  // (PINGPONG) the warpgroups take turns to issue their products, in the
  // order 0, 1, .., WGS - 1, 0, .., so that one's softmax runs under the
  // others' products: named barrier 1 + wg is met by this warpgroup's
  // bar.sync and the bar.arrive of the warpgroup before it
  auto my_turn = [&]() {
    if constexpr (C::PINGPONG) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto your_turn = [&]() {
    if constexpr (C::PINGPONG)
      asm volatile("bar.arrive %0, 256;\n" ::"r"(C::WGS == 2 ? 2 - wg : (wg + 1) % C::WGS + 1) : "memory");
  };
  if constexpr (C::PINGPONG) {
    if (wg == C::WGS - 1) your_turn();  // the first turn is warpgroup 0's
  }

#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  if constexpr (INT8) {
#pragma unroll
    for (int i = 0; i < 64; ++i) si[i] = 0;
  }
  int gt = 0;  // key tiles consumed so far, over all work tiles
  for (int it = 0, w = blockIdx.x; w < n_work; ++it, w += gridDim.x) {
    const int qb = it & 1, q0 = (w % n_qt) * C::BM, bh = w / n_qt, b = bh / n_heads, n = bh % n_heads;
    unsigned char* qwg = q_buf(qb) + wg * 64 * 128;  // this warpgroup's 64 rows of each Q box
    const uint32_t qaddr = smem_u32(qwg);
    mbar_wait(&q_ready[qb], (it >> 1) & 1);
    if constexpr (INT8) {
      qa[0] = __fmul_rn(q_scales(qb)[wg * 64 + rloc], gain);
      qa[1] = __fmul_rn(q_scales(qb)[wg * 64 + rloc + 8], gain);
    }
#pragma unroll
    for (int x = 0; x < C::V_BOXES; ++x)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[x][i] = 0.f;
    m_run[0] = m_run[1] = NEG_INF;
    l_run[0] = l_run[1] = 0.f;

    const int nt = tiles_of(w);
    if (nt > 0) {
      // the softmax of tile t runs while the tensor cores do P.V of tile t - 1
      auto ph = [](int i) { return static_cast<uint32_t>((i / C::STAGES) & 1); };
      // (SPARSE) the first key and the mask limit of the stage's tile, read
      // before the stage's K is handed back, which frees the slot
      int2 tk;
      {
        const int s = gt % C::STAGES;
        mbar_wait(&k_full[s], ph(gt));
        if constexpr (SPARSE) tk = key_slot[s];
        my_turn();
        wgmma_fence();
        issue_s(qaddr, s);
        your_turn();
        wgmma_wait<0>();
        take_s(s);
        release_k(s);
        if constexpr (SPARSE)
          softmax(tk.x, tk.y);
        else
          softmax(0, kv_limit);
        mbar_wait(&v_full[s], ph(gt));
        rescale_pack();
      }
      for (int t = 1; t < nt; ++t, ++gt) {
        const int sp = gt % C::STAGES, sn = (gt + 1) % C::STAGES;
        mbar_wait(&k_full[sn], ph(gt + 1));
        if constexpr (SPARSE) tk = key_slot[sn];
        my_turn();
        wgmma_fence();
        issue_s(qaddr, sn);
        issue_pv(sp);
        your_turn();
        wgmma_wait<1>();  // S of tile t is done; P.V of tile t - 1 may still run
        take_s(sn);
        release_k(sn);
        if constexpr (SPARSE)
          softmax(tk.x, tk.y);
        else
          softmax(t * C::BN, kv_limit);
        mbar_wait(&v_full[sn], ph(gt + 1));
        wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < C::V_BOXES; ++x) fence_acc(o[x]);
        release_v(sp);
        rescale_pack();
      }
      const int s = gt % C::STAGES;
      my_turn();
      wgmma_fence();
      issue_pv(s);
      your_turn();
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < C::V_BOXES; ++x) fence_acc(o[x]);
      release_v(s);
      ++gt;
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffff, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(0xffffffff, l_run[h], 2);
      l_run[h] = fmaxf(l_run[h], 1e-30f);
    }
    const int row0 = q0 + wg * 64 + rloc;
    if (lse != nullptr && tq == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < sq) lse[((long long)b * sq + row) * n_heads + n] = m_run[h] * LN2 + logf(l_run[h]);
      }
    }
    const float inv[2] = {__frcp_rn(l_run[0]), __frcp_rn(l_run[1])};
    // bf16 O into this warpgroup's rows of its Q buffer (its last S product
    // is done; an int8 Q tile fills only the first box), 128-byte swizzled as
    // the TMA store reads them: 16-byte chunk c of row r sits at chunk
    // c ^ (r % 8), and rloc % 8 == g (conflict-free: the 8 rows of a store
    // hit 8 chunks)
#pragma unroll
    for (int x = 0; x < C::V_BOXES; ++x)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned char* p = qwg + x * C::Q_BOX + (rloc + 8 * h) * 128 + ((j ^ g) << 4) + tq * 4;
          *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(o[x][4 * j + 2 * h] * inv[h], o[x][4 * j + 2 * h + 1] * inv[h]);
        }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&o_full[qb]);  // the storing thread takes it from here
  }
}

// a 4-D map (D, N, rows, B) over a strided (B, rows, N, D) tensor of
// `elem`-byte values, boxes of `box_cols` x 1 x `box_rows` x 1, 128-byte
// swizzle; strides in elements
bool bsnd_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* p, int d, int batch, int rows,
              int n_heads, long long s_b, long long s_s, long long s_n, int box_cols, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n_heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_n * elem), static_cast<cuuint64_t>(s_s * elem),
                                 static_cast<cuuint64_t>(s_b * elem)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1, static_cast<cuuint32_t>(box_rows), 1};
  return make_map(map, type, p, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the same over bf16, 64-column boxes
template <int D>
bool bsnd_map(CUtensorMap* map, const void* p, int batch, int rows, int n_heads, long long s_b, long long s_s,
              long long s_n, int box_rows) {
  return bsnd_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, D, batch, rows, n_heads, s_b, s_s, s_n, 64, box_rows);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

}  // namespace
