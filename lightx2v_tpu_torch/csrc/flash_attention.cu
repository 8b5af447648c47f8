// Flash attention for Hopper (sm_90a), bf16 in / bf16 out, head dim 128.
//
// Replaces: lightx2v_tpu/ops/pallas/flash_attention.py:flash_attention
//           (_flash_bnsd / _flash_body) and :flash_attention_fused_rope
//           (_flash_rope_kernel), and
//           lightx2v_tpu/ops/pallas/block_sparse_attention.py:
//           block_sparse_attention in its per-head form
//           (_bs_kernel_per_head / _bs_body) and its shared-mask form
//           (_bs_kernel), and :flash_attention_with_lse (_flash_kernel_lse).
//           One kernel template: dense with ROPE on or off (optionally
//           writing the row log-sum-exp), or SPARSE.
//
// What bounds it on this card: operations. Self-attention at 32,760 tokens
// x 40 heads does 4*S^2*D*N = 2.2e13 bf16 tensor-core FLOP against 0.35 GB
// of q/k/v/o traffic (63,000 FLOP per byte, far above the H100's ~295), so
// the tensor cores are the limit; cross-attention over 512 keys is at the
// ridge (q and o dominate its bytes).
//
// What the design does about it: every product runs on the tensor cores
// with mma.sync.m16n8k16 (bf16 x bf16 -> fp32). A CTA of 8 warps owns 128
// query rows of one (batch, head) and keeps them in registers as mma
// fragments for the whole key sweep; K/V tiles of 64 keys stream through a
// double-buffered cp.async ring in shared memory (rows padded to 272 bytes
// so ldmatrix is conflict-free), so the next tile's load overlaps this
// tile's math. The softmax is the TPU kernel's: q pre-scaled by
// scale*log2(e) and re-rounded to bf16, fp32 online max/sum in the exp2
// domain, P rounded to bf16 before P.V, output acc/l. Tiles past kv_len
// are skipped (they carry zero mass); the tile that straddles it is masked.
// The ROPE variant rotates q once and each k tile in fp32 right after it
// lands in shared memory, x*[c|c] + roll_half(x)*[-s|s], reading the
// (S_rope, 64) cos/sin tables directly; positions past S_rope keep the
// identity rotation. q/k/v/o are addressed by strides in the caller's
// (B, S, N, D) layout, so no transposed copies are made. Not yet used:
// wgmma, TMA, warp specialisation, persistence (later work).
//
// SPARSE (Sparge self-attention): each (batch*head, bq-row q superblock)
// names cnt selected bk-key superblocks in indices[bh, iq, :cnt], in score
// order, not ascending. A CTA's 128 query rows lie in superblock
// iq = row0 / bq (bq % 128 == 0) and sweep the bk/64 key tiles of each
// selected superblock in list order: a dynamic loop over j < cnt replaces
// the TPU grid's repeat-the-last-index padding, and only selected tiles are
// loaded. The superblock that straddles the sequence end can come at any j,
// so every tile is masked by absolute key index against kv_len, and tiles
// wholly past it contribute nothing. The softmax is the dense kernel's
// (the TPU's _bs_body is the same). Bound: operations, 4 * D * bq * bk per
// selected (head, q-superblock, key-superblock) triple. With sp.shared the
// tables are (rows, nnz) / (rows,) and every (batch, head) reads the same
// row: one flag on the row lookup, no per-head copy of the table (radial
// attention's static mask, lists ascending with a repeated tail that
// j < cnt never reaches).
//
// LSE (flash_attention_with_lse, the two-pass radial and ring building
// block): when lse != nullptr the epilogue also writes, per real query row,
// m * ln2 + log(max(l, 1e-30)) in fp32 at lse[b, row, head] (natural log; m
// is the running max in the exp2 domain). A row whose keys are all masked
// has m = -inf and gets -inf, as the TPU kernel. The TPU kernel removes its
// zero pad rows' mass in closed form ("phantom" mode); here keys are masked
// by absolute index instead, which gives the same sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NEG_INF (-INFINITY)

namespace {

constexpr int HD = 128;
constexpr int BQ = 128;
constexpr int BKV = 64;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = HD + 8;
constexpr int Q_ELEMS = BQ * LDS;
constexpr int KV_ELEMS = BKV * LDS;
constexpr int SMEM_BYTES = (Q_ELEMS + 4 * KV_ELEMS) * 2;

struct Strides {
  long long q_b, q_s, q_n;
  long long k_b, k_s, k_n;
  long long v_b, v_s, v_n;
  long long o_b, o_s, o_n;
};

// block lists, int32: per head idx (B*N, rows, nnz), cnt (B*N, rows); or,
// with shared != 0, one idx (rows, nnz), cnt (rows,) for every (batch, head)
struct Sparse {
  const int* idx;
  const int* cnt;
  int rows, nnz, bq, bk, shared;
};

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

// Rotate one (lo, hi) pair of 8-feature chunks in fp32: lo = x1*c - x2*s,
// hi = x2*c + x1*s, then times gain. Explicit roundings mirror the TPU
// kernel's unfused elementwise order.
__device__ __forceinline__ void rotate_chunk(float (&lo)[8], float (&hi)[8], const float* cos_row,
                                             const float* sin_row, float gain) {
  float c[8], s[8];
  if (cos_row != nullptr) {
    const float4* c4 = reinterpret_cast<const float4*>(cos_row);
    const float4* s4 = reinterpret_cast<const float4*>(sin_row);
    float4 a = __ldg(c4), b = __ldg(c4 + 1), d = __ldg(s4), e = __ldg(s4 + 1);
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w; c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
    s[0] = d.x; s[1] = d.y; s[2] = d.z; s[3] = d.w; s[4] = e.x; s[5] = e.y; s[6] = e.z; s[7] = e.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) { c[i] = 1.f; s[i] = 0.f; }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float x1 = lo[i], x2 = hi[i];
    float r_lo = __fadd_rn(__fmul_rn(x1, c[i]), __fmul_rn(x2, -s[i]));
    float r_hi = __fadd_rn(__fmul_rn(x2, c[i]), __fmul_rn(x1, s[i]));
    lo[i] = __fmul_rn(r_lo, gain);
    hi[i] = __fmul_rn(r_hi, gain);
  }
}

template <bool ROPE, bool SPARSE>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 const float* __restrict__ cos_t, const float* __restrict__ sin_t, int s_rope,
                 int n_heads, int sq, int sk, int kv_limit, Strides st, float gain, Sparse sp,
                 float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* KVs = Qs + Q_ELEMS;  // [buf][K|V]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int n = bh % n_heads;

  const __nv_bfloat16* qb = q + b * st.q_b + n * st.q_n;
  const __nv_bfloat16* kb = k + b * st.k_b + n * st.k_n;
  const __nv_bfloat16* vb = v + b * st.v_b + n * st.v_n;
  __nv_bfloat16* ob = o + b * st.o_b + n * st.o_n;

  // the key tiles this CTA sweeps: t -> first key of tile t
  int n_tiles = (kv_limit + BKV - 1) / BKV;
  const int* blocks = nullptr;
  int tiles_per_blk = 1;
  if (SPARSE) {
    const long long row = (sp.shared ? 0LL : (long long)bh * sp.rows) + q0 / sp.bq;
    blocks = sp.idx + row * sp.nnz;
    tiles_per_blk = sp.bk / BKV;
    n_tiles = __ldg(sp.cnt + row) * tiles_per_blk;
  }
  auto tile_key0 = [&](int t) {
    if (SPARSE) return __ldg(blocks + t / tiles_per_blk) * sp.bk + (t % tiles_per_blk) * BKV;
    return t * BKV;
  };

  auto load_kv = [&](int t, int buf) {
    __nv_bfloat16* Ks = KVs + buf * 2 * KV_ELEMS;
    __nv_bfloat16* Vs = Ks + KV_ELEMS;
    const int r0 = tile_key0(t);
#pragma unroll
    for (int i = 0; i < (BKV * 16) / NTHREADS; ++i) {
      int c = tid + i * NTHREADS;
      int r = c >> 4, col = (c & 15) * 8;
      int gr = r0 + r;
      bool ok = gr < sk;
      const __nv_bfloat16* ks = ok ? kb + gr * st.k_s + col : kb;
      const __nv_bfloat16* vs = ok ? vb + gr * st.v_s + col : vb;
      cp_async16(Ks + r * LDS + col, ks, ok);
      cp_async16(Vs + r * LDS + col, vs, ok);
    }
  };

  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // q tile: scale (and rotate) in fp32, re-round to bf16, park in smem
  if (ROPE) {
#pragma unroll
    for (int i = 0; i < (BQ * 8) / NTHREADS; ++i) {
      int u = tid + i * NTHREADS;
      int r = u >> 3, c8 = (u & 7) * 8;
      int gr = q0 + r;
      float lo[8], hi[8];
      if (gr < sq) {
        unpack8(__ldg(reinterpret_cast<const uint4*>(qb + gr * st.q_s + c8)), lo);
        unpack8(__ldg(reinterpret_cast<const uint4*>(qb + gr * st.q_s + c8 + HD / 2)), hi);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) { lo[j] = 0.f; hi[j] = 0.f; }
      }
      bool tab = gr < s_rope;
      rotate_chunk(lo, hi, tab ? cos_t + (long long)gr * (HD / 2) + c8 : nullptr,
                   tab ? sin_t + (long long)gr * (HD / 2) + c8 : nullptr, gain);
      *reinterpret_cast<uint4*>(Qs + r * LDS + c8) = pack8(lo);
      *reinterpret_cast<uint4*>(Qs + r * LDS + c8 + HD / 2) = pack8(hi);
    }
  } else {
#pragma unroll
    for (int i = 0; i < (BQ * 16) / NTHREADS; ++i) {
      int c = tid + i * NTHREADS;
      int r = c >> 4, col = (c & 15) * 8;
      int gr = q0 + r;
      float f[8];
      if (gr < sq) {
        unpack8(__ldg(reinterpret_cast<const uint4*>(qb + gr * st.q_s + col)), f);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = __fmul_rn(f[j], gain);
      *reinterpret_cast<uint4*>(Qs + r * LDS + col) = pack8(f);
    }
  }
  __syncthreads();

  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + kk * 16 + (lane >> 4) * 8);
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  const int g = lane >> 2;
  const int tq = lane & 3;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    __nv_bfloat16* Ks = KVs + buf * 2 * KV_ELEMS;
    __nv_bfloat16* Vs = Ks + KV_ELEMS;
    const int key0 = tile_key0(t);
    if (ROPE) {
#pragma unroll
      for (int i = 0; i < (BKV * 8) / NTHREADS; ++i) {
        int u = tid + i * NTHREADS;
        int r = u >> 3, c8 = (u & 7) * 8;
        int gr = key0 + r;
        float lo[8], hi[8];
        uint4* plo = reinterpret_cast<uint4*>(Ks + r * LDS + c8);
        uint4* phi = reinterpret_cast<uint4*>(Ks + r * LDS + c8 + HD / 2);
        unpack8(*plo, lo);
        unpack8(*phi, hi);
        bool tab = gr < s_rope;
        rotate_chunk(lo, hi, tab ? cos_t + (long long)gr * (HD / 2) + c8 : nullptr,
                     tab ? sin_t + (long long)gr * (HD / 2) + c8 : nullptr, 1.f);
        *plo = pack8(lo);
        *phi = pack8(hi);
      }
      __syncthreads();
    }

    // S = q k^T for this warp's 16 rows x 64 keys
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < BKV / 16; ++jp) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, Ks + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bfr[2], bfr[3]);
      }
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
        ldmatrix_x4_trans(bfr, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + dp * 16 + (lane >> 4) * 8);
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
      if (lse != nullptr && tq == 0)
        lse[((long long)b * sq + row) * n_heads + n] = m_run[h] * 0.6931471805599453f + logf(l_run[h]);
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

template <bool ROPE, bool SPARSE>
int launch(const void* q, const void* k, const void* v, void* o, const float* cos_t, const float* sin_t,
           int s_rope, int batch, int n_heads, int sq, int sk, int kv_limit, const Strides& st, float gain,
           const Sparse& sp, float* lse, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<ROPE, SPARSE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + BQ - 1) / BQ, batch * n_heads);
  kern<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), cos_t, sin_t, s_rope, n_heads, sq,
      sk, kv_limit, st, gain, sp, lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, const void* cos_t,
                                    const void* sin_t, int s_rope, int batch, int n_heads, int sq, int sk,
                                    int kv_limit, long long q_b, long long q_s, long long q_n, long long k_b,
                                    long long k_s, long long k_n, long long v_b, long long v_s, long long v_n,
                                    long long o_b, long long o_s, long long o_n, float gain, int rope,
                                    void* stream) {
  Strides st{q_b, q_s, q_n, k_b, k_s, k_n, v_b, v_s, v_n, o_b, o_s, o_n};
  Sparse sp{nullptr, nullptr, 0, 0, 1, 1, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rope) {
    return launch<true, false>(q, k, v, o, static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
                               s_rope, batch, n_heads, sq, sk, kv_limit, st, gain, sp, nullptr, s);
  }
  return launch<false, false>(q, k, v, o, nullptr, nullptr, 0, batch, n_heads, sq, sk, kv_limit, st, gain, sp,
                              nullptr, s);
}

// dense attention that also writes lse (batch, sq, n_heads) fp32, contiguous
extern "C" int flash_attention_lse_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                                        int n_heads, int sq, int sk, int kv_limit, long long q_b, long long q_s,
                                        long long q_n, long long k_b, long long k_s, long long k_n, long long v_b,
                                        long long v_s, long long v_n, long long o_b, long long o_s, long long o_n,
                                        float gain, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Strides st{q_b, q_s, q_n, k_b, k_s, k_n, v_b, v_s, v_n, o_b, o_s, o_n};
  Sparse sp{nullptr, nullptr, 0, 0, 1, 1, 0};
  return launch<false, false>(q, k, v, o, nullptr, nullptr, 0, batch, n_heads, sq, sk, kv_limit, st, gain, sp,
                              static_cast<float*>(lse), static_cast<cudaStream_t>(stream));
}

extern "C" int block_sparse_attention_bf16(const void* q, const void* k, const void* v, void* o, const void* idx,
                                           const void* cnt, int shared, int rows, int nnz, int bq, int bk, int batch,
                                           int n_heads, int sq, int sk, long long q_b, long long q_s, long long q_n,
                                           long long k_b, long long k_s, long long k_n, long long v_b, long long v_s,
                                           long long v_n, long long o_b, long long o_s, long long o_n, float gain,
                                           void* stream) {
  if (bq <= 0 || bq % BQ || bk <= 0 || bk % BKV || rows < (sq + bq - 1) / bq)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st{q_b, q_s, q_n, k_b, k_s, k_n, v_b, v_s, v_n, o_b, o_s, o_n};
  Sparse sp{static_cast<const int*>(idx), static_cast<const int*>(cnt), rows, nnz, bq, bk, shared};
  return launch<false, true>(q, k, v, o, nullptr, nullptr, 0, batch, n_heads, sq, sk, sk, st, gain, sp, nullptr,
                             static_cast<cudaStream_t>(stream));
}
