// Flash attention for Hopper (sm_90a), bf16 in / bf16 out, head dim 128:
// three kernels.
//
// Replaces: lightx2v_tpu/ops/pallas/flash_attention.py:flash_attention
//           (_flash_bnsd / _flash_body), :flash_attention_with_lse
//           (_flash_kernel_lse) and :flash_attention_fused_rope
//           (_flash_rope_kernel), and
//           lightx2v_tpu/ops/pallas/block_sparse_attention.py:
//           block_sparse_attention in its per-head form
//           (_bs_kernel_per_head / _bs_body) and its shared-mask form
//           (_bs_kernel).
//  - flash_wgmma_kernel: dense attention, optionally writing the row
//    log-sum-exp (flash_attention, flash_attention_with_lse, and
//    flash_attention_fused_rope after the RoPE pass).
//  - rope_rotate_kernel: the RoPE pass of flash_attention_fused_rope.
//  - sparse_fwd_kernel: block-sparse attention (both forms).
//
// What bounds it on this card: operations. Self-attention at 32,760 tokens
// x 40 heads does 4*S^2*D*N = 2.2e13 bf16 tensor-core FLOP (22.2 ms at 989
// TFLOP/s) against 0.35 GB of q/k/v/o traffic (63,000 FLOP per byte, far
// above the H100's ~295), so the tensor cores are the limit;
// cross-attention over 512 keys is at the ridge (q and o dominate its
// bytes). Under the tensor cores sits the softmax: a 128 x 128 tile's
// 16,384 exp2 take the SM's special-function units about half as long as
// the tile's two products take the tensor cores.
//
// The arithmetic is the TPU kernels': q scaled by scale*log2(e) in fp32 and
// re-rounded to bf16, an exp2 softmax with fp32 online max and sum (a row
// whose keys are all masked so far keeps exponent base 0: `msafe`), P
// rounded to bf16 before P.V, output acc / max(l, 1e-30), lse m*ln2 +
// log(max(l, 1e-30)) in natural log (-inf for a row with no key). Keys at
// or past kv_len are masked by absolute index, and whole tiles past it are
// skipped (they carry no mass); the TPU kernel removes its zero pad rows'
// mass in closed form ("phantom" mode), which gives the same sums. The dense
// kernel takes exp2 as ex2.approx.ftz (a P below 2^-126 becomes 0, as on the
// TPU, which has no subnormals) and the output as acc times the correctly
// rounded 1 / l (within an fp32 ulp of the quotient).
//
// What the dense design does about it (flash_wgmma_kernel, whose body is
// attention_wgmma<D, false> in flash_wgmma.cuh: sage_attention.cu runs the
// same body with an int8 S product, attention_wgmma<128, true>):
//  - Every product runs on wgmma, the only path to the card's full bf16
//    rate. A CTA has a producer warpgroup and two consumer warpgroups of 64
//    query rows each (setmaxnreg 24 / 240: ptxas otherwise caps 384 threads
//    at 168 registers, and a consumer holds S (64 fp32), O (64) and P (32)
//    at once; a 32 / 240 split, 512 registers a lane on each SM
//    sub-partition, never gets its registers and hangs).
//  - Persistent: one CTA an SM walks work tiles of 128 query rows of one
//    (batch, head), consecutive tiles of a head on neighbouring CTAs so that
//    K and V are shared in L2. Two Q buffers: the next tile's Q lands while
//    this one's O is stored.
//  - Producer warp 0, one thread: TMA through 4-D tensor maps (D, N, S, B)
//    over the caller's strided (B, S, N, D) layout, so no transposed copy is
//    made; TMA zero-fills rows past sq and sk and clips the output store at
//    sq. Q arrives as two 64-column boxes (128-byte swizzle), K and V as
//    128-key tiles of two boxes each into a 2-stage ring with a full and an
//    empty barrier for K and for V apart: a K tile is handed back as soon as
//    its S product is done, so the next one loads while P.V runs. 2 x 32 KB
//    of Q + 2 x 64 KB of K/V. Producer warps 1-3 scale each Q tile in place
//    (q * gain in fp32, re-rounded to bf16; skipped when the gain is 1), off
//    the consumers' path: cross-attention runs only 4 key tiles per work
//    tile, so per-tile work weighs there.
//  - S = Q.K^T: per 16-wide d step one wgmma.m64n128k16 with both operands
//    K-major in shared memory (+32 bytes a step inside a swizzle row, the
//    next box every 4 steps).
//  - O += P.V: P stays in registers as the A operand (the m64n128
//    accumulator holds, per thread, exactly the pairs of the A fragment, so
//    P packs to bf16 with no shuffle); V is MN-major (d contiguous in a key
//    row), read with the transpose-B flag, as two m64n64k16 a 16-key step,
//    one per 64-wide d box, so that B spans one swizzle atom along N.
//  - Schedule: a warpgroup issues S of tile t and P.V of tile t - 1
//    together and runs the softmax of tile t while P.V runs
//    (wgmma.wait_group 1, then 0); the two warpgroups overlap each other. O
//    is never touched while a product that writes it is in flight (ptxas
//    would serialise the pipeline). ptxas schedules within a basic block and
//    puts a wgmma wait first in its block: the wait for P.V sits behind the
//    (looping) wait for the next V tile, which ends the softmax's block, or
//    ptxas hoists it above the softmax and nothing overlaps.
//  - The epilogue stages bf16 O in the warpgroup's own Q rows (free once its
//    last S product is done), in the swizzle the TMA store reads, and each
//    consumer warp arrives on a barrier; producer warp 3, between scaling Q
//    tiles, stores the 128 x 128 tile and hands the buffer back once TMA has
//    read it, so no consumer waits on a store (direct 4-byte stores from the
//    fragments measured slower).
//  - A first form (one CTA a work tile, S -> wait -> softmax -> P.V ->
//    wait per tile, the consumers scaling Q and storing O) was replaced by
//    the persistent, pipelined form above.
//
// RoPE (flash_attention_fused_rope) is rotated once per call, not once per
// CTA as the TPU kernel's grid order (b*n, nq, nk) does: rope_rotate_kernel
// writes q' = bf16(rotate(q) * gain) and k' = bf16(rotate(k)) in the
// fp32 operation order of the plain version (x*[c|c] + roll_half(x)*[-s|s],
// explicit roundings; bit-identical to it), positions past S_rope keeping
// the identity rotation, and the dense kernel runs on (q', k', v) with gain
// 1. Rotating every key tile inside each of a head's 256 query-tile CTAs
// cost 36 ms of 112 at the main shape on an H100; the pass moves ~1.3 GB
// once.
//
// SPARSE (Sparge self-attention and radial's shared mask; sparse_fwd_kernel
// on mma.sync.m16n8k16, not yet moved onto wgmma): each (batch*head, bq-row
// q superblock) names cnt selected bk-key superblocks in indices[bh, iq,
// :cnt], in score order, not ascending. A CTA of 8 warps owns 128 query rows
// in superblock iq = row0 / bq (bq % 128 == 0), keeps them in registers as
// mma fragments and sweeps the bk/64 key tiles of each selected superblock
// in list order through a double-buffered cp.async ring (rows padded to 272
// bytes so ldmatrix is conflict-free): a dynamic loop over j < cnt replaces
// the TPU grid's repeat-the-last-index padding, and only selected tiles are
// loaded. The superblock that straddles the sequence end can come at any j,
// so every tile is masked by absolute key index. Bound: operations,
// 4 * D * bq * bk per selected (head, q-superblock, key-superblock) triple.
// With sp.shared the tables are (rows, nnz) / (rows,) and every (batch,
// head) reads the same row (radial attention's static mask, lists ascending
// with a repeated tail that j < cnt never reaches).

#include "flash_wgmma.cuh"

namespace {

constexpr int HD = 128;

// ---------------------------------------------------------------------------
// the RoPE pass

// Rotate one (lo, hi) pair of 8-feature chunks in fp32: lo = x1*c - x2*s,
// hi = x2*c + x1*s, then times gain. Explicit roundings mirror the plain
// version's (and the TPU kernel's) unfused elementwise order.
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

// One block per (batch, position) row, first the batch*sq rows of q, then
// the batch*sk rows of k; a thread takes one head's pair of 8-feature chunks
// (d and d + 64) at a time. Reads q/k by stride, writes q'/k' contiguous.
__global__ void __launch_bounds__(128)
rope_rotate_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const float* __restrict__ cos_t, const float* __restrict__ sin_t, int s_rope, int batch,
                   int n_heads, int sq, int sk, long long q_b, long long q_s, long long q_n, long long k_b,
                   long long k_s, long long k_n, __nv_bfloat16* __restrict__ qo, __nv_bfloat16* __restrict__ ko,
                   float gain) {
  int r = blockIdx.x;
  const bool isq = r < batch * sq;
  if (!isq) r -= batch * sq;
  const int seq = isq ? sq : sk;
  const int b = r / seq, s = r % seq;
  const __nv_bfloat16* src = isq ? q + b * q_b + s * q_s : k + b * k_b + s * k_s;
  const long long sn = isq ? q_n : k_n;
  __nv_bfloat16* dst = (isq ? qo : ko) + (long long)r * n_heads * HD;
  const bool tab = s < s_rope;
  const float g = isq ? gain : 1.f;
  for (int c = threadIdx.x; c < n_heads * 8; c += blockDim.x) {
    const int h = c >> 3, c8 = (c & 7) * 8;
    float lo[8], hi[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(src + h * sn + c8)), lo);
    unpack8(__ldg(reinterpret_cast<const uint4*>(src + h * sn + c8 + HD / 2)), hi);
    rotate_chunk(lo, hi, tab ? cos_t + (long long)s * (HD / 2) + c8 : nullptr,
                 tab ? sin_t + (long long)s * (HD / 2) + c8 : nullptr, g);
    *reinterpret_cast<uint4*>(dst + h * HD + c8) = pack8(lo);
    *reinterpret_cast<uint4*>(dst + h * HD + c8 + HD / 2) = pack8(hi);
  }
}

// ---------------------------------------------------------------------------
// dense attention on wgmma: the body is attention_wgmma in flash_wgmma.cuh

template <int D>
__global__ void __launch_bounds__(Dense<D, false>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                   float* __restrict__ lse, int n_heads, int sq, int kv_limit, float gain, int n_qt, int n_work) {
  attention_wgmma<D, false>(&qmap, &kmap, &vmap, &omap, nullptr, nullptr, lse, n_heads, sq, kv_limit, gain, n_qt,
                            n_work);
}

template <int D>
int launch_dense(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int n_heads, int sq,
                 int sk, int kv_limit, const long long (&st)[12], float gain, cudaStream_t stream) {
  using C = Dense<D, false>;
  if (batch == 0 || n_heads == 0 || sq == 0) return 0;
  CUtensorMap qm, km, vm, om;
  const int rows_k = sk > 0 ? sk : 1;  // no key tile is loaded when sk == 0
  if (!bsnd_map<D>(&qm, q, batch, sq, n_heads, st[0], st[1], st[2], C::BM) ||
      !bsnd_map<D>(&km, k, batch, rows_k, n_heads, st[3], st[4], st[5], C::BN) ||
      !bsnd_map<D>(&vm, v, batch, rows_k, n_heads, st[6], st[7], st[8], C::BN) ||
      !bsnd_map<D>(&om, o, batch, sq, n_heads, st[9], st[10], st[11], C::BM))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (sq + C::BM - 1) / C::BM;
  const long long n_work = (long long)n_qt * batch * n_heads;
  if (n_work > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // persistent: one CTA an SM, each walking work tiles c, c + grid, ...
  const int grid = static_cast<int>(n_work < sm_count() ? n_work : sm_count());
  cudaError_t err = set_smem(flash_wgmma_kernel<D>, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_wgmma_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm, om, lse, n_heads, sq, kv_limit, gain, n_qt,
                                                               static_cast<int>(n_work));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// block-sparse attention on mma.sync

constexpr int SP_BQ = 128;
constexpr int SP_BKV = 64;
constexpr int SP_THREADS = 256;
constexpr int LDS = HD + 8;
constexpr int SP_Q_ELEMS = SP_BQ * LDS;
constexpr int SP_KV_ELEMS = SP_BKV * LDS;
constexpr int SP_SMEM = (SP_Q_ELEMS + 4 * SP_KV_ELEMS) * 2;

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

__global__ void __launch_bounds__(SP_THREADS, 1)
sparse_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int n_heads, int sq, int sk,
                  Strides st, float gain, Sparse sp) {
  extern __shared__ __align__(16) unsigned char sp_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(sp_smem);
  __nv_bfloat16* KVs = Qs + SP_Q_ELEMS;  // [buf][K|V]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * SP_BQ;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int n = bh % n_heads;

  const __nv_bfloat16* qb = q + b * st.q_b + n * st.q_n;
  const __nv_bfloat16* kb = k + b * st.k_b + n * st.k_n;
  const __nv_bfloat16* vb = v + b * st.v_b + n * st.v_n;
  __nv_bfloat16* ob = o + b * st.o_b + n * st.o_n;

  // the key tiles this CTA sweeps: t -> first key of tile t
  const long long brow = (sp.shared ? 0LL : (long long)bh * sp.rows) + q0 / sp.bq;
  const int* blocks = sp.idx + brow * sp.nnz;
  const int tiles_per_blk = sp.bk / SP_BKV;
  const int n_tiles = __ldg(sp.cnt + brow) * tiles_per_blk;
  auto tile_key0 = [&](int t) { return __ldg(blocks + t / tiles_per_blk) * sp.bk + (t % tiles_per_blk) * SP_BKV; };

  auto load_kv = [&](int t, int buf) {
    __nv_bfloat16* Ks = KVs + buf * 2 * SP_KV_ELEMS;
    __nv_bfloat16* Vs = Ks + SP_KV_ELEMS;
    const int r0 = tile_key0(t);
#pragma unroll
    for (int i = 0; i < (SP_BKV * 16) / SP_THREADS; ++i) {
      int c = tid + i * SP_THREADS;
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

  // q tile: scale in fp32, re-round to bf16, park in smem
#pragma unroll
  for (int i = 0; i < (SP_BQ * 16) / SP_THREADS; ++i) {
    int c = tid + i * SP_THREADS;
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

    __nv_bfloat16* Ks = KVs + buf * 2 * SP_KV_ELEMS;
    __nv_bfloat16* Vs = Ks + SP_KV_ELEMS;
    const int key0 = tile_key0(t);

    // S = q k^T for this warp's 16 rows x 64 keys
    float s[SP_BKV / 8][4];
#pragma unroll
    for (int j = 0; j < SP_BKV / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < SP_BKV / 16; ++jp) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, Ks + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    if (key0 + SP_BKV > sk) {
#pragma unroll
      for (int j = 0; j < SP_BKV / 8; ++j) {
        int key = key0 + j * 8 + 2 * tq;
        if (key >= sk) { s[j][0] = NEG_INF; s[j][2] = NEG_INF; }
        if (key + 1 >= sk) { s[j][1] = NEG_INF; s[j][3] = NEG_INF; }
      }
    }

    // online softmax (exp2 domain); row g uses s[..][0..1], row g+8 uses [2..3]
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < SP_BKV / 8; ++j) {
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
    for (int j = 0; j < SP_BKV / 8; ++j) {
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
    for (int kk = 0; kk < SP_BKV / 16; ++kk) {
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

// dense attention; lse (batch, sq, n_heads) fp32 contiguous, or null
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                                    int n_heads, int sq, int sk, int kv_limit, long long q_b, long long q_s,
                                    long long q_n, long long k_b, long long k_s, long long k_n, long long v_b,
                                    long long v_s, long long v_n, long long o_b, long long o_s, long long o_n,
                                    float gain, void* stream) {
  const long long st[12] = {q_b, q_s, q_n, k_b, k_s, k_n, v_b, v_s, v_n, o_b, o_s, o_n};
  return launch_dense<HD>(q, k, v, o, static_cast<float*>(lse), batch, n_heads, sq, sk, kv_limit, st, gain,
                          static_cast<cudaStream_t>(stream));
}

// q (batch, sq, n_heads, 128), k (batch, sk, n_heads, 128) by stride ->
// qo = bf16(rotate(q) * gain), ko = bf16(rotate(k)), both contiguous; the
// (s_rope, 64) fp32 cos/sin tables cover positions below s_rope
extern "C" int rope_rotate_bf16(const void* q, const void* k, const void* cos_t, const void* sin_t, int s_rope,
                                int batch, int n_heads, int sq, int sk, long long q_b, long long q_s, long long q_n,
                                long long k_b, long long k_s, long long k_n, void* qo, void* ko, float gain,
                                void* stream) {
  const long long rows = (long long)batch * (sq + sk);
  if (rows == 0 || n_heads == 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rope_rotate_kernel<<<static_cast<unsigned>(rows), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), s_rope, batch, n_heads, sq, sk, q_b, q_s, q_n, k_b, k_s, k_n,
      static_cast<__nv_bfloat16*>(qo), static_cast<__nv_bfloat16*>(ko), gain);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int block_sparse_attention_bf16(const void* q, const void* k, const void* v, void* o, const void* idx,
                                           const void* cnt, int shared, int rows, int nnz, int bq, int bk, int batch,
                                           int n_heads, int sq, int sk, long long q_b, long long q_s, long long q_n,
                                           long long k_b, long long k_s, long long k_n, long long v_b, long long v_s,
                                           long long v_n, long long o_b, long long o_s, long long o_n, float gain,
                                           void* stream) {
  if (bq <= 0 || bq % SP_BQ || bk <= 0 || bk % SP_BKV || rows < (sq + bq - 1) / bq)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st{q_b, q_s, q_n, k_b, k_s, k_n, v_b, v_s, v_n, o_b, o_s, o_n};
  Sparse sp{static_cast<const int*>(idx), static_cast<const int*>(cnt), rows, nnz, bq, bk, shared};
  cudaError_t err = set_smem(sparse_fwd_kernel, SP_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + SP_BQ - 1) / SP_BQ, batch * n_heads);
  sparse_fwd_kernel<<<grid, SP_THREADS, SP_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n_heads, sq, sk, st, gain, sp);
  return static_cast<int>(cudaGetLastError());
}
