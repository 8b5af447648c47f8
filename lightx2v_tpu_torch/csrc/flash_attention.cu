// Flash attention for Hopper (sm_90a), bf16 in / bf16 out, head dim 128
// (and 64 for the dense kernel, with a schedule of its own: HEAD DIM 64
// below): three kernels.
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
//  - sparse_wgmma_kernel: block-sparse attention (both forms), the same
//    body walking each work tile's list of selected key superblocks.
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
// same body with an int8 S product, attention_wgmma<128, true>, and the
// sparse kernel below with a key list, attention_wgmma<128, false, true>):
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
// HEAD DIM 64 (flash_attention_bf16 at head_dim 64: flash_wgmma_kernel<64>,
// CogVideoX's 48 heads of 64 over its joint [text; video] stream). One
// 64-column box a row of q, k, v and o: the S product takes 4 k-steps of 16
// instead of 8, P.V one m64n64 product a 16-key step into a 64 x 64 O
// accumulator a warpgroup, and O is staged through the one box of the
// warpgroup's Q rows.
//  - What bounds it: halving d halves the tensor-core work a key but not
//    the softmax's. A 128 x 128 tile costs ~1,024 SM clocks on the tensor
//    cores and its 16,384 exp2 ~1,024 on the special-function units (16 a
//    clock an SM): at 45,106 tokens x 96 (batch, head) pairs, 5.0e13 FLOP
//    (51 ms at 989 TFLOP/s) against 1.95e11 exp2 (47 ms at 16 a clock on
//    132 SMs at 1,980 MHz). So the two units must run at once, and a tile's
//    fixed costs (the max shuffles, alpha, the barrier round trips, the
//    wgmma commit and wait latencies) weigh twice what they do at 128. K
//    and V (11.5 MB a head) stream from L2 once per work tile.
//  - The schedule (Dense<64, false>, NARROW): three consumer warpgroups of
//    64 query rows, a 192-row work tile, 512 threads, setmaxnreg 24 / 160
//    (a consumer holds S, 64 fp32, P, 32, and O, 32, at once). They take
//    turns round-robin to issue S of tile t with P.V of tile t - 1 (named
//    barrier 1 + wg, met by the warpgroup's bar.sync and its predecessor's
//    bar.arrive), so that each one's softmax runs under the other two's
//    products instead of beside them. The 192-row tile cuts K/V's L2 reads
//    a FLOP by a third (~255 GB a call against ~383) and spreads each key
//    tile's fixed costs over 1.5x the rows. Shared memory: 2 x 24 KB of Q +
//    2 x 32 KB of K/V. The main shape ends in a 178-row work tile (45,106 =
//    234 x 192 + 178) and a 50-key tile.
//  - Measured (NVIDIA H100 80GB HBM3, 700 W; tools/flash_compare.py, each
//    call in turns with the parent): the parent (the 128 design at 64: two
//    warpgroups side by side, 128-row tiles) 123.5-124.6 ms, SDPA
//    120.1-121.8 in the same calls. Step A, the two warpgroups taking turns
//    (with a 4-stage ring and O's rescale skipped where a warp's maxima
//    held): 105.5-106.2. Step B, three warpgroups and 192 rows (the same
//    extras): 97.2-99.1. B with the parent's 2-stage ring and unconditional
//    rescale, kept: 95.7-95.9 (0.77x the parent; 53% of the tensor bound);
//    the 4-stage ring alone 97.2-97.6, the rescale skip alone 96.8-97.0. B
//    without the turns was 16% slower than B in one call (a card throttled
//    to 1.1-1.6 GHz, where the parent took 138-172 ms).
//  - Tried and dropped, step C: 2^x of a share of each tile's logits on the
//    FMA pipes. x clamped at -127 split into j = floor(x) (an add rounding
//    down onto 1.5 * 2^23) and f in [0, 1), 2^f = 1 + f (0.6951173 + f
//    (0.22764353 + f 0.07706803)) (8.6e-5 relative against 2^x, from a
//    float64 emulation of its fp32 steps), times 2^j from j's bits, which is
//    +0 below -126. With 2, 3, 4 and 6 of a row's 16 column groups on the
//    polynomial, the kernel took 100.7-101.9, 103.5-104.4, 103.8-105.3 and
//    111.8-112.0 ms against B's 97.2-99.1 in the same call: MUFU is not the
//    wall (the exp2 bound is 49% of ~96 ms), and the ~9 instructions an
//    element cost the issue slots more than they free on MUFU. A 192-key
//    tile does not fit: S (96), P (48) and O (32) pass a consumer's 160
//    registers at three warpgroups.
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
// SPARSE (Sparge self-attention per head, radial's mask shared by every
// head; sparse_wgmma_kernel = attention_wgmma<128, false, true>): each
// (batch*head, bq-row q superblock) names cnt selected bk-key superblocks
// in indices[bh, iq, :cnt] (bq % 128 == 0, bk % 64 == 0), in score order,
// not ascending; with `shared` the tables are (rows, nnz) / (rows,) and
// every (batch, head) reads the same row (radial's static mask, lists
// ascending with a repeated tail that j < cnt never reaches). Bound:
// operations, 4 * D per (query row, selected key below S), the same count
// of bf16 FLOP as the dense kernel over the selected key pairs only; the
// bytes (q, k, v, o once, the tables) are the dense call's.
//  - What the sparse walk changes, and nothing else: a work tile (128 query
//    rows, one table row iq = q0 / bq) sweeps cnt * tpb key tiles (tpb =
//    ceil(bk / 128)), tile t at key idx[row][t / tpb] * bk + (t % tpb) *
//    128, in list order, instead of tiles 0 .. ceil(S / 128). A dynamic
//    count replaces the TPU grid's repeat-the-last-index padding, and only
//    selected tiles are loaded. The producer thread reads the table (each
//    tile's block index before it waits for the stage, so the load hides
//    behind the wait) and writes the stage's first key and mask limit into
//    two 4-byte slots before it arms the stage's k_full; the consumers read
//    the pair once k_full completes, before they hand K back. Chosen over
//    each consumer reading the table itself: it keeps the lookup and the
//    tile arithmetic (counters, no division) off the 256 consumer threads'
//    path. Both sides read the work tile's count from the table, so they
//    agree on the ring's phases tile for tile.
//  - The mask: every tile is masked by absolute key index against
//    min(S, superblock end). The superblock end matters only when bk % 128
//    == 64 (the half tile): the last 128-key tile of such a superblock
//    covers 64 keys of the next superblock, which were not selected (or
//    lie past S, where TMA zero-fills), and the mask gives them no mass. A
//    tile wholly past S carries none either, and a row with count 0
//    sweeps no tile and stores zeros (acc 0 times 1 / max(0, 1e-30)).
//  - The walk is the dense kernel's static stride: consecutive query tiles
//    of one (batch, head) on neighbouring CTAs. A 2048-row Sparge
//    superblock puts 16 work tiles on the same key list, so K and V come
//    from L2. Work tiles cost cnt * tpb key tiles each, and a CTA's share
//    averages over the ~78 work tiles it walks at the flagship shape.
//  - The first S of a work tile and its last P.V overlap nothing, as in the
//    dense kernel: at 8 key tiles (the flagship's sparsest rows) that
//    weighs more than at the dense self-attention's 256.

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

// the tensor maps of a bf16 launch over q, k, v, o (strides st: q_b, q_s,
// q_n, then k's, v's and o's) and its persistent grid: one CTA an SM, each
// walking work tiles c, c + grid, ...
struct Launch {
  CUtensorMap q, k, v, o;
  int grid, n_qt, n_work;
};

template <int D>
cudaError_t plan(Launch& l, const void* q, const void* k, const void* v, void* o, int batch, int n_heads, int sq,
                 int sk, const long long (&st)[12]) {
  using C = Dense<D, false>;
  const int rows_k = sk > 0 ? sk : 1;  // no key tile is loaded when sk == 0
  if (!bsnd_map<D>(&l.q, q, batch, sq, n_heads, st[0], st[1], st[2], C::BM) ||
      !bsnd_map<D>(&l.k, k, batch, rows_k, n_heads, st[3], st[4], st[5], C::BN) ||
      !bsnd_map<D>(&l.v, v, batch, rows_k, n_heads, st[6], st[7], st[8], C::BN) ||
      !bsnd_map<D>(&l.o, o, batch, sq, n_heads, st[9], st[10], st[11], C::BM))
    return cudaErrorInvalidValue;
  l.n_qt = (sq + C::BM - 1) / C::BM;
  const long long n_work = (long long)l.n_qt * batch * n_heads;
  if (n_work > 0x7fffffffLL) return cudaErrorInvalidValue;
  l.n_work = static_cast<int>(n_work);
  l.grid = l.n_work < sm_count() ? l.n_work : sm_count();
  return cudaSuccess;
}

template <int D>
int launch_dense(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int n_heads, int sq,
                 int sk, int kv_limit, const long long (&st)[12], float gain, cudaStream_t stream) {
  using C = Dense<D, false>;
  if (batch == 0 || n_heads == 0 || sq == 0) return 0;
  Launch l;
  cudaError_t err = plan<D>(l, q, k, v, o, batch, n_heads, sq, sk, st);
  if (err == cudaSuccess) err = set_smem(flash_wgmma_kernel<D>, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_wgmma_kernel<D><<<l.grid, C::THREADS, C::SMEM, stream>>>(l.q, l.k, l.v, l.o, lse, n_heads, sq, kv_limit, gain,
                                                                 l.n_qt, l.n_work);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// block-sparse attention: the same body, walking each work tile's key list

__global__ void __launch_bounds__(Dense<HD, false>::THREADS, 1)
sparse_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap, int n_heads,
                    int sq, int kv_limit, float gain, int n_qt, int n_work, KeyList kl) {
  attention_wgmma<HD, false, true>(&qmap, &kmap, &vmap, &omap, nullptr, nullptr, nullptr, n_heads, sq, kv_limit, gain,
                                   n_qt, n_work, kl);
}

}  // namespace

// dense attention at head dim 128 or 64; lse (batch, sq, n_heads) fp32
// contiguous, or null (at 128 only: no caller needs it at 64)
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int head_dim,
                                    int batch, int n_heads, int sq, int sk, int kv_limit, long long q_b, long long q_s,
                                    long long q_n, long long k_b, long long k_s, long long k_n, long long v_b,
                                    long long v_s, long long v_n, long long o_b, long long o_s, long long o_n,
                                    float gain, void* stream) {
  const long long st[12] = {q_b, q_s, q_n, k_b, k_s, k_n, v_b, v_s, v_n, o_b, o_s, o_n};
  const auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == HD)
    return launch_dense<HD>(q, k, v, o, static_cast<float*>(lse), batch, n_heads, sq, sk, kv_limit, st, gain, s);
  if (head_dim == 64 && lse == nullptr)
    return launch_dense<64>(q, k, v, o, nullptr, batch, n_heads, sq, sk, kv_limit, st, gain, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
  using C = Dense<HD, false>;
  if (bq <= 0 || bq % C::BM || bk <= 0 || bk % 64 || rows < (sq + bq - 1) / bq)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_heads == 0 || sq == 0) return 0;
  const long long st[12] = {q_b, q_s, q_n, k_b, k_s, k_n, v_b, v_s, v_n, o_b, o_s, o_n};
  Launch l;
  cudaError_t err = plan<HD>(l, q, k, v, o, batch, n_heads, sq, sk, st);
  if (err == cudaSuccess) err = set_smem(sparse_wgmma_kernel, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const KeyList kl{static_cast<const int*>(idx), static_cast<const int*>(cnt), rows, nnz, bq, bk, shared};
  sparse_wgmma_kernel<<<l.grid, C::THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
      l.q, l.k, l.v, l.o, n_heads, sq, sk, gain, l.n_qt, l.n_work, kl);
  return static_cast<int>(cudaGetLastError());
}
