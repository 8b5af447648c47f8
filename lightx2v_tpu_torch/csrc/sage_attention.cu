// SageAttention-style int8-QK flash attention for Hopper (sm_90a), bf16 in /
// bf16 out, head dim 128.
//
// Replaces: lightx2v_tpu/ops/pallas/sage_attention.py:sage_attention
//           (_sage_kernel).
//
// What it computes: q and k are quantized to int8 per token row over the 128
// features (sc = max(absmax, 1e-6) * (1/127), code = clip(rint(x / sc),
// +-127), from the raw bf16 values); the logits are the exact int32 product
// of the codes times (q_sc * scale * log2e) and k_sc in fp32 (the TPU
// kernel's order of roundings is changed below, well inside the bar); the
// softmax runs in the exp2 domain in fp32 with an online max/sum;
// P is rounded to bf16 and P.V runs in bf16 with fp32 accumulation; the
// output is acc / max(l, 1e-30). Keys at or past kv_len are masked by their
// index (the TPU kernel instead subtracts its zero pad rows' mass in closed
// form; the sums are the same).
//
// What bounds it on this card: operations. Self-attention at B=2, 32,760
// tokens, 40 heads is 2*B*N*S^2*D int8 ops (QK^T, 11.1 ms at 1979 TOP/s)
// plus the same count of bf16 FLOP (P.V, 22.2 ms at 989 TFLOP/s) against
// 0.7 GB of q/k/v/o. Under the tensor cores sit 8.6e10 logits, each
// converted from int32, scaled, exponentiated (about 20 ms of the SM's ex2
// units) and packed.
//
// The design:
//  - Row quantization is a pre-pass (sage_quant_rows_kernel, one warp a
//    token row): codes (B, S, N, 128) int8, which is K-major along d as
//    8-bit wgmma needs (it has no transpose), and scales head-major,
//    (B, N, pitch) fp32 with the pitch S rounded up to 4 (16-byte rows for
//    TMA), so that a tile's 128 scales are 512 contiguous bytes (in the
//    (B, S, N) layout they lie N * 4 bytes apart, and a TMA box's inner
//    extent must be a multiple of 16 bytes). Done once per call, not once
//    per CTA that sweeps a head's keys: 1.4 ms of a 66 ms call.
//  - The attention kernel is attention_wgmma<128, true> (flash_wgmma.cuh),
//    the dense flash kernel's body with its S product made int8: the
//    persistent walk over 128-row work tiles, a producer warp feeding TMA
//    into a 2-stage K/V ring with full and empty barriers, two consumer
//    warpgroups of 64 rows (setmaxnreg 24 / 240; 168 registers at launch,
//    no spills), S of tile t and P.V of tile t - 1 in flight together, P
//    kept in registers as the A operand of P.V, O staged in the Q buffer
//    and stored by TMA from a producer warp.
//  - Q and K codes arrive through 4-D UINT8 maps (128, N, S, B), boxes of
//    128 bytes x 128 rows with the 128-byte swizzle: one box is a whole
//    tile, and each of the four k32 steps of
//    wgmma.m64n128k32.s32.s8.s8 moves the descriptors' start 32 bytes. The
//    scales come through 2-D fp32 maps (S, B * N), boxes of 128 x 1 (zero
//    past S): the q scales with the Q tile on its barrier, the k scales in
//    the K stage on k_full. V and O keep the dense kernel's bf16 maps over
//    the caller's strided layout.
//  - Per logit: y = float(s) * k_sc, then the softmax's ex2(fma(y, qa,
//    -m)) with qa = q_sc * gain > 0, whose row maximum is qa * max(y). The
//    TPU kernel rounds (float(s) * qa) * k_sc and then the difference with
//    m; this differs by a few fp32 ulps of the logit (~1e-6 relative in P,
//    against a bar of 2e-2 * max|out|) and saves an instruction a logit. float(s) is exact (|s| <= 128 * 127^2 < 2^24) and
//    ptxas emits it as one I2FP.F32.S32: it measured 1.5-2.5% faster than
//    the integer-add form (s + 0x4B400000 as a float, less 1.5 * 2^23).
//  - The two consumer warpgroups take turns to issue their products (named
//    barriers 1 and 2), so that one's conversion and softmax (about 750
//    instructions a warp a tile) run under the other's products; a warp
//    whose 16 rows kept their maxima skips the rescale of O.
//  - Shared memory: a Q buffer is sized for the larger of an int8 Q tile
//    (16 KB) and the bf16 O tile it stages (32 KB); two of them, two stages
//    of K (16 KB) + V (32 KB) + k scales (0.5 KB, padded to 1 KB), two
//    512-byte q-scale buffers: 164 KB.
//  - Tried and dropped (each against the kept form in one call, in turns;
//    NVIDIA H100 80GB HBM3): a third stage (71.5 against 71.0-71.2 ms), and
//    descriptors formed by adding offsets to one base (67.2-67.5 against
//    66.9-67.1). The bf16 form keeps its schedule: the turn-taking and the
//    rescale skip apply to the int8 form only.
//  - The mma.sync kernel it replaces (8 warps, 64-key tiles through a
//    cp.async ring) took 134.95 ms at the main shape; this one at step A
//    (no turns, the TPU's rounding order) 81.4 ms, and now about 66 ms.

#include "flash_wgmma.cuh"

namespace {

constexpr int HD = 128;
constexpr int QUANT_WARPS = 8;

// ---------------------------------------------------------------------------
// per-token-row quantization: x (B, S, N, 128) bf16 by strides -> codes
// (B, S, N, 128) int8 contiguous and scales (B, N, pitch) fp32. One warp per
// row, four features per lane; rows run (b, n, s), so neighbouring warps
// write neighbouring scales.

__global__ void __launch_bounds__(QUANT_WARPS * 32)
    sage_quant_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ codes,
                           float* __restrict__ scales, long long rows, int s_len, int n_heads, int pitch,
                           long long x_b, long long x_s, long long x_n) {
  const long long row = (long long)blockIdx.x * QUANT_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int s = static_cast<int>(row % s_len);
  const long long bn = row / s_len;
  const int n = static_cast<int>(bn % n_heads);
  const long long b = bn / n_heads;
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
  reinterpret_cast<char4*>(codes + ((b * s_len + s) * n_heads + n) * HD)[lane] = c;
  if (lane == 0) scales[bn * pitch + s] = sc;
}

// ---------------------------------------------------------------------------
// attention: the dense body with an int8 S product

__global__ void __launch_bounds__(Dense<HD, true>::THREADS, 1)
    sage_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                      const __grid_constant__ CUtensorMap qsmap, const __grid_constant__ CUtensorMap ksmap,
                      int n_heads, int sq, int kv_limit, float gain, int n_qt, int n_work) {
  attention_wgmma<HD, true>(&qmap, &kmap, &vmap, &omap, &qsmap, &ksmap, nullptr, n_heads, sq, kv_limit, gain, n_qt,
                            n_work);
}

// codes (batch, rows, n_heads, 128) int8 contiguous: boxes of one 128-byte row x 128 rows
bool codes_map(CUtensorMap* map, const void* p, int batch, int rows, int n_heads) {
  const long long s_n = HD, s_s = (long long)n_heads * HD, s_b = (long long)rows * n_heads * HD;
  return bsnd_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p, HD, batch, rows, n_heads, s_b, s_s, s_n, HD, 128);
}

// scales (batch * n_heads, pitch) fp32 of which the first `rows` columns
// are read: boxes of 128 x 1, zero past `rows`
bool scales_map(CUtensorMap* map, const void* p, int bn, int rows, int pitch) {
  return make_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p, bn, rows, (long long)pitch * 4, 1, 128,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace

// x (batch, s_len, n_heads, 128) bf16 by strides -> codes (batch, s_len,
// n_heads, 128) int8 and scales (batch, n_heads, pitch) fp32, both
// contiguous; pitch >= s_len
extern "C" int sage_quant_rows(const void* x, void* codes, void* scales, int batch, int s_len, int n_heads, int pitch,
                               long long x_b, long long x_s, long long x_n, void* stream) {
  const long long rows = (long long)batch * s_len * n_heads;
  if (rows == 0) return 0;
  if (pitch < s_len) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + QUANT_WARPS - 1) / QUANT_WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sage_quant_rows_kernel<<<static_cast<unsigned>(blocks), QUANT_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(codes), static_cast<float*>(scales), rows, s_len,
      n_heads, pitch, x_b, x_s, x_n);
  return static_cast<int>(cudaGetLastError());
}

// q8/k8 and qsc/ksc as sage_quant_rows writes them (pitches q_pitch and
// k_pitch, multiples of 4); v and o (batch, s, n_heads, 128) bf16 by strides
extern "C" int sage_attention_fwd(const void* q8, const void* qsc, int q_pitch, const void* k8, const void* ksc,
                                  int k_pitch, const void* v, void* o, int batch, int n_heads, int sq, int sk,
                                  int kv_limit, long long v_b, long long v_s, long long v_n, long long o_b,
                                  long long o_s, long long o_n, float gain, void* stream) {
  using C = Dense<HD, true>;
  if (batch == 0 || n_heads == 0 || sq == 0) return 0;
  if (q_pitch % 4 || k_pitch % 4 || q_pitch < sq || k_pitch < sk) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm, om, qsm, ksm;
  const int rows_k = sk > 0 ? sk : 1;  // no key tile is loaded when sk == 0
  const int bn = batch * n_heads;
  if (!codes_map(&qm, q8, batch, sq, n_heads) || !codes_map(&km, k8, batch, rows_k, n_heads) ||
      !bsnd_map<HD>(&vm, v, batch, rows_k, n_heads, v_b, v_s, v_n, C::BN) ||
      !bsnd_map<HD>(&om, o, batch, sq, n_heads, o_b, o_s, o_n, C::BM) || !scales_map(&qsm, qsc, bn, sq, q_pitch) ||
      !scales_map(&ksm, ksc, bn, rows_k, k_pitch))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (sq + C::BM - 1) / C::BM;
  const long long n_work = (long long)n_qt * bn;
  if (n_work > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_work < sm_count() ? n_work : sm_count());
  cudaError_t err = set_smem(sage_wgmma_kernel, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  sage_wgmma_kernel<<<grid, C::THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, om, qsm, ksm, n_heads, sq, kv_limit, gain, n_qt, static_cast<int>(n_work));
  return static_cast<int>(cudaGetLastError());
}
