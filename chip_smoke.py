#!/usr/bin/env python3
"""Smoke test of lightx2v_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                 # build, kernel phases, every path
    python3 chip_smoke.py --kernels-only  # build and kernel phases only
    python3 chip_smoke.py --profile out/  # and a profiled run of each path
    python3 chip_smoke.py --kernels-only --kernel int4_matmul  # one kernel's phase
    python3 chip_smoke.py --path base     # the kernel phases and one path
    python3 chip_smoke.py --path fp8_distill   # the kernel phases and the fp8 path

1. Prints the card's name and power limit, builds every CUDA kernel of the
   port from ``lightx2v_tpu_torch/csrc`` (one nvcc per source, in parallel)
   and prints the build seconds.
2. Kernel phase: each kernel runs at the shapes of the Wan2.1-T2V-14B 480P
   main paths, is held against its plain PyTorch version on the same inputs
   (bars below), and is timed with CUDA events beside its plain version,
   one PyTorch library call computing the same function where there is one
   (a yardstick only: the port never calls it), and its bound on this card.
3. Slice 1: one full-width int8 DiT block on a small input against the
   plain versions on the CPU; then the port's ``WanDistillRunner`` on
   ``configs/deploy/wan_t2v.json`` with synthetic weights made on the card
   (14B int8 DiT, 40 blocks; bf16 UMT5-XXL; full Wan VAE): T5 encode ->
   4-step distill denoise -> tiled VAE decode of 81x480x832.
4. Flagship (slice 2): one full-width w4a8 block the same way; then the
   runner on the same config with the bench flagship's overrides (w4a8 DiT
   linears, Sparge self-attention with the tuned per-layer table and its
   dense layer 0, int8 UMT5-XXL, untiled decode).

5. Base (slice 3, this script's main path): one full-width block with
   weight-only int4 linears and sage self-attention the same way; then the
   port's ``WanRunner`` (``wan2.1``) on ``configs/bench/lightx2v_1.json`` at
   the 14B widths with ``W-int4-group-sym-A-bf16-Tpu`` linears: bf16
   UMT5-XXL on the prompt and the negative prompt -> UniPC with
   classifier-free guidance as one forward at batch 2, cut to 3 steps (the
   file's 40 would take minutes; 3 run both predictor and both corrector
   orders) -> untiled decode.
6. Radial: the slice-1 config with ``radial_attn`` self-attention and a
   2-entry step list, once in the block-sparse execution (128 x 128 blocks)
   and once in ``two_pass`` (query tiles of min(sparse_block_q, 256) rows,
   so ``sparse_block_q`` 256 gives the plan's 195-row tiles).
7. fp8 distill (slice 4): one full-width fp8 block the same way; then the
   distill runner on ``configs/bench/lightx2v_3_distill.json`` (the
   reference's LightX2V_3-Distill row: fp8 e4m3 DiT linears, fused-RoPE
   flash, its 4 distill steps, tiled decode) at the 14B widths with the fp8
   UMT5-XXL (``t5_quantized``, ``t5_quant_scheme: "fp8"``).

The kernel phases also print the radial comparison at the main shape (dense
flash, block-sparse at 128 x 128 and 256 x 128, two_pass), hold two merged
half-key partials against one dense call, time the dense flash kernel at the
self-attention shape without RoPE (an ``other_shapes`` line, SDPA its
yardstick), and hold the RoPE pass of the fused-RoPE flash (``rope_rotate``,
its own kernel row and counter) bit for bit against its plain version. The
fp8 rows' library yardstick is the torch quantize pass plus
``torch._scaled_mm`` with row-wise scales; the per-head block-sparse row's is
``torch.compile(flex_attention)`` on the same block mask (None, with the
reason printed, where it does not compile). The 8-bit rows are also timed in
parts (``[parts]`` lines, and keys of their kernel rows): the quantize pass
and the GEMM of rows 3/3f beside the bare ``torch._int_mm`` /
``torch._scaled_mm`` on the same codes, and the FFN's GEMM1 and GEMM2 of
rows 4/4f; row 3f is also held against its plain version on one-signed
inputs at the main shape.

For each path the launch counters are zeroed just before the run and read
just after, and must equal the path's exact counts. The line before the
last two is ``{"kernels": [...]}``, then the card line, then
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
Without a CUDA device, or without the package beside this file, it exits 2.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# dense peaks by card (NVIDIA data sheets): (bf16 FLOP/s, int8 OP/s, bytes/s)
PEAKS = {
    "H100 PCIe": (756e12, 1513e12, 2.0e12),
    "H100 NVL": (835e12, 1671e12, 3.9e12),
    "H100": (989e12, 1979e12, 3.35e12),  # SXM
}

# main-path shapes: latents 16x21x60x104 -> 32,760 tokens, 40 heads of 128
S, HEADS, HD, DIM, FFN, TXT = 32760, 40, 128, 5120, 13824, 512
T5_DIM, T5_FFN = 4096, 10240  # UMT5-XXL
GROUP = 512  # int4 quant group along in-features at these widths
REPS = 5  # timed calls per kernel (CUDA-event median)
INT4A8 = "W-int4-group-sym-A-int8-token-dynamic-Tpu"
INT4W = "W-int4-group-sym-A-bf16-Tpu"
INT8 = "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"
FP8 = "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Tpu"
FRAMES = 21  # latent frames of 1560 tokens
DEPLOY_JSON = "configs/deploy/wan_t2v.json"
BASE_JSON = "configs/bench/lightx2v_1.json"
FP8_JSON = "configs/bench/lightx2v_3_distill.json"
# the bench flagship: the deploy config plus these overrides
FLAGSHIP = dict(mm_config={"mm_type": INT4A8}, sparge=True, sparge_keep_ratio=0.3,
                sparge_ckpt=str(ROOT / "configs/sparge/wan_t2v_14b_structured_keep03.npz"),
                sparse_block_q=2048, sparse_block_k=1024, t5_quantized=True, use_tiling_vae=False)
# the base model: the upstream baseline bench config at the 14B widths, weight-only int4, 3 of its 40 steps
BASE = dict(dim=DIM, ffn_dim=FFN, num_heads=HEADS, num_layers=40, text_len=TXT, mm_config={"mm_type": INT4W},
            infer_steps=3, negative_prompt="blurry, low quality, distorted, static frame")
# radial attention on the slice-1 config, two steps, in its two executions
RADIAL_BSR = dict(self_attn_1_type="radial_attn", sparse_block_q=128, sparse_block_k=128,
                  denoising_step_list=[1000, 500], radial_sparsity_type="bsr")
RADIAL_TWO_PASS = dict(RADIAL_BSR, sparse_block_q=256, radial_sparsity_type="two_pass")
# the reference's LightX2V_3-Distill row (fp8 DiT, fused-RoPE flash, its 4 distill steps, tiled decode) at the
# 14B widths, with the fp8 UMT5-XXL
FP8_DISTILL = dict(dim=DIM, ffn_dim=FFN, num_heads=HEADS, num_layers=40, text_len=TXT, t5_quantized=True,
                   t5_quant_scheme="fp8")
PATHS = ("slice", "flagship", "base", "radial_bsr", "radial_two_pass", "fp8_distill")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def peaks_for(name: str):
    for key in ("H100 PCIe", "H100 NVL", "H100"):
        if key in name:
            return PEAKS[key]
    return PEAKS["H100"]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, timed with CUDA
    events around each run."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return float(times[len(times) // 2])


def bound(flops: float, nbytes: float, peak_ops: float, peak_bw: float):
    t_ops, t_bytes = flops / peak_ops, nbytes / peak_bw
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def library(fn, n, make=False):
    """ms of a PyTorch library call (a yardstick only), or None where this
    build lacks it or cannot compile it; the reason is printed. With
    ``make``, ``fn()`` first builds the callable to time."""
    import torch

    try:
        return cuda_ms(fn() if make else fn, n)
    except Exception as e:  # noqa: BLE001 -- a yardstick that does not run is reported, not fatal
        print(f"[library] not timed: {type(e).__name__}: {str(e)[:300]}", flush=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return None


def check_close(name: str, out, ref, rtol: float, atol: float) -> float:
    """max |out - ref|; fails unless it is <= atol + rtol * max |ref|."""
    import torch

    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((out.float() - ref.float()).abs().max())
    lim = atol + rtol * float(ref.float().abs().max())
    print(f"[check] {name}: max_abs_err {err:.3e} (bar {lim:.3e})", flush=True)
    if not err <= lim:
        raise AssertionError(f"{name}: max_abs_err {err} exceeds {lim}")
    return err


def fullk_parts(wm, x, w, ws, b, kind: str, reps: int) -> dict:
    """The full-K 8-bit GEMM's two kernels timed apart, the quantize pass
    and the GEMM on its codes, beside the bare PyTorch GEMM on the same
    codes (a yardstick for the GEMM alone): ``torch._int_mm`` (int32 out, no
    scaling) or ``torch._scaled_mm`` with row-wise scales, bf16 out,
    ``use_fast_accum=False``."""
    import torch

    lib, stream = wm._lib(), torch.cuda.current_stream().cuda_stream
    (m, k), n = x.shape, w.shape[0]
    quant_ms = cuda_ms(lambda: wm._quant(lib, x, k, kind, stream), reps)
    xq, xs = wm._quant(lib, x, k, kind, stream)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    gemm_ms = cuda_ms(lambda: wm._gemm(lib, xq, w, xs, 1, k, ws, b, out, m, n, k, None, kind, stream, "gemm"), reps)
    if kind == "int8":
        call = "torch._int_mm (int32 out)"
        lib_ms = library(lambda: torch._int_mm(xq, w.t()), reps)
    else:
        call = "torch._scaled_mm (row-wise scales, bf16 out, use_fast_accum=False)"
        sa, sb = xs.contiguous(), ws[None, :].contiguous()
        lib_ms = library(lambda: torch._scaled_mm(xq, w.t(), scale_a=sa, scale_b=sb, out_dtype=torch.bfloat16,
                                                  use_fast_accum=False), reps)
    parts = dict(quantize_ms=quant_ms, gemm_ms=gemm_ms, library_gemm_ms=lib_ms, library_gemm_call=call)
    print(f"[parts] 8-bit full-K {kind} M={m}: {json.dumps(parts)}", flush=True)
    return parts


def ffn_parts(wm, x, w0, s0, b0, w2, s2, b2, kind: str, reps: int) -> dict:
    """The 8-bit FFN's three kernels timed apart: the quantize pass, GEMM1
    (GELU and the hidden requantization in its epilogue) and GEMM2 (the
    grouped GEMM over the hidden's bh groups)."""
    import torch

    from lightx2v_tpu_torch.ops.cuda import _build

    lib, stream = wm._lib(), torch.cuda.current_stream().cuda_stream
    (m, k), h, n = x.shape, w0.shape[0], w2.shape[0]
    bh = wm.pick_bh(h)
    quant_ms = cuda_ms(lambda: wm._quant(lib, x, k, kind, stream), reps)
    xq, xs = wm._quant(lib, x, k, kind, stream)
    hq = torch.empty((m, h), dtype=wm._CODE_DTYPE[kind], device=x.device)
    hs = torch.empty((m, h // bh), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)

    def gemm1():
        _build.check(lib.ffn_w8a8_gemm1(xq.data_ptr(), w0.data_ptr(), xs.data_ptr(), s0.data_ptr(), b0.data_ptr(),
                                        hq.data_ptr(), hs.data_ptr(), m, h, k, bh, int(kind == "fp8"), stream),
                     "ffn gemm1")

    gemm1_ms = cuda_ms(gemm1, reps)
    gemm2_ms = cuda_ms(lambda: wm._gemm(lib, hq, w2, hs, h // bh, bh, s2, b2, out, m, n, h, None, kind, stream,
                                        "ffn gemm2"), reps)
    parts = dict(quantize_ms=quant_ms, gemm1_ms=gemm1_ms, gemm2_ms=gemm2_ms)
    print(f"[parts] 8-bit FFN {kind}: {json.dumps(parts)}", flush=True)
    return parts


# ---------------------------------------------------------------------------
# kernel phase


def kernel_phase(peaks, reps: int, want):
    import torch
    import torch.nn.functional as F

    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm
    from lightx2v_tpu_torch.ops.rope import apply_rope_half, build_wan_rope_grid

    peak_bf16, peak_int8, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, extra = [], []  # extra: other main-path shapes of a kernel

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    if want("flash_attention_fused_rope") or want("flash_attention") or want("rope_rotate"):
        q = randn(1, S, HEADS, HD)
    # ---- flash attention with fused RoPE (self-attention) ----
    if want("flash_attention_fused_rope"):
        k, v = randn(1, S, HEADS, HD), randn(1, S, HEADS, HD)
        cos_np, sin_np = build_wan_rope_grid(HD, 21, 30, 52)
        cos = torch.from_numpy(cos_np).to(dev)
        sin = torch.from_numpy(sin_np).to(dev)
        out = fa.flash_attention_fused_rope(q, k, v, cos, sin)
        torch.cuda.synchronize()
        hs = slice(0, 2)  # the plain version materializes S x S per head
        ref = fa.flash_attention_fused_rope_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs], cos, sin)
        # bar: bf16 output; P rounded to bf16 at different running maxima
        # (online vs one-pass softmax) and a different summation order
        err = check_close("flash_attention_fused_rope", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref
        ms = cuda_ms(lambda: fa.flash_attention_fused_rope(q, k, v, cos, sin), reps)
        plain_ms = cuda_ms(lambda: fa.flash_attention_fused_rope_plain(q, k, v, cos, sin), 1, warmup=0)

        def lib_rope():
            qr, kr = apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin)
            return F.scaled_dot_product_attention(qr.transpose(1, 2), kr.transpose(1, 2), v.transpose(1, 2))

        lib_ms = cuda_ms(lib_rope, reps)
        b_ms, b_by = bound(4.0 * HEADS * S * S * HD, 4 * S * HEADS * HD * 2 + 2 * S * HD // 2 * 4, peak_bf16, peak_bw)
        rows.append(dict(name="flash_attention_fused_rope", route="cuda",
                         source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                         replaces="lightx2v_tpu/ops/pallas/flash_attention.py:243",
                         shape=f"q,k,v (1,{S},{HEADS},{HD}) bf16; cos,sin ({S},64) fp32",
                         max_abs_err=err, bar="2e-2*max|ref| + 1e-3", ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_call="apply_rope_half x2 + F.scaled_dot_product_attention"))
        del out

    # ---- the RoPE pass of flash_attention_fused_rope (once per call) ----
    if want("flash_attention_fused_rope") or want("rope_rotate"):
        if not want("flash_attention_fused_rope"):
            k = randn(1, S, HEADS, HD)
            cos_np, sin_np = build_wan_rope_grid(HD, 21, 30, 52)
            cos, sin = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
        gain = fa._gain(HD)
        qr, kr = fa.rope_rotate(q, k, cos, sin, gain)
        qp, kp = fa.rope_rotate_plain(q, k, cos, sin, gain)
        torch.cuda.synchronize()
        if not (torch.equal(qr, qp) and torch.equal(kr, kp)):
            raise AssertionError("rope_rotate: not bit-identical to its plain version")
        print("[check] rope_rotate: bit-identical to rope_rotate_plain", flush=True)
        del qr, kr, qp, kp
        ms = cuda_ms(lambda: fa.rope_rotate(q, k, cos, sin, gain), reps * 2)
        print(f"[rope_rotate] RoPE pass {ms:.4f} ms at (1,{S},{HEADS},{HD})", flush=True)
        plain_ms = cuda_ms(lambda: fa.rope_rotate_plain(q, k, cos, sin, gain), reps)
        b_ms, b_by = bound(0.0, 4 * S * HEADS * HD * 2 + 2 * S * HD // 2 * 4, peak_bf16, peak_bw)
        rows.append(dict(name="rope_rotate", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                         replaces="lightx2v_tpu/ops/pallas/flash_attention.py:301",
                         shape=f"q,k (1,{S},{HEADS},{HD}) bf16; cos,sin ({S},64) fp32",
                         max_abs_err=0.0, bar="bit-identical", ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         library_call="none (no single PyTorch call applies RoPE)"))
        del k
    if want("flash_attention_fused_rope"):
        del v

    # ---- flash attention (cross-attention over 512 text tokens) ----
    if want("flash_attention"):
        kc, vc = randn(1, TXT, HEADS, HD), randn(1, TXT, HEADS, HD)
        out = fa.flash_attention(q, kc, vc)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, kc, vc)
        err = check_close("flash_attention", out, ref, 2e-2, 1e-3)
        del ref, out
        ms = cuda_ms(lambda: fa.flash_attention(q, kc, vc), reps)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, kc, vc), 2)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kc.transpose(1, 2),
                                                                vc.transpose(1, 2)), reps)
        b_ms, b_by = bound(4.0 * HEADS * S * TXT * HD, (2 * S + 2 * TXT) * HEADS * HD * 2, peak_bf16, peak_bw)
        rows.append(dict(name="flash_attention", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                         replaces="lightx2v_tpu/ops/pallas/flash_attention.py:409",
                         shape=f"q (1,{S},{HEADS},{HD}); k,v (1,{TXT},{HEADS},{HD}) bf16",
                         max_abs_err=err, bar="2e-2*max|ref| + 1e-3", ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_call="F.scaled_dot_product_attention"))
        del kc, vc

        # ---- the dense kernel at the self-attention shape, without RoPE ----
        ks, vs = randn(1, S, HEADS, HD), randn(1, S, HEADS, HD)
        hs = slice(0, 2)
        out = fa.flash_attention(q, ks, vs)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q[:, :, hs], ks[:, :, hs], vs[:, :, hs])
        err = check_close("flash_attention self-attention shape", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref, out
        ms = cuda_ms(lambda: fa.flash_attention(q, ks, vs), reps)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), ks.transpose(1, 2),
                                                                vs.transpose(1, 2)), reps)
        b_ms, b_by = bound(4.0 * HEADS * S * S * HD, 4 * S * HEADS * HD * 2, peak_bf16, peak_bw)
        extra.append(dict(name="flash_attention", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                          replaces="lightx2v_tpu/ops/pallas/flash_attention.py:409",
                          shape=f"q,k,v (1,{S},{HEADS},{HD}) bf16 (self-attention, no RoPE)",
                          max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=None,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          library_call="F.scaled_dot_product_attention"))
        del ks, vs
    if want("flash_attention_fused_rope") or want("flash_attention") or want("rope_rotate"):
        del q

    # ---- w8a8_matmul_fullk (q/k/v/o at M=32,760; cross k/v at M=512) ----
    def quant_lib(x2):
        s = torch.clamp_min(x2.float().abs().amax(-1), 1e-8) * (1.0 / 127.0)
        return torch.clamp(torch.round(x2.float() / s[:, None]), -127, 127).to(torch.int8), s

    def w8a8_lib(x2, w, ws, b):
        xq, s = quant_lib(x2)
        acc = torch._int_mm(xq, w.t())
        return (acc.float() * s[:, None] * ws[None] + b[None]).to(torch.bfloat16)

    if want("w8a8_matmul_fullk"):
        w = torch.randint(-127, 128, (DIM, DIM), generator=g, device=dev, dtype=torch.int8)
        ws = torch.full((DIM,), 0.02 / 127, device=dev)
        bvec = randn(DIM, dtype=torch.float32, std=0.02)
        for m in (S, TXT):
            x = randn(m, DIM)
            out = wm.w8a8_matmul_fullk(x, w, ws, bvec)
            torch.cuda.synchronize()
            ref = wm.w8a8_matmul_fullk_plain(x, w, ws, bvec)
            # bar: the integer codes and the int32 sums are exact on both
            # sides; only the bf16 rounding of rare fp32 ties can differ
            err = check_close(f"w8a8_matmul_fullk M={m}", out, ref, 2 ** -7, 0.0)
            del ref, out
            ms = cuda_ms(lambda: wm.w8a8_matmul_fullk(x, w, ws, bvec), reps * 2)
            plain_ms = cuda_ms(lambda: wm.w8a8_matmul_fullk_plain(x, w, ws, bvec), 2)
            lib_ms = cuda_ms(lambda: w8a8_lib(x, w, ws, bvec), reps * 2)
            b_ms, b_by = bound(2.0 * m * DIM * DIM, m * DIM * 2 + DIM * DIM + 2 * DIM * 4 + m * DIM * 2,
                               peak_int8, peak_bw)
            (rows if m == S else extra).append(dict(name="w8a8_matmul_fullk", route="cuda",
                             source="lightx2v_tpu_torch/csrc/w8a8_matmul.cu",
                             replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:182",
                             shape=f"x ({m},{DIM}) bf16; w ({DIM},{DIM}) int8",
                             max_abs_err=err, bar="2^-7*max|ref|", ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             library_call="torch quantize + torch._int_mm + torch scaling",
                             **fullk_parts(wm, x, w, ws, bvec, "int8", reps * 2)))
            del x
        del w

    # ---- ffn_w8a8 ----
    if want("ffn_w8a8"):
        x = randn(S, DIM)
        w0 = torch.randint(-127, 128, (FFN, DIM), generator=g, device=dev, dtype=torch.int8)
        w2 = torch.randint(-127, 128, (DIM, FFN), generator=g, device=dev, dtype=torch.int8)
        s0, s2 = torch.full((FFN,), 0.02 / 127, device=dev), torch.full((DIM,), 0.02 / 127, device=dev)
        b0, b2 = randn(FFN, dtype=torch.float32, std=0.02), randn(DIM, dtype=torch.float32, std=0.02)
        out = wm.ffn_w8a8(x, w0, s0, b0, w2, s2, b2)
        torch.cuda.synchronize()
        ref = wm.ffn_w8a8_plain(x, w0, s0, b0, w2, s2, b2)
        # bar: x codes exact; h is fp32 on both sides but tanh on the card and
        # in torch may differ by an ulp, flipping a rare h code by one step
        err = check_close("ffn_w8a8", out, ref, 2e-2, 0.0)
        del ref, out
        ms = cuda_ms(lambda: wm.ffn_w8a8(x, w0, s0, b0, w2, s2, b2), reps)
        plain_ms = cuda_ms(lambda: wm.ffn_w8a8_plain(x, w0, s0, b0, w2, s2, b2), 1)

        def ffn_lib():
            h = w8a8_lib(x, w0, s0, b0).float()
            h = wm.gelu_tanh(h).to(torch.bfloat16)
            return w8a8_lib(h, w2, s2, b2)

        lib_ms = cuda_ms(ffn_lib, reps)
        b_ms, b_by = bound(2.0 * S * (DIM * FFN + FFN * DIM), S * DIM * 2 * 2 + 2 * DIM * FFN, peak_int8, peak_bw)
        rows.append(dict(name="ffn_w8a8", route="cuda", source="lightx2v_tpu_torch/csrc/w8a8_matmul.cu",
                         replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:301",
                         shape=f"x ({S},{DIM}) bf16; w0 ({FFN},{DIM}), w2 ({DIM},{FFN}) int8",
                         max_abs_err=err, bar="2e-2*max|ref|", ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_call="two (torch quantize + torch._int_mm), per-token h scales",
                         **ffn_parts(wm, x, w0, s0, b0, w2, s2, b2, "int8", reps)))
        del x, w0, w2
    torch.cuda.empty_cache()
    return rows, extra


def kernel_phase_flagship(peaks, reps: int, want):
    """The four kernels the bench flagship adds, at its shapes."""
    import numpy as np
    import torch

    from lightx2v_tpu_torch.ops import sparge
    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from lightx2v_tpu_torch.ops.cuda import w4a8_matmul as w4
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    peak_bf16, peak_int8, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rows, extra = [], []
    none_int4 = "none (no single PyTorch call computes per-group-scaled int4 x int8)"

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    def packed(n, k):  # synthetic int4 weights as the runner makes them
        return (torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8),
                torch.full((n, k // GROUP), 0.02 / 7, device=dev))

    # ---- w4a8_matmul (q/k/v/o and cross q/o at M=32,760; cross k/v at M=512) ----
    if want("w4a8_matmul"):
        w, ws = packed(DIM, DIM)
        bvec = randn(DIM, dtype=torch.float32, std=0.02)
        for m in (S, TXT):
            x = randn(m, DIM)
            out = w4.w4a8_matmul(x, w, ws, bvec)
            torch.cuda.synchronize()
            ref = w4.w4a8_matmul_plain(x, w, ws, bvec)
            # bar: identical int8 codes, exact int32 group sums and the same
            # fp32 order on both sides; only bf16 rounding of rare ties differs
            err = check_close(f"w4a8_matmul M={m}", out, ref, 2 ** -7, 0.0)
            del ref, out
            ms = cuda_ms(lambda: w4.w4a8_matmul(x, w, ws, bvec), reps * 2)
            plain_ms = cuda_ms(lambda: w4.w4a8_matmul_plain(x, w, ws, bvec), 1)
            b_ms, b_by = bound(2.0 * m * DIM * DIM, m * DIM * 2 + DIM * DIM // 2 + ws.numel() * 4 + DIM * 4 + m * DIM * 2,
                               peak_int8, peak_bw)
            (rows if m == S else extra).append(dict(
                name="w4a8_matmul", route="cuda", source="lightx2v_tpu_torch/csrc/w4a8_matmul.cu",
                replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:585",
                shape=f"x ({m},{DIM}) bf16; w ({DIM},{DIM // 2}) u8 + ({DIM},{DIM // GROUP}) fp32",
                max_abs_err=err, bar="2^-7*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, library_call=none_int4))
            del x
        del w, ws

    # ---- ffn_w4a8 ----
    if want("ffn_w4a8"):
        x = randn(S, DIM)
        w0, s0 = packed(FFN, DIM)
        w2, s2 = packed(DIM, FFN)
        b0, b2 = randn(FFN, dtype=torch.float32, std=0.02), randn(DIM, dtype=torch.float32, std=0.02)
        out = w4.ffn_w4a8(x, w0, s0, b0, w2, s2, b2)
        torch.cuda.synchronize()
        ref = w4.ffn_w4a8_plain(x, w0, s0, b0, w2, s2, b2)
        # bar: x codes exact; h is fp32 on both sides but tanh on the card and
        # in torch may differ by an ulp, flipping a rare h code by one step
        err = check_close("ffn_w4a8", out, ref, 2e-2, 0.0)
        del ref, out
        ms = cuda_ms(lambda: w4.ffn_w4a8(x, w0, s0, b0, w2, s2, b2), reps)
        plain_ms = cuda_ms(lambda: w4.ffn_w4a8_plain(x, w0, s0, b0, w2, s2, b2), 1)
        b_ms, b_by = bound(4.0 * S * DIM * FFN, S * DIM * 2 * 2 + DIM * FFN + (s0.numel() + s2.numel() + FFN + DIM) * 4,
                           peak_int8, peak_bw)
        rows.append(dict(name="ffn_w4a8", route="cuda", source="lightx2v_tpu_torch/csrc/w4a8_matmul.cu",
                         replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:439",
                         shape=f"x ({S},{DIM}) bf16; w0 ({FFN},{DIM // 2}) u8 + ({FFN},{DIM // GROUP}); "
                               f"w2 ({DIM},{FFN // 2}) u8 + ({DIM},{FFN // GROUP}) fp32",
                         max_abs_err=err, bar="2e-2*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, library_call=none_int4))
        del x, w0, w2

    # ---- w8a8_matmul, k-blocked (UMT5-XXL fc2: K = 10,240 > 8192) ----
    if want("w8a8_matmul"):
        x = randn(TXT, T5_FFN)
        w = torch.randint(-127, 128, (T5_DIM, T5_FFN), generator=g, device=dev, dtype=torch.int8)
        ws = torch.full((T5_DIM,), 0.02 / 127, device=dev)
        out = wm.w8a8_matmul(x, w, ws)
        torch.cuda.synchronize()
        ref = wm.w8a8_matmul_plain(x, w, ws)
        err = check_close("w8a8_matmul (k-blocked)", out, ref, 2 ** -7, 0.0)
        del ref, out
        ms = cuda_ms(lambda: wm.w8a8_matmul(x, w, ws), reps * 2)
        plain_ms = cuda_ms(lambda: wm.w8a8_matmul_plain(x, w, ws), 2)
        b_ms, b_by = bound(2.0 * TXT * T5_FFN * T5_DIM, TXT * T5_FFN * 2 + T5_DIM * T5_FFN + T5_DIM * 4 + TXT * T5_DIM * 2,
                           peak_int8, peak_bw)
        rows.append(dict(name="w8a8_matmul", route="cuda", source="lightx2v_tpu_torch/csrc/w8a8_matmul.cu",
                         replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:76",
                         shape=f"x ({TXT},{T5_FFN}) bf16; w ({T5_DIM},{T5_FFN}) int8; k-block 1024",
                         max_abs_err=err, bar="2^-7*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, library_call="none (no single PyTorch call scales per (token, k-block))"))
        del x, w

    # ---- block_sparse_attention, per-head, on Sparge's own selection ----
    if want("block_sparse_attention"):
        bq, bk = 2048, 1024
        q, k, v = randn(1, S, HEADS, HD), randn(1, S, HEADS, HD), randn(1, S, HEADS, HD)
        sel_ms = cuda_ms(lambda: sparge.sparge_select_blocks(q, k, keep_ratio=0.3, l1=0.3, block_q=bq, block_k=bk), 3)
        idx, cnt = sparge.sparge_select_blocks(q, k, keep_ratio=0.3, l1=0.3, block_q=bq, block_k=bk)
        out = bsa.block_sparse_attention(q, k, v, idx, cnt, bq=bq, bk=bk)
        torch.cuda.synchronize()
        hs = slice(0, 2)  # the plain version gathers and multiplies per (head, q superblock)
        ref = bsa.block_sparse_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs], idx[:2], cnt[:2], bq=bq, bk=bk)
        err = check_close("block_sparse_attention", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref, out
        ms = cuda_ms(lambda: bsa.block_sparse_attention(q, k, v, idx, cnt, bq=bq, bk=bk), reps)
        plain_ms = cuda_ms(lambda: bsa.block_sparse_attention_plain(q, k, v, idx, cnt, bq=bq, bk=bk), 1, warmup=0)
        # operations of this selection: 4*D per (query row, valid selected key)
        ic, cc = idx.cpu().numpy(), cnt.cpu().numpy()
        q_rows = np.minimum(bq, S - np.arange(ic.shape[1]) * bq)
        k_valid = np.minimum(bk, S - np.arange(-(-S // bk)) * bk)
        pairs = sum(int(q_rows[i]) * int(k_valid[ic[h, i, :cc[h, i]]].sum()) for h in range(ic.shape[0])
                    for i in range(ic.shape[1]))
        b_ms, b_by = bound(4.0 * HD * pairs, 4 * S * HEADS * HD * 2 + idx.numel() * 4 + cnt.numel() * 4, peak_bf16, peak_bw)
        lib_ms = library(lambda: flex_attention_call(q, k, v, idx, cnt, bq, bk, out_check=hs), 2, make=True)
        rows.append(dict(name="block_sparse_attention", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                         replaces="lightx2v_tpu/ops/pallas/block_sparse_attention.py:134",
                         shape=f"q,k,v (1,{S},{HEADS},{HD}) bf16; indices {tuple(idx.shape)}, counts {tuple(cnt.shape)} "
                               f"i32; bq {bq}, bk {bk}; selected {int(cc.sum())} of {cc.size * ic.shape[2]}",
                         max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_call="torch.compile(flex_attention) with the same per-head block mask",
                         selection_ms=sel_ms, dense_fraction=pairs / (HEADS * S * S)))
        del q, k, v
    torch.cuda.empty_cache()
    return rows, extra


def flex_attention_call(q, k, v, idx, cnt, bq: int, bk: int, out_check=None):
    """A callable of torch.compile(flex_attention) over the per-head block
    table (idx (H, nq, n), cnt (H, nq)) as a BlockMask of (bq, bk) blocks:
    the library yardstick of the per-head block-sparse kernel. Compiled and
    checked against the kernel on the heads ``out_check`` at its first call."""
    import torch
    from torch.nn.attention.flex_attention import BlockMask, flex_attention

    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa

    h, nq, n = idx.shape
    nk = -(-k.shape[1] // bk)
    kv_idx = torch.zeros((1, h, nq, nk), dtype=torch.int32, device=q.device)
    kv_idx[..., :n] = idx
    mask = BlockMask.from_kv_blocks(cnt[None].to(torch.int32).contiguous(), kv_idx, BLOCK_SIZE=(bq, bk),
                                    seq_lengths=(q.shape[1], k.shape[1]))
    flex = torch.compile(flex_attention, dynamic=False)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def call():
        return flex(qt, kt, vt, block_mask=mask)

    if out_check is not None:
        ref = bsa.block_sparse_attention(q, k, v, idx, cnt, bq=bq, bk=bk)[:, :, out_check]
        got = call().transpose(1, 2)[:, :, out_check]
        torch.cuda.synchronize()
        print(json.dumps({"flex_attention_vs_kernel_max_abs_diff": float((got.float() - ref.float()).abs().max())}),
              flush=True)
    return call


def kernel_phase_base(peaks, reps: int, want):
    """The four kernels of the base and radial paths, at their shapes, and
    the radial comparison at the main shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lightx2v_tpu_torch.ops import radial
    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa
    from lightx2v_tpu_torch.ops.cuda import int4_matmul as i4
    from lightx2v_tpu_torch.ops.cuda import sage_attention as sa
    from lightx2v_tpu_torch.parallel.ring import merge_partials

    peak_bf16, peak_int8, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows, extra = [], []
    hs = slice(0, 2)  # the attention plain versions materialize S x S per head

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    # ---- sage_attention (base path: self-attention of both CFG branches) ----
    if want("sage_attention"):
        q, k, v = randn(2, S, HEADS, HD), randn(2, S, HEADS, HD), randn(2, S, HEADS, HD)
        out = sa.sage_attention(q, k, v)
        torch.cuda.synchronize()
        ref = sa.sage_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs])
        # bar: identical int32 logits on both sides; P rounded to bf16 at
        # different running maxima (online vs one-pass softmax), summation order
        err = check_close("sage_attention", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref, out
        ms = cuda_ms(lambda: sa.sage_attention(q, k, v), reps)
        plain_ms = cuda_ms(lambda: sa.sage_attention_plain(q, k, v), 1, warmup=0)
        lib_ms = library(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                                v.transpose(1, 2)), reps)
        pairs = 2.0 * HEADS * S * S
        t_ops = 2.0 * HD * pairs / peak_int8 + 2.0 * HD * pairs / peak_bf16  # int8 QK^T, then bf16 P.V
        t_bytes = 4 * q.numel() * 2 / peak_bw
        rows.append(dict(name="sage_attention", route="cuda", source="lightx2v_tpu_torch/csrc/sage_attention.cu",
                         replaces="lightx2v_tpu/ops/pallas/sage_attention.py:120",
                         shape=f"q,k,v (2,{S},{HEADS},{HD}) bf16",
                         max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=plain_ms,
                         bound_ms=max(t_ops, t_bytes) * 1e3, bound_by="operations" if t_ops >= t_bytes else "bytes",
                         library_ms=lib_ms, library_call="F.scaled_dot_product_attention (bf16)"))
        del q, k, v

    # ---- int4_matmul (base path: every block linear; M = 65,520, and 1,024 for cross k/v) ----
    if want("int4_matmul"):
        def int4_lib(x2, w, ws):
            return torch.matmul(x2, i4.unpack_int4(w, ws).to(torch.bfloat16).t())

        for m, n, kin in ((2 * S, DIM, DIM), (2 * S, FFN, DIM), (2 * S, DIM, FFN), (2 * TXT, DIM, DIM)):
            x = randn(m, kin)
            w = torch.randint(0, 256, (n, kin // 2), generator=g, device=dev, dtype=torch.uint8)
            ws = torch.rand((n, kin // GROUP), generator=g, device=dev) * (0.02 / 7) + 0.01 / 7
            bvec = randn(n, dtype=torch.float32, std=0.02)
            out = i4.int4_matmul(x, w, ws, bvec)
            torch.cuda.synchronize()
            ref = i4.int4_matmul_plain(x, w, ws, bvec)
            # bar: exact bf16 x int4 products and the same per-group fp32
            # rescale; additions inside a group in another order move a bf16
            # rounding now and then (one ulp at the top of the range)
            err = check_close(f"int4_matmul M={m} N={n} K={kin}", out, ref, 2 ** -7, 0.0)
            del ref, out
            ms = cuda_ms(lambda: i4.int4_matmul(x, w, ws, bvec), reps)
            plain_ms = cuda_ms(lambda: i4.int4_matmul_plain(x, w, ws, bvec), 1)
            lib_ms = library(lambda: int4_lib(x, w, ws), reps)
            b_ms, b_by = bound(2.0 * m * n * kin, m * kin * 2 + n * kin // 2 + ws.numel() * 4 + n * 4 + m * n * 2,
                               peak_bf16, peak_bw)
            (rows if (m, n, kin) == (2 * S, DIM, DIM) else extra).append(dict(
                name="int4_matmul", route="cuda", source="lightx2v_tpu_torch/csrc/int4_matmul.cu",
                replaces="lightx2v_tpu/ops/pallas/int4_matmul.py:102",
                shape=f"x ({m},{kin}) bf16; w ({n},{kin // 2}) u8 + ({n},{kin // GROUP}) fp32",
                max_abs_err=err, bar="2^-7*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_call="dequantize to bf16 in torch + torch.matmul"))
            del x, w, ws

    # ---- flash_attention_with_lse (two-pass radial: near pass, then one frame of the far pass) ----
    plan = radial._two_pass_plan(S, S, FRAMES, 0.5, "wan", 256)
    tpf, bq, near, far = plan
    nt, nwin = far.shape[1], far.shape[2]

    if want("flash_attention_with_lse"):
        def lse_lib(q, k, v):
            return torch.ops.aten._scaled_dot_product_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                                      v.transpose(1, 2))[:2]

        for b_, sq_, sk_ in ((FRAMES, tpf, 4 * tpf), (nt, bq, nwin * bq)):
            q, k, v = randn(b_, sq_, HEADS, HD), randn(b_, sk_, HEADS, HD), randn(b_, sk_, HEADS, HD)
            out, lse = fa.flash_attention_with_lse(q, k, v)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_with_lse_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs])
            err = check_close(f"flash_attention_with_lse out ({b_},{sq_},{sk_})", out[:, :, hs], ref, 2e-2, 1e-3)
            # bar for lse: the same fp32 sums in another order
            lse_err = check_close(f"flash_attention_with_lse lse ({b_},{sq_},{sk_})", lse[:, :, hs], ref_lse, 0.0, 1e-3)
            del ref, out
            ms = cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v), reps)
            plain_ms = cuda_ms(lambda: fa.flash_attention_with_lse_plain(q, k, v), 1, warmup=0)
            lib_ms = library(lambda: lse_lib(q, k, v), reps)
            b_ms, b_by = bound(4.0 * b_ * HEADS * sq_ * sk_ * HD,
                               (2 * q.numel() + 2 * k.numel()) * 2 + lse.numel() * 4, peak_bf16, peak_bw)
            (rows if b_ == FRAMES else extra).append(dict(
                name="flash_attention_with_lse", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                replaces="lightx2v_tpu/ops/pallas/flash_attention.py:432",
                shape=f"q ({b_},{sq_},{HEADS},{HD}); k,v ({b_},{sk_},{HEADS},{HD}) bf16; lse ({b_},{sq_},{HEADS}) fp32",
                max_abs_err=err, lse_max_abs_err=lse_err, bar="out 2e-2*max|ref| + 1e-3, lse 1e-3 (2 heads)", ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library_call="aten._scaled_dot_product_flash_attention (output and logsumexp)"))
            del q, k, v, lse

    # ---- block_sparse_attention, shared mask (radial, 128 x 128 blocks) ----
    if want("block_sparse_attention_shared"):
        q, k, v = randn(1, S, HEADS, HD), randn(1, S, HEADS, HD), randn(1, S, HEADS, HD)
        mm = radial.MaskMap(S, FRAMES)
        fine = mm.query_mask(S, 0.5, "wan")
        idx, cnt = mm.block_tables(S, 0.5, "wan", 128, 128, dev)
        out = bsa.block_sparse_attention(q, k, v, idx, cnt, bq=128, bk=128)
        torch.cuda.synchronize()
        ref = bsa.block_sparse_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs], idx, cnt, bq=128, bk=128)
        err = check_close("block_sparse_attention_shared", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref, out
        ms = cuda_ms(lambda: bsa.block_sparse_attention(q, k, v, idx, cnt, bq=128, bk=128), reps)
        plain_ms = cuda_ms(lambda: bsa.block_sparse_attention_plain(q, k, v, idx, cnt, bq=128, bk=128), 1, warmup=0)
        tok = torch.from_numpy(fine).to(dev).repeat_interleave(128, 0).repeat_interleave(128, 1)[:S, :S].contiguous()
        lib_ms = library(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                                attn_mask=tok), 2)
        del tok

        def mask_pairs(mask, bq_, bk_):
            q_rows = np.minimum(bq_, S - np.arange(mask.shape[0]) * bq_).clip(0)
            k_valid = np.minimum(bk_, S - np.arange(mask.shape[1]) * bk_).clip(0)
            return float(q_rows @ mask.astype(np.float64) @ k_valid)

        pairs = mask_pairs(fine, 128, 128)
        b_ms, b_by = bound(4.0 * HD * HEADS * pairs, 4 * S * HEADS * HD * 2 + idx.numel() * 4 + cnt.numel() * 4,
                           peak_bf16, peak_bw)
        rows.append(dict(name="block_sparse_attention_shared", route="cuda",
                         source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                         replaces="lightx2v_tpu/ops/pallas/block_sparse_attention.py:206",
                         shape=f"q,k,v (1,{S},{HEADS},{HD}) bf16; indices {tuple(idx.shape)}, counts {tuple(cnt.shape)} i32 "
                               f"shared by all heads; bq 128, bk 128; {int(fine.sum())} of {fine.size} blocks",
                         max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms,
                         library_call="F.scaled_dot_product_attention with the expanded boolean mask",
                         dense_fraction=pairs / (float(S) * S)))

        # ---- the radial comparison at the main shape ----
        idx2, cnt2 = mm.block_tables(S, 0.5, "wan", 256, 128, dev)
        coarse = radial.coarsen_block_mask(fine, 2, 1)
        before = fa.LAUNCHES["flash_attention_with_lse"]
        two = radial.radial_attention(q, k, v, mm, sparsity_type="two_pass", block_q=256, block_k=128)
        torch.cuda.synchronize()
        lse_calls = fa.LAUNCHES["flash_attention_with_lse"] - before
        if lse_calls != 1 + FRAMES or not torch.isfinite(two.float()).all():
            raise AssertionError(f"two_pass: {lse_calls} LSE launches (expected {1 + FRAMES}) or non-finite output")
        del two
        near_pairs = float(FRAMES) * tpf * 4 * tpf
        far_pairs = float(FRAMES) * nt * bq * nwin * bq
        comparison = {
            "shape": f"q,k,v (1,{S},{HEADS},{HD}) bf16, {FRAMES} frames, decay 0.5",
            "dense_flash_ms": cuda_ms(lambda: fa.flash_attention(q, k, v), reps),
            "bsr_128x128_ms": ms, "bsr_128x128_key_pair_fraction": pairs / (float(S) * S),
            "bsr_256x128_ms": cuda_ms(lambda: bsa.block_sparse_attention(q, k, v, idx2, cnt2, bq=256, bk=128), reps),
            "bsr_256x128_key_pair_fraction": mask_pairs(coarse, 256, 128) / (float(S) * S),
            "two_pass_ms": cuda_ms(lambda: radial.radial_attention(q, k, v, mm, sparsity_type="two_pass", block_q=256,
                                                                   block_k=128), reps),
            "two_pass_key_pair_fraction": (near_pairs + far_pairs) / (float(S) * S),
            "two_pass_lse_launches": lse_calls}
        print(json.dumps({"radial_comparison": comparison}), flush=True)

        # ---- merge_partials: two half-key partials merged vs one dense call ----
        half = S // 2
        oa, la = fa.flash_attention_with_lse(q, k[:, :half], v[:, :half])
        ob, lb = fa.flash_attention_with_lse(q, k[:, half:], v[:, half:])
        merged, lse_m = merge_partials(oa, la, ob, lb)
        dense, lse_d = fa.flash_attention_with_lse(q, k, v)
        torch.cuda.synchronize()
        # bar: each partial is rounded to bf16 before the fp32 merge, then once more
        check_close("merge_partials of two half-key partials vs one dense call", merged, dense, 2e-2, 1e-3)
        check_close("merged lse vs dense lse", lse_m, lse_d, 0.0, 1e-3)
        del q, k, v, oa, ob, merged, dense
    torch.cuda.empty_cache()
    return rows, extra


def kernel_phase_fp8(peaks, reps: int, want):
    """The fp8 (e4m3) kind of the three 8-bit kernels, at the fp8 distill
    path's shapes. fp8's dense peak on these cards equals int8's."""
    import torch

    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    _, peak_fp8, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    rows, extra = [], []

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    def fp8_w(n, k):  # synthetic e4m3 weights as the runner makes them
        w = (torch.randn((n, k), generator=g, device=dev) * 100).clamp_(-448, 448).to(torch.float8_e4m3fn)
        return w, torch.full((n,), 0.02 / 100, device=dev)

    def quant_lib(x2):
        s = torch.clamp_min(x2.float().abs().amax(-1), 1e-8) * (1.0 / 448.0)
        return (x2.float() / s[:, None]).to(torch.float8_e4m3fn), s

    def fp8_lib(x2, w, ws, b=None):
        """quantize in torch + torch._scaled_mm with row-wise scales, bf16 out"""
        xq, s = quant_lib(x2)
        return torch._scaled_mm(xq, w.t(), scale_a=s[:, None].contiguous(), scale_b=ws[None, :].contiguous(),
                                bias=None if b is None else b.to(torch.bfloat16), out_dtype=torch.bfloat16)

    lib_call = "torch quantize + torch._scaled_mm (row-wise scales, bf16 out)"

    # ---- w8a8_matmul_fullk, fp8 (q/k/v/o at M=32,760; cross k/v and the T5 at M=512) ----
    if want("w8a8_matmul_fullk_fp8"):
        w, ws = fp8_w(DIM, DIM)
        bvec = randn(DIM, dtype=torch.float32, std=0.02)
        for m in (S, TXT):
            x = randn(m, DIM)
            out = wm.w8a8_matmul_fullk(x, w, ws, bvec, kind="fp8")
            torch.cuda.synchronize()
            ref = wm.w8a8_matmul_fullk_plain(x, w, ws, bvec, kind="fp8")
            # bar: the same e4m3 codes and scales; exact products summed in
            # fp32 by the tensor cores against one rounding of the exact sum
            err = check_close(f"w8a8_matmul_fullk_fp8 M={m}", out, ref, 2 ** -7, 0.0)
            del ref, out
            one_signed = {}
            if m == S:
                # one-signed x and codes: truncated wgmma partial sums would
                # add up here (the source note's promotion interval); same bar
                xo, wo = x.abs(), w.view(torch.uint8).bitwise_and(0x7F).view(torch.float8_e4m3fn)
                out = wm.w8a8_matmul_fullk(xo, wo, ws, bvec, kind="fp8")
                torch.cuda.synchronize()
                ref = wm.w8a8_matmul_fullk_plain(xo, wo, ws, bvec, kind="fp8")
                one_signed["one_signed_max_abs_err"] = check_close(
                    f"w8a8_matmul_fullk_fp8 M={m} one-signed", out, ref, 2 ** -7, 0.0)
                del xo, wo, ref, out
            ms = cuda_ms(lambda: wm.w8a8_matmul_fullk(x, w, ws, bvec, kind="fp8"), reps * 2)
            plain_ms = cuda_ms(lambda: wm.w8a8_matmul_fullk_plain(x, w, ws, bvec, kind="fp8"), 2)
            lib_ms = library(lambda: fp8_lib(x, w, ws, bvec), reps * 2)
            b_ms, b_by = bound(2.0 * m * DIM * DIM, m * DIM * 2 + DIM * DIM + 2 * DIM * 4 + m * DIM * 2,
                               peak_fp8, peak_bw)
            (rows if m == S else extra).append(dict(
                name="w8a8_matmul_fullk_fp8", route="cuda", source="lightx2v_tpu_torch/csrc/w8a8_matmul.cu",
                replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:182", shape=f"x ({m},{DIM}) bf16; w ({DIM},{DIM}) e4m3",
                max_abs_err=err, bar="2^-7*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_call=lib_call, **one_signed,
                **fullk_parts(wm, x, w, ws, bvec, "fp8", reps * 2)))
            del x
        del w

    # ---- ffn_w8a8, fp8 ----
    if want("ffn_w8a8_fp8"):
        x = randn(S, DIM)
        w0, s0 = fp8_w(FFN, DIM)
        w2, s2 = fp8_w(DIM, FFN)
        b0, b2 = randn(FFN, dtype=torch.float32, std=0.02), randn(DIM, dtype=torch.float32, std=0.02)
        out = wm.ffn_w8a8(x, w0, s0, b0, w2, s2, b2, kind="fp8")
        torch.cuda.synchronize()
        ref = wm.ffn_w8a8_plain(x, w0, s0, b0, w2, s2, b2, kind="fp8")
        # bar: x codes exact; h is fp32 on both sides but tanh on the card and
        # in torch may differ by an ulp, moving a rare h code by one step
        err = check_close("ffn_w8a8_fp8", out, ref, 2e-2, 0.0)
        del ref, out
        ms = cuda_ms(lambda: wm.ffn_w8a8(x, w0, s0, b0, w2, s2, b2, kind="fp8"), reps)
        plain_ms = cuda_ms(lambda: wm.ffn_w8a8_plain(x, w0, s0, b0, w2, s2, b2, kind="fp8"), 1)

        def ffn_lib():
            h = wm.gelu_tanh(fp8_lib(x, w0, s0, b0).float()).to(torch.bfloat16)
            return fp8_lib(h, w2, s2, b2)

        lib_ms = library(ffn_lib, reps)
        b_ms, b_by = bound(4.0 * S * DIM * FFN, S * DIM * 2 * 2 + 2 * DIM * FFN + (2 * FFN + 2 * DIM) * 4,
                           peak_fp8, peak_bw)
        rows.append(dict(name="ffn_w8a8_fp8", route="cuda", source="lightx2v_tpu_torch/csrc/w8a8_matmul.cu",
                         replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:301",
                         shape=f"x ({S},{DIM}) bf16; w0 ({FFN},{DIM}), w2 ({DIM},{FFN}) e4m3",
                         max_abs_err=err, bar="2e-2*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, library_call="two (torch quantize + torch._scaled_mm) around a torch "
                                                         "GELU, per-token h scales",
                         **ffn_parts(wm, x, w0, s0, b0, w2, s2, b2, "fp8", reps)))
        del x, w0, w2

    # ---- w8a8_matmul (k-blocked), fp8 (UMT5-XXL fc2: K = 10,240 > 8192) ----
    if want("w8a8_matmul_fp8"):
        x = randn(TXT, T5_FFN)
        w, ws = fp8_w(T5_DIM, T5_FFN)
        out = wm.w8a8_matmul(x, w, ws, kind="fp8")
        torch.cuda.synchronize()
        ref = wm.w8a8_matmul_plain(x, w, ws, kind="fp8")
        err = check_close("w8a8_matmul_fp8 (k-blocked)", out, ref, 2 ** -7, 0.0)
        del ref, out
        ms = cuda_ms(lambda: wm.w8a8_matmul(x, w, ws, kind="fp8"), reps * 2)
        plain_ms = cuda_ms(lambda: wm.w8a8_matmul_plain(x, w, ws, kind="fp8"), 2)
        lib_ms = library(lambda: fp8_lib(x, w, ws), reps * 2)
        b_ms, b_by = bound(2.0 * TXT * T5_FFN * T5_DIM, TXT * T5_FFN * 2 + T5_DIM * T5_FFN + T5_DIM * 4 + TXT * T5_DIM * 2,
                           peak_fp8, peak_bw)
        rows.append(dict(name="w8a8_matmul_fp8", route="cuda", source="lightx2v_tpu_torch/csrc/w8a8_matmul.cu",
                         replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:76",
                         shape=f"x ({TXT},{T5_FFN}) bf16; w ({T5_DIM},{T5_FFN}) e4m3; k-block 1024",
                         max_abs_err=err, bar="2^-7*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, library_call=lib_call + "; per-token scales, not per (token, k-block)"))
        del x, w
    torch.cuda.empty_cache()
    return rows, extra


# ---------------------------------------------------------------------------
# slice phase


def block_reference_check(scheme: str = "int8", mm_type: str = INT8, self_attn_type: str = "flash_attn3",
                          rtol: float = 3e-2, perturbation: bool = False):
    """One full-width quantized DiT block (kernel thresholds engaged) on a
    small input: CUDA kernels vs the plain versions on the CPU, same
    weights, dense fused-RoPE flash self-attention (or ``self_attn_type``).
    With ``perturbation`` it also prints how far the CPU block moves when one
    bf16 ulp is added to 1% of the context entries: the block's sensitivity
    to bf16-level noise, which the card-vs-CPU difference is made of."""
    import dataclasses

    import torch

    from lightx2v_tpu_torch.models.wan.config import PRESETS, WanArch
    from lightx2v_tpu_torch.models.wan.model import wan_forward
    from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape
    from lightx2v_tpu_torch.models.wan.weights import init_random_params_on_device, permute_qk_half

    arch = dataclasses.replace(WanArch(**PRESETS["wan2.1_14b"]), num_layers=1, rope_fused=True)
    params = permute_qk_half(init_random_params_on_device(arch, scheme, seed=3, device="cuda"), arch)
    g = torch.Generator(device="cuda").manual_seed(4)
    shape = (16, 2, 8, 12)  # 48 tokens
    lat = torch.randn((1, *shape), generator=g, device="cuda")
    ctx = (torch.randn((1, TXT, arch.text_dim), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    t = torch.tensor([750.0], device="cuda")

    def run(dev):
        to = lambda tree: (  # noqa: E731
            {k: to(v) for k, v in tree.items()} if isinstance(tree, dict)
            else [to(v) for v in tree] if isinstance(tree, list)
            else tree.to(dev) if isinstance(tree, torch.Tensor) else tree)
        cos, sin, _ = rope_for_shape(arch, shape, device=dev)
        return wan_forward(to(params), lat.to(dev), t.to(dev), context.to(dev), cos, sin, arch, mm_type=mm_type,
                           self_attn_type=self_attn_type)

    context = ctx
    out = run("cuda")
    torch.cuda.synchronize()
    ref = run("cpu")
    if perturbation:
        flip = torch.rand(ctx.shape, generator=g, device="cuda") < 0.01
        context = torch.where(flip, (ctx.float() * (1 + 2 ** -7)).to(torch.bfloat16), ctx)
        moved = float((run("cpu") - ref).abs().max())
        print(json.dumps({"block_perturbation": {"scheme": scheme, "max_abs_moved": moved,
                                                 "share_of_max": moved / float(ref.abs().max())}}), flush=True)
    # bar: the DiT's bf16 activations pass two flash calls and the
    # quantized GEMMs; summation order and rare rounding flips stay at bf16
    # noise (rtol 3e-2), which each quantized GEMM then amplifies where it
    # moves an activation across a code boundary (see the fp8 call)
    return check_close(f"one 14B {scheme} block ({mm_type}, {self_attn_type}), card vs CPU plain", out.cpu(), ref,
                       rtol, 1e-3)


def expected_launches(runner, cfg) -> dict:
    """The exact launch count of every kernel for one pipeline run."""
    from lightx2v_tpu_torch.encoders.t5 import T5_LINEARS
    from lightx2v_tpu_torch.ops import radial
    from lightx2v_tpu_torch.ops.cuda import launch_counts

    L = runner.arch.num_layers
    steps = len(cfg["denoising_step_list"]) if cfg["model_cls"] == "wan2.1_distill" else int(cfg["infer_steps"])
    out = {k: 0 for k in launch_counts()}
    calls = L * steps  # one per block and forward (CFG doubles the batch, not the calls)
    mm_type = cfg["mm_config"]["mm_type"]
    # per block: q/k/v/o of both attentions, and the FFN (fused, or two GEMMs around a torch GELU)
    if mm_type == INT4A8:
        out.update(w4a8_matmul=8 * calls, ffn_w4a8=calls)
    elif mm_type == INT4W:
        out.update(int4_matmul=10 * calls)
    elif mm_type == FP8:
        out.update(w8a8_matmul_fullk_fp8=8 * calls, ffn_w8a8_fp8=calls)
    else:
        out.update(w8a8_matmul_fullk=8 * calls, ffn_w8a8=calls)
    if cfg.get("t5_quantized"):
        # T5: q/k/v/o/gate/fc1 full-K (K = 4096), fc2 k-blocked (K = 10,240), in the T5's kind
        t5_layers = runner.text_encoder.cfg.num_layers
        sfx = "" if "int8" in str(cfg.get("t5_quant_scheme", "int8")) else "_fp8"
        out["w8a8_matmul_fullk" + sfx] += (len(T5_LINEARS) - 1) * t5_layers
        out["w8a8_matmul" + sfx] += t5_layers
    out["flash_attention"] = calls  # cross-attention
    attn, _, kw = runner._self_attn_setup()
    if attn == "sparge":
        p = (kw or {}).get("dense_prefix", 0)
        out.update(block_sparse_attention=(L - p) * steps, flash_attention_fused_rope=p * steps)
    elif attn == "sage_attn2":
        out["sage_attention"] = calls
    elif attn == "radial_attn":
        if cfg.get("radial_sparsity_type") == "two_pass":
            plan = radial._two_pass_plan(S, S, FRAMES, float(cfg.get("decay_factor", 0.5)), "wan",
                                         min(int(cfg["sparse_block_q"]), 256))
            if plan is None:
                raise AssertionError("two_pass has no plan at this shape")
            out["flash_attention_with_lse"] = (1 + FRAMES) * calls  # the near pass, then one far call per frame
        else:
            out["block_sparse_attention_shared"] = calls
    else:
        out["flash_attention_fused_rope"] = calls
    out["rope_rotate"] = out["flash_attention_fused_rope"]  # one RoPE pass a fused-RoPE call
    return out


def run_path(name: str, overrides: dict, profile_dir=None, model_cls: str = "wan2.1_distill",
             config_json: str = DEPLOY_JSON):
    """Synthesize the path's weights on the card, zero the counters, run the
    pipeline once, and check the counts and the frames."""
    import gc

    import numpy as np
    import torch

    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.ops import sparge
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from lightx2v_tpu_torch.utils.config import set_config

    cfg = set_config(dict(model_cls=model_cls, task="t2v", device="cuda", synthetic_weights=True,
                          config_json=str(ROOT / config_json),
                          prompt="a red panda climbing a bamboo tree in the rain", seed=42,
                          release_modules=True))
    cfg.update(overrides)
    print(f"[{name}] device memory in use before loading: {torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    t0 = time.perf_counter()
    runner = infer.init_runner(cfg)
    print(f"[{name}] synthesized weights on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    expect = expected_launches(runner, cfg)
    selected = []  # Sparge's per-call selected-block totals, summed on the device
    select = sparge.sparge_select_blocks

    def counting_select(*a, **kw):
        idx, cnt = select(*a, **kw)
        selected.append(cnt.sum())
        return idx, cnt

    sparge.sparge_select_blocks = counting_select
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        frames = runner.run_pipeline(save_video=False)
        total = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        sparge.sparge_select_blocks = select
    print(json.dumps({"path": name, "launch_counts": counts, "expected": expect}), flush=True)
    if counts != expect:
        raise AssertionError(f"{name}: launch counts {counts} != {expect}")
    if frames.shape != (81, 480, 832, 3) or not np.isfinite(frames).all():
        raise AssertionError(f"{name}: bad frames: shape {frames.shape}, finite {np.isfinite(frames).all()}")
    tm = runner.timings
    stats = {"encode_s": tm["encode_s"], "denoise_step_s": [float(x) for x in tm["step_s"]],
             "dit_s": tm["dit_s"], "decode_s": tm["decode_s"], "e2e_s": total, "steps": len(tm["step_s"]),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "frames": list(frames.shape), "frames_mean_abs": float(np.abs(frames).mean())}
    if selected:
        stats["sparge_calls"] = len(selected)
        stats["sparge_selected_blocks"] = int(torch.stack(selected).sum())
    print(json.dumps({name: stats}), flush=True)
    if profile_dir:
        profile_run(runner, profile_dir, name)
    del runner
    gc.collect()  # the runner's reference cycles hold its weights until collected
    torch.cuda.empty_cache()
    return counts


def _category(name: str) -> str:
    n = name.lower()
    for key, cat in (("sparse_fwd_kernel", "block_sparse_attention (ours)"),
                     ("flash_wgmma_kernel", "flash_attention (ours)"), ("rope_rotate_kernel", "flash_attention (ours)"),
                     ("sage_fwd_kernel", "sage attention (ours)"),
                     ("sage_quant_rows", "sage row quantize (ours)"), ("int4_wgmma_kernel", "int4 GEMM (ours)"),
                     ("w8a8_wgmma_kernel<true", "fp8 GEMM (ours)"), ("w8a8_wgmma_kernel", "int8 GEMM (ours)"),
                     ("ffn_gemm1_kernel<true", "fp8 FFN GEMM1 (ours)"),
                     ("ffn_gemm1", "ffn GEMM1 (ours)"), ("ffn_w4a8_gemm1", "ffn w4a8 GEMM1 (ours)"),
                     ("w4a8_gemm_kernel", "w4a8 GEMM (ours)"), ("quant_groups", "8-bit quantize (ours)"),
                     ("sort", "sort (torch)"),
                     ("conv", "convolution (cuDNN)"), ("fprop", "convolution (cuDNN)"),
                     ("dgrad", "convolution (cuDNN)"), ("gemm", "matmul (cuBLAS)"), ("sm90", "matmul (cuBLAS)"),
                     ("reduce", "reductions (torch)"), ("elementwise", "elementwise (torch)"),
                     ("copy", "copies/casts (torch)"), ("cat", "copies/casts (torch)")):
        if key in n:
            return cat
    return "other (torch)"


def profile_run(runner, out_dir: str, name: str):
    """One more run of the pipeline under torch.profiler: device time by
    kernel category and the device idle share, written to
    ``out_dir/profile_<name>.json`` (the profiler adds host overhead, so the
    measured run above is the one timed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if runner.text_encoder is None:  # released by the measured run: reload outside the window
        runner.text_encoder = runner.load_text_encoder()
    if runner.model is None:
        runner.model = runner.load_transformer()
    runner.config["release_modules"] = False
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run_pipeline(save_video=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3  # the pipeline only, not the trace processing
    cats, kernels = {}, []
    for e in prof.key_averages():
        dev_ms = (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0) or 0) / 1e3
        # host-side op and runtime rows would count their kernels twice;
        # "Command Buffer Full" marks launch-queue stalls, not device work
        if dev_ms <= 0 or e.key.startswith(("cuda", "aten::", "Memcpy", "Command Buffer")):
            continue
        cats[_category(e.key)] = cats.get(_category(e.key), 0.0) + dev_ms
        kernels.append({"kernel": e.key[:120], "device_ms": dev_ms, "count": e.count})
    busy = sum(cats.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms,
           "by_category_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
           "stage_s": {k: runner.timings[k] for k in ("encode_s", "dit_s", "decode_s")},
           "top_kernels": sorted(kernels, key=lambda r: -r["device_ms"])[:30]}
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    (Path(out_dir) / f"profile_{name}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({f"profile_{name}": {k: out[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                                      "by_category_ms", "stage_s")}}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--kernel", metavar="NAME", action="append", default=[],
                    help="run only this kernel's phase (repeatable; a launch-counter name, e.g. int4_matmul)")
    ap.add_argument("--path", action="append", default=[], choices=PATHS,
                    help="run only this path (repeatable)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="after each path, run it once more under torch.profiler; write DIR/profile_<path>.json")
    args = ap.parse_args()

    if not (ROOT / "lightx2v_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: the lightx2v_tpu_torch package is not beside this script", file=sys.stderr)
        sys.exit(2)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from lightx2v_tpu_torch.infer import set_numerics
    from lightx2v_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts

    unknown = sorted(set(args.kernel) - set(launch_counts()))
    if unknown:
        ap.error(f"unknown kernel {unknown}; one of {sorted(launch_counts())}")
    set_numerics()
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda}))
    t0 = time.perf_counter()
    _build.build(verbose=True)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    def want(name: str) -> bool:
        return not args.kernel or name in args.kernel

    rows, extra = kernel_phase(peaks_for(card), REPS, want)
    rows2, extra2 = kernel_phase_flagship(peaks_for(card), REPS, want)
    rows3, extra3 = kernel_phase_base(peaks_for(card), REPS, want)
    rows4, extra4 = kernel_phase_fp8(peaks_for(card), REPS, want)
    rows += rows2 + rows3 + rows4
    print(json.dumps({"other_shapes": extra + extra2 + extra3 + extra4}), flush=True)
    by_path = {}
    paths = [] if args.kernels_only else args.path or list(PATHS)
    if "slice" in paths:
        block_reference_check("int8", INT8, perturbation=True)
        by_path["slice"] = run_path("slice", {}, args.profile)
    if "flagship" in paths:
        block_reference_check("int4", INT4A8)
        by_path["flagship"] = run_path("flagship", FLAGSHIP, args.profile)
    if "base" in paths:
        block_reference_check("int4", INT4W, "sage_attn2")
        by_path["base"] = run_path("base", BASE, args.profile, model_cls="wan2.1", config_json=BASE_JSON)
    if "radial_bsr" in paths:
        by_path["radial_bsr"] = run_path("radial_bsr", RADIAL_BSR, args.profile)
    if "radial_two_pass" in paths:
        by_path["radial_two_pass"] = run_path("radial_two_pass", RADIAL_TWO_PASS, args.profile)
    if "fp8_distill" in paths:
        # bar 6e-2: a flip moves an e4m3 code by up to 1/8 of its value and an
        # int8 code by 1/127 of its row's max, so the fp8 block amplifies the
        # same bf16 noise ~3x the int8 block (the block_perturbation lines of
        # the two checks; PERF.md, PR 6)
        block_reference_check("fp8", FP8, rtol=6e-2, perturbation=True)
        by_path["fp8_distill"] = run_path("fp8_distill", FP8_DISTILL, args.profile, config_json=FP8_JSON)
    for r in rows:
        r["launches_by_path"] = {p: c.get(r["name"], 0) for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        r["kernel_ms"] = r["ms"]
    reset_launch_counts()
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
