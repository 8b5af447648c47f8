#!/usr/bin/env python3
"""Smoke test of lightx2v_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                 # build, kernel phase, both paths
    python3 chip_smoke.py --kernels-only  # build and kernel phase only
    python3 chip_smoke.py --profile out/  # and a profiled run of each path

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
INT8 = "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"
# the bench flagship: the deploy config plus these overrides
FLAGSHIP = dict(mm_config={"mm_type": INT4A8}, sparge=True, sparge_keep_ratio=0.3,
                sparge_ckpt=str(ROOT / "configs/sparge/wan_t2v_14b_structured_keep03.npz"),
                sparse_block_q=2048, sparse_block_k=1024, t5_quantized=True, use_tiling_vae=False)


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


# ---------------------------------------------------------------------------
# kernel phase


def kernel_phase(peaks, reps: int):
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

    # ---- flash attention with fused RoPE (self-attention) ----
    q, k, v = randn(1, S, HEADS, HD), randn(1, S, HEADS, HD), randn(1, S, HEADS, HD)
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

    # ---- flash attention (cross-attention over 512 text tokens) ----
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
    del q, k, v, kc, vc

    # ---- w8a8_matmul_fullk (q/k/v/o at M=32,760; cross k/v at M=512) ----
    def quant_lib(x2):
        s = torch.clamp_min(x2.float().abs().amax(-1), 1e-8) * (1.0 / 127.0)
        return torch.clamp(torch.round(x2.float() / s[:, None]), -127, 127).to(torch.int8), s

    def w8a8_lib(x2, w, ws, b):
        xq, s = quant_lib(x2)
        acc = torch._int_mm(xq, w.t())
        return (acc.float() * s[:, None] * ws[None] + b[None]).to(torch.bfloat16)

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
                         library_call="torch quantize + torch._int_mm + torch scaling"))
        del x
    del w

    # ---- ffn_w8a8 ----
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
                     library_call="two (torch quantize + torch._int_mm), per-token h scales"))
    del x, w0, w2
    torch.cuda.empty_cache()
    return rows, extra


def kernel_phase_flagship(peaks, reps: int):
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
    rows.append(dict(name="block_sparse_attention", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                     replaces="lightx2v_tpu/ops/pallas/block_sparse_attention.py:134",
                     shape=f"q,k,v (1,{S},{HEADS},{HD}) bf16; indices {tuple(idx.shape)}, counts {tuple(cnt.shape)} "
                           f"i32; bq {bq}, bk {bk}; selected {int(cc.sum())} of {cc.size * ic.shape[2]}",
                     max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     library_call="none (flex_attention needs torch.compile; not timed)",
                     selection_ms=sel_ms, dense_fraction=pairs / (HEADS * S * S)))
    del q, k, v
    torch.cuda.empty_cache()
    return rows, extra


# ---------------------------------------------------------------------------
# slice phase


def block_reference_check(scheme: str = "int8", mm_type: str = INT8):
    """One full-width quantized DiT block (kernel thresholds engaged) on a
    small input: CUDA kernels vs the plain versions on the CPU, same
    weights, dense fused-RoPE flash self-attention."""
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
        return wan_forward(to(params), lat.to(dev), t.to(dev), ctx.to(dev), cos, sin, arch, mm_type=mm_type)

    out = run("cuda")
    torch.cuda.synchronize()
    ref = run("cpu")
    # bar: the DiT's bf16 activations pass two flash calls and the
    # quantized GEMMs; summation order and rare rounding flips stay at bf16
    # noise
    return check_close(f"one 14B {scheme} block, card vs CPU plain", out.cpu(), ref, 3e-2, 1e-3)


def expected_launches(runner, cfg) -> dict:
    """The exact launch count of every kernel for one pipeline run."""
    from lightx2v_tpu_torch.encoders.t5 import T5_LINEARS
    from lightx2v_tpu_torch.ops.cuda import launch_counts

    L, steps = runner.arch.num_layers, len(cfg["denoising_step_list"])
    out = {k: 0 for k in launch_counts()}
    _, _, kw = runner._self_attn_setup()
    if cfg["mm_config"]["mm_type"] == INT4A8:
        p = (kw or {}).get("dense_prefix", 0)
        t5_layers = runner.text_encoder.cfg.num_layers
        # T5: q/k/v/o/gate/fc1 full-K (K = 4096), fc2 k-blocked (K = 10,240)
        out.update(w4a8_matmul=8 * L * steps, ffn_w4a8=L * steps, block_sparse_attention=(L - p) * steps,
                   flash_attention_fused_rope=p * steps, flash_attention=L * steps,
                   w8a8_matmul_fullk=(len(T5_LINEARS) - 1) * t5_layers, w8a8_matmul=t5_layers)
    else:
        out.update(w8a8_matmul_fullk=8 * L * steps, ffn_w8a8=L * steps, flash_attention_fused_rope=L * steps,
                   flash_attention=L * steps)
    return out


def run_path(name: str, overrides: dict, profile_dir=None):
    """Synthesize the path's weights on the card, zero the counters, run the
    pipeline once, and check the counts and the frames."""
    import gc

    import numpy as np
    import torch

    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.ops import sparge
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from lightx2v_tpu_torch.utils.config import set_config

    cfg = set_config(dict(model_cls="wan2.1_distill", task="t2v", device="cuda", synthetic_weights=True,
                          config_json=str(ROOT / "configs/deploy/wan_t2v.json"),
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
    for key, cat in (("flash_fwd_kernel<false, true>", "block_sparse_attention (ours)"),
                     ("flash_fwd_kernel", "flash_attention (ours)"), ("gemm_s8_kernel", "int8 GEMM (ours)"),
                     ("ffn_gemm1", "ffn GEMM1 (ours)"), ("ffn_w4a8_gemm1", "ffn w4a8 GEMM1 (ours)"),
                     ("w4a8_gemm_kernel", "w4a8 GEMM (ours)"), ("quant_groups", "int8 quantize (ours)"),
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
    from lightx2v_tpu_torch.ops.cuda import _build, reset_launch_counts

    set_numerics()
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda}))
    t0 = time.perf_counter()
    _build.build(verbose=True)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    rows, extra = kernel_phase(peaks_for(card), REPS)
    rows2, extra2 = kernel_phase_flagship(peaks_for(card), REPS)
    rows += rows2
    print(json.dumps({"other_shapes": extra + extra2}), flush=True)
    by_path = {}
    if not args.kernels_only:
        block_reference_check("int8", INT8)
        by_path["slice"] = run_path("slice", {}, args.profile)
        block_reference_check("int4", INT4A8)
        by_path["flagship"] = run_path("flagship", FLAGSHIP, args.profile)
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
