#!/usr/bin/env python3
"""Smoke test of lightx2v_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                 # build, kernel phase, slice phase
    python3 chip_smoke.py --kernels-only  # build and kernel phase only
    python3 chip_smoke.py --profile out/  # and a profiled run of the slice

1. Prints the card's name and power limit, builds every CUDA kernel of the
   port from ``lightx2v_tpu_torch/csrc`` (one nvcc per source, in parallel)
   and prints the build seconds.
2. Kernel phase: each kernel runs at the shapes of the Wan2.1-T2V-14B 480P
   main path, is held against its plain PyTorch version on the same inputs
   (bars below), and is timed with CUDA events beside its plain version,
   one PyTorch library call computing the same function (a yardstick only:
   the port never calls it), and its bound on this card.
3. Slice phase: one full-width int8 DiT block on a small input against the
   plain versions on the CPU; then the port's ``WanDistillRunner`` on
   ``configs/deploy/wan_t2v.json`` with synthetic weights made on the card
   (14B int8 DiT, 40 blocks; bf16 UMT5-XXL; full Wan VAE): T5 encode ->
   4-step distill denoise -> tiled VAE decode of 81x480x832. The launch
   counters are zeroed just before the run and read just after.

The line before the last two is ``{"kernels": [...]}``, then the card line,
then ``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
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
REPS = 5  # timed calls per kernel (CUDA-event median)


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


# ---------------------------------------------------------------------------
# slice phase


def block_reference_check():
    """One full-width int8 DiT block (kernel thresholds engaged) on a small
    input: CUDA kernels vs the plain versions on the CPU, same weights."""
    import dataclasses

    import torch

    from lightx2v_tpu_torch.models.wan.config import PRESETS, WanArch
    from lightx2v_tpu_torch.models.wan.model import wan_forward
    from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape
    from lightx2v_tpu_torch.models.wan.weights import init_random_params_on_device, permute_qk_half

    arch = dataclasses.replace(WanArch(**PRESETS["wan2.1_14b"]), num_layers=1, rope_fused=True)
    params = permute_qk_half(init_random_params_on_device(arch, "int8", seed=3, device="cuda"), arch)
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
        return wan_forward(to(params), lat.to(dev), t.to(dev), ctx.to(dev), cos, sin, arch,
                           mm_type="W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu")

    out = run("cuda")
    torch.cuda.synchronize()
    ref = run("cpu")
    # bar: the DiT's bf16 activations pass two flash calls and five int8
    # GEMMs; summation order and rare rounding flips stay at bf16 noise
    return check_close("one 14B int8 block, card vs CPU plain", out.cpu(), ref, 3e-2, 1e-3)


def slice_phase(profile_dir=None):
    import numpy as np
    import torch

    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from lightx2v_tpu_torch.utils.config import set_config

    cfg = set_config(dict(model_cls="wan2.1_distill", task="t2v", device="cuda", synthetic_weights=True,
                          config_json=str(ROOT / "configs/deploy/wan_t2v.json"),
                          prompt="a red panda climbing a bamboo tree in the rain", seed=42,
                          release_modules=True))
    t0 = time.perf_counter()
    runner = infer.init_runner(cfg)
    print(f"[slice] synthesized weights on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    frames = runner.run_pipeline(save_video=False)
    total = time.perf_counter() - t0
    counts = launch_counts()
    L, steps = runner.arch.num_layers, len(cfg["denoising_step_list"])
    expect = {"w8a8_matmul_fullk": 8 * L * steps, "ffn_w8a8": L * steps,
              "flash_attention_fused_rope": L * steps, "flash_attention": L * steps}
    print(json.dumps({"launch_counts": counts, "expected": expect}), flush=True)
    for k_, n in expect.items():
        if counts.get(k_) != n:
            raise AssertionError(f"launch count {k_}: {counts.get(k_)} != {n}")
    if frames.shape != (81, 480, 832, 3) or not np.isfinite(frames).all():
        raise AssertionError(f"bad frames: shape {frames.shape}, finite {np.isfinite(frames).all()}")
    tm = runner.timings
    stats = {"encode_s": tm["encode_s"], "denoise_step_s": [float(x) for x in tm["step_s"]],
             "dit_s": tm["dit_s"], "decode_s": tm["decode_s"], "e2e_s": total, "steps": steps,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "frames": list(frames.shape), "frames_mean_abs": float(np.abs(frames).mean())}
    print(json.dumps({"slice": stats}), flush=True)
    if profile_dir:
        profile_run(runner, profile_dir)
    return counts


def _category(name: str) -> str:
    n = name.lower()
    for key, cat in (("flash_fwd_kernel", "flash_attention (ours)"), ("gemm_s8_kernel", "int8 GEMM (ours)"),
                     ("ffn_gemm1", "ffn GEMM1 (ours)"), ("quant_rows", "int8 quantize (ours)"),
                     ("conv", "convolution (cuDNN)"), ("fprop", "convolution (cuDNN)"),
                     ("dgrad", "convolution (cuDNN)"), ("gemm", "matmul (cuBLAS)"), ("sm90", "matmul (cuBLAS)"),
                     ("reduce", "reductions (torch)"), ("elementwise", "elementwise (torch)"),
                     ("copy", "copies/casts (torch)"), ("cat", "copies/casts (torch)")):
        if key in n:
            return cat
    return "other (torch)"


def profile_run(runner, out_dir: str):
    """One more run of the pipeline under torch.profiler: device time by
    kernel category and the device idle share, written to
    ``out_dir/profile_slice.json`` (the profiler adds host overhead, so the
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
    (Path(out_dir) / "profile_slice.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({"profile": {k: out[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                                      "by_category_ms", "stage_s")}}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="after the slice, run it once more under torch.profiler; write DIR/profile_slice.json")
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

    set_numerics()
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda}))
    t0 = time.perf_counter()
    _build.build(verbose=True)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    rows, extra = kernel_phase(peaks_for(card), REPS)
    print(json.dumps({"other_shapes": extra}), flush=True)
    launches = {k: 0 for k in launch_counts()}
    if not args.kernels_only:
        block_reference_check()
        launches = slice_phase(args.profile)
    for r in rows:
        r["launches"] = launches.get(r["name"], 0)
        r["kernel_ms"] = r["ms"]
    reset_launch_counts()
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
