"""Measures what promoting fp8 wgmma partials into an fp32 sum buys and
costs, on the card:

    python3 lightx2v_tpu_torch/tools/w8a8_fold.py

For the fp8 8-bit GEMM at the main path's shapes, the q/k/v/o projection
(M = 32,760, N = K = 5120, one scale per row) and the FFN's second GEMM
(K = 13,824 in 27 scale groups of 512), each on one-signed inputs (x =
|randn|, positive codes: the case where truncated partial sums add up) and
on signed ones, it runs the GEMM entry point ``w8a8_gemm_fold`` once per
fold interval (values of K per promotion; 0 = none, the 128 x 256 tile) on
the same codes and prints one JSON line per case: max |out - plain| against
the bar 2^-7 * max |plain| (the bar of the kernel rows), and the CUDA-event
median ms of the GEMM alone. The card's name and power limit come first,
its SM clock and power draw last.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

FOLDS_FULLK = (0, 5120, 2048, 1024, 512, 256, 128)
FOLDS_GROUPED = (512, 256, 128)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` calls after one warm-up call, each
    call timed with CUDA events (the timer of ``chip_smoke.py``)."""
    import torch

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


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from lightx2v_tpu_torch.ops.cuda import _build
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    if not torch.cuda.is_available():
        raise SystemExit("w8a8_fold.py: no CUDA device")
    print(smi("name,power.limit"), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    lib = wm._lib()
    stream = torch.cuda.current_stream().cuda_stream
    m, n = 32760, 5120

    def codes_w(rows, k, signed):
        w = torch.randn((rows, k), generator=g, device=dev) * 100
        return (w if signed else w.abs()).clamp_(-448, 448).to(torch.float8_e4m3fn)

    for name, k, group, folds in (("fullk", 5120, 5120, FOLDS_FULLK), ("grouped", 13824, 512, FOLDS_GROUPED)):
        for signed in (False, True):
            x = torch.randn((m, k), generator=g, device=dev)
            x = (x if signed else x.abs()).to(torch.bfloat16)
            w = codes_w(n, k, signed)
            ws = torch.full((n,), 0.02 / 100, device=dev)
            b = torch.randn((n,), generator=g, device=dev) * 0.02
            if name == "fullk":
                ref = wm.w8a8_matmul_fullk_plain(x, w, ws, b, kind="fp8")
            else:  # the FFN's GEMM2 contract: the k-blocked plain version at this grouping
                assert wm.pick_kblock(k) == group
                ref = wm.w8a8_matmul_plain(x, w, ws, b, kind="fp8")
            xq, xs = wm._quant(lib, x.reshape(m, k), group, "fp8", stream)
            out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            bar = 2 ** -7 * float(ref.float().abs().max())
            for fold in folds:
                def run():
                    _build.check(lib.w8a8_gemm_fold(xq.data_ptr(), w.data_ptr(), xs.data_ptr(), k // group, group,
                                                    ws.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, 0, 1, fold,
                                                    stream), "w8a8_gemm_fold")

                run()
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                print(json.dumps({"gemm": name, "K": k, "group": group, "inputs": "signed" if signed else "one-signed",
                                  "fold": fold, "max_abs_err": err, "bar": bar, "err_over_bar": err / bar,
                                  "ms": cuda_ms(run, 10)}), flush=True)
            del x, w, ref, xq, xs, out
            torch.cuda.empty_cache()
    print(smi("clocks.sm,power.draw"), flush=True)


if __name__ == "__main__":
    main()
