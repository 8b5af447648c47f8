"""Checks and times the int4 x int8 GEMM (``w4a8_gemm_kernel``, the
``w4a8_gemm`` entry point) on the card, on codes from the port's quantize
pass:

    python3 lightx2v_tpu_torch/tools/w4a8_tile.py                      # check and time
    python3 lightx2v_tpu_torch/tools/w4a8_tile.py --check-only         # small ragged shapes only
    python3 lightx2v_tpu_torch/tools/w4a8_tile.py --parent OTHER_ROOT  # and another checkout's, in turns

First it holds the GEMM against the plain version's ``_grouped_dot`` on the
same codes at small ragged shapes (bar 2^-7 * max |plain|). Then, one JSON
line per case, max |out - plain| and the CUDA-event median ms of the GEMM
alone at the main path's shapes: the q/k/v/o projection (M = 32,760, N = K
= 5120, groups of 512), the cross-attention k/v projection (M = 512) and the
FFN's second GEMM (K = 13,824, 27 groups); then the q/k/v/o projection with
quant groups of 128 to 5120, which shows what the group boundaries' folds
cost. With ``--parent ROOT`` it also builds ROOT's ``csrc/w4a8_matmul.cu``
(another checkout of the port) and times its ``w4a8_gemm`` in turns with
this checkout's (theirs, ours, ours, theirs) at each main shape. The card's
name and power limit come first, its SM clock and power draw last; the
build's ``ptxas -v`` lines are printed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SMALL = ((200, 136, 1024, 512), (513, 256, 384, 128), (1, 130, 768, 256), (4096, 2048, 5120, 512),
         (333, 256, 13824, 512))
MAIN = (("row 8", 32760, 5120, 5120), ("row 8 M=512", 512, 5120, 5120), ("GEMM2", 32760, 5120, 13824))
GROUPS = (5120, 1024, 256, 128)


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


def load_other(root: str, build_dir: Path, nvcc: str, flags) -> ctypes.CDLL:
    """Another checkout's w4a8 library, built with this checkout's flags."""
    so = build_dir / "w4a8_parent.so"
    build_dir.mkdir(parents=True, exist_ok=True)
    src = Path(root).resolve() / "lightx2v_tpu_torch" / "csrc" / "w4a8_matmul.cu"
    subprocess.run([nvcc, *flags, "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.w4a8_gemm.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.w4a8_gemm.restype = ctypes.c_int
    return lib


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from lightx2v_tpu_torch.ops.cuda import _build
    from lightx2v_tpu_torch.ops.cuda import w4a8_matmul as w4

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", metavar="ROOT", default=None, help="another checkout whose w4a8_gemm is timed in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("w4a8_tile.py: no CUDA device")
    print(smi("name,power.limit"), flush=True)
    _build.build(["w4a8_matmul"], verbose=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    lib = w4._lib()
    other = load_other(args.parent, _build.BUILD_DIR, _build.nvcc_path(), _build.NVCC_FLAGS) if args.parent else None
    stream = torch.cuda.current_stream().cuda_stream

    def case(m, n, k, group):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        xq, xs = w4._quant(lib, x, group, stream)
        w = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
        ws = (0.5 + torch.rand((n, k // group), generator=g, device=dev)) * (0.02 / 7)
        b = torch.randn((n,), generator=g, device=dev) * 0.02
        ref = (w4._grouped_dot(xq, xs, w4.unpack_int4_plain(w, k // group), ws, group) + b[None]).to(torch.bfloat16)
        return xq, xs, w, ws, b, ref

    def run(which, xq, xs, w, ws, b, out, group):
        (m, k), n = xq.shape, w.shape[0]
        _build.check(which.w4a8_gemm(xq.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), m, n, k, group, stream), "w4a8_gemm")

    ok = True

    def checked(which, xq, xs, w, ws, b, ref, group):
        """One call on an output filled with NaN (so an unwritten element
        fails), then max |out - ref| and the bar."""
        nonlocal ok
        out = torch.full(ref.shape, float("nan"), dtype=torch.bfloat16, device=dev)
        run(which, xq, xs, w, ws, b, out, group)
        torch.cuda.synchronize()
        err, bar = float((out.float() - ref.float()).abs().max()), 2 ** -7 * float(ref.float().abs().max())
        ok &= err <= bar
        return out, err, bar

    for m, n, k, group in SMALL:
        xq, xs, w, ws, b, ref = case(m, n, k, group)
        _, err, bar = checked(lib, xq, xs, w, ws, b, ref, group)
        print(json.dumps(dict(shape=[m, n, k, group], max_abs_err=err, bar=bar)), flush=True)
    if not args.check_only:
        runs = [(name, m, n, k, 512) for name, m, n, k in MAIN]
        runs += [("row 8, groups", 32760, 5120, 5120, group) for group in GROUPS]
        for name, m, n, k, group in runs:
            xq, xs, w, ws, b, ref = case(m, n, k, group)
            out, err, bar = checked(lib, xq, xs, w, ws, b, ref, group)
            ms = cuda_ms(lambda: run(lib, xq, xs, w, ws, b, out, group), args.reps)
            line = dict(case=name, shape=[m, n, k, group], max_abs_err=err, bar=bar, ms=ms)
            if other is not None and group == 512:
                turns = []
                for which in (other, lib, lib, other):
                    out, err, _ = checked(which, xq, xs, w, ws, b, ref, group)
                    turns.append(dict(build="parent" if which is other else "this", max_abs_err=err,
                                      ms=cuda_ms(lambda: run(which, xq, xs, w, ws, b, out, group), args.reps)))
                line["turns"] = turns
            print(json.dumps(line), flush=True)
            del xq, xs, w, ref, out
            torch.cuda.empty_cache()
    print(smi("clocks.sm,power.draw"), flush=True)
    if not ok:
        raise SystemExit("w4a8_tile.py: the GEMM exceeded its bar")


if __name__ == "__main__":
    main()
