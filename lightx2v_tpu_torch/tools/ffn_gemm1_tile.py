"""Checks and times the FFN's first 8-bit GEMM (``ffn_gemm1_wgmma_kernel``,
the ``ffn_w8a8_gemm1`` entry point) on the card, in both kinds, on codes
from the port's quantize pass:

    python3 lightx2v_tpu_torch/tools/ffn_gemm1_tile.py                      # check and time
    python3 lightx2v_tpu_torch/tools/ffn_gemm1_tile.py --check-only         # small ragged shapes only
    python3 lightx2v_tpu_torch/tools/ffn_gemm1_tile.py --parent OTHER_ROOT  # and another checkout's, in turns

GEMM1 writes the hidden's 8-bit codes hq (M, H) and scales hs (M, H/bh)
from gelu(xq . w0 * xs * ws0 + b0), requantized per (token, bh group). First
it holds hq and hs against the plain version's arithmetic on the same codes
(``ffn_w8a8_plain``'s first half: the exact dot, the fp32 epilogue, the
group absmax) at small ragged shapes: M of 1, 333 and 4096, H of 384 (bh
128), 8960 (bh 256) and 13,824 (bh 512), K of 5120 and 256. int8 codes may
differ from the plain ones by one step (a tanh ulp at a rounding tie) and hs
by 2^-20 relative; fp8 codes by one e4m3 step plus the promoted GEMM's
error, 2^-7 of the row's largest code (448), and hs by 2^-7 relative. Then,
one JSON line per kind, the CUDA-event median ms of GEMM1 alone at the main
shape (M = 32,760, K = 5120, H = 13,824) beside its operation bound and, as
a reference point (neither is a port: no GELU, no requantization), the bare
``torch._int_mm`` / ``torch._scaled_mm`` on the same codes.

With ``--parent ROOT`` it also builds ROOT's ``csrc/w8a8_matmul.cu``
(another checkout of the port) and runs its ``ffn_w8a8_gemm1`` on the same
codes: at every shape int8 hq and hs must be bit-identical to it (int32 sums
are exact and the epilogue's fp32 operations the same); for fp8 it reports
the share of codes that differ, how many of them by one step, and by the
codes' magnitude where they differ. At the main shape both are timed in
turns (theirs, ours, ours, theirs). The card's name and power limit come
first, its SM clock and power draw last; the build's ``ptxas -v`` lines are
printed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SMALL = ((1, 5120, 384), (333, 5120, 8960), (4096, 5120, 13824), (333, 256, 13824), (1, 256, 8960),
         (4096, 256, 384))  # (M, K, H)
MAIN = (32760, 5120, 13824)
PEAK_OPS = 1979e12  # int8 TOP/s and dense fp8 TFLOP/s of the H100 SXM
BANDS = ((0.0, 1.0), (1.0, 16.0), (16.0, 128.0), (128.0, 449.0))  # |code| bands for where fp8 codes differ


def load_other(root: str, build_dir: Path, nvcc: str, flags) -> ctypes.CDLL:
    """Another checkout's w8a8 library, built with this checkout's flags."""
    so = build_dir / "w8a8_parent.so"
    build_dir.mkdir(parents=True, exist_ok=True)
    src = Path(root).resolve() / "lightx2v_tpu_torch" / "csrc" / "w8a8_matmul.cu"
    subprocess.run([nvcc, *flags, "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ffn_w8a8_gemm1.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.ffn_w8a8_gemm1.restype = ctypes.c_int
    return lib


def plain_gemm1(wm, xq, xs, w0, ws0, b0, bh: int, kind: str):
    """The plain version's first half on the same codes: (hq, hs, h / hs)."""
    import torch

    h = wm.int_dot_exact(xq, w0) * xs[:, None] * ws0[None, :]
    h = wm.gelu_tanh(h + b0[None, :])
    m, hd = h.shape
    hg = h.reshape(m, hd // bh, bh)
    hs = torch.clamp_min(hg.abs().amax(dim=-1), 1e-8) * (1.0 / wm._QMAX[kind])
    v = hg / hs[..., None]
    return wm.codes(v, kind).reshape(m, hd), hs, v.reshape(m, hd)


def e4m3_step(v):
    """The spacing of e4m3 values at |v| (code units): 2^(e - 3), 2^-9 below 2^-6."""
    import torch

    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -6))) - 3)


def against_plain(hq, hs, ref_q, ref_s, kind: str) -> dict:
    """How far hq and hs are from the plain version's, and whether that is
    inside the bars of the docstring."""
    import torch

    a, b = hq.float(), ref_q.float()
    diff = (a - b).abs()
    hs_rel = float(((hs - ref_s).abs() / ref_s).max())
    if kind == "int8":
        ok = float(diff.max()) <= 1.0 and hs_rel <= 2.0 ** -20
    else:
        ok = bool((diff <= e4m3_step(torch.maximum(a.abs(), b.abs())) + 2.0 ** -7 * 448).all()) and hs_rel <= 2.0 ** -7
    return dict(codes_differing=float((diff > 0).float().mean()), max_code_diff=float(diff.max()),
                hs_max_rel_diff=hs_rel, ok=ok)


def against_parent(hq, hs, pq, ps, v, kind: str) -> dict:
    """int8: bit-identical or not; fp8: the share of codes that differ, of
    those how many by one step, and the share differing in each |code| band
    of the exact value v = h / hs."""
    import torch

    a, b = hq.view(torch.uint8), pq.view(torch.uint8)
    out = dict(hq_identical=bool(torch.equal(a, b)), hs_identical=bool(torch.equal(hs, ps)))
    if kind == "fp8":
        differ = a != b
        sa, sb = (a >> 7).int(), (b >> 7).int()
        steps = torch.where(sa == sb, (a.int() - b.int()).abs(), (a.int() & 127) + (b.int() & 127))
        out.update(codes_differing=float(differ.float().mean()),
                   of_which_one_step=float((steps == 1).float().sum() / differ.float().sum().clamp_min(1)),
                   max_steps=int(steps.max()), hs_max_rel_diff=float(((hs - ps).abs() / ps).max()))
        mag = v.abs()
        out["differing_by_band"] = {f"{lo:g}-{hi:g}": float(differ[(mag >= lo) & (mag < hi)].float().mean())
                                    for lo, hi in BANDS if bool(((mag >= lo) & (mag < hi)).any())}
    return out


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from lightx2v_tpu_torch.ops.cuda import _build
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm
    from lightx2v_tpu_torch.tools.w4a8_tile import cuda_ms, smi

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", metavar="ROOT", default=None, help="another checkout whose GEMM1 runs in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ffn_gemm1_tile.py: no CUDA device")
    print(smi("name,power.limit"), flush=True)
    _build.build(["w8a8_matmul"], verbose=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    lib = wm._lib()
    other = load_other(args.parent, _build.BUILD_DIR, _build.nvcc_path(), _build.NVCC_FLAGS) if args.parent else None
    stream = torch.cuda.current_stream().cuda_stream

    def case(m, k, h, kind):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        xq, xs = wm._quant(lib, x, k, kind, stream)
        if kind == "int8":
            w0 = torch.randint(-127, 128, (h, k), generator=g, device=dev, dtype=torch.int8)
            ws0 = (0.5 + torch.rand((h,), generator=g, device=dev)) * (0.02 / 127)
        else:
            w0 = (torch.randn((h, k), generator=g, device=dev) * 100).clamp_(-448, 448).to(torch.float8_e4m3fn)
            ws0 = (0.5 + torch.rand((h,), generator=g, device=dev)) * (0.02 / 100)
        b0 = torch.randn((h,), generator=g, device=dev) * 0.02
        return xq, xs[:, 0].contiguous(), w0, ws0, b0

    def outputs(m, h, bh, kind):
        """hq, and hs filled with NaN so that an unwritten scale fails"""
        return (torch.empty((m, h), dtype=wm._CODE_DTYPE[kind], device=dev),
                torch.full((m, h // bh), float("nan"), device=dev))

    def run(which, xq, xs, w0, ws0, b0, bh, kind, hq, hs):
        (m, k), h = xq.shape, w0.shape[0]
        _build.check(which.ffn_w8a8_gemm1(xq.data_ptr(), w0.data_ptr(), xs.data_ptr(), ws0.data_ptr(),
                                          b0.data_ptr(), hq.data_ptr(), hs.data_ptr(), m, h, k, bh,
                                          int(kind == "fp8"), stream), "ffn_w8a8_gemm1")
        return hq, hs

    ok = True
    shapes = [(s, "small") for s in SMALL] + ([] if args.check_only else [(MAIN, "main")])
    for kind in ("int8", "fp8"):
        for (m, k, h), what in shapes:
            bh = wm.pick_bh(h)
            xq, xs, w0, ws0, b0 = case(m, k, h, kind)
            hq, hs = run(lib, xq, xs, w0, ws0, b0, bh, kind, *outputs(m, h, bh, kind))
            torch.cuda.synchronize()
            ref_q, ref_s, v = plain_gemm1(wm, xq, xs, w0, ws0, b0, bh, kind)
            line = dict(kind=kind, case=what, shape=dict(M=m, K=k, H=h, bh=bh),
                        plain=against_plain(hq, hs, ref_q, ref_s, kind))
            ok &= line["plain"]["ok"]
            del ref_q, ref_s
            if other is not None:
                pq, ps = run(other, xq, xs, w0, ws0, b0, bh, kind, *outputs(m, h, bh, kind))
                torch.cuda.synchronize()
                line["parent"] = against_parent(hq, hs, pq, ps, v, kind)
                if kind == "int8":
                    ok &= line["parent"]["hq_identical"] and line["parent"]["hs_identical"]
                del pq, ps
            del v
            if what == "main":
                line["bound_ms"] = 2.0 * m * k * h / PEAK_OPS * 1e3
                line["ms"] = cuda_ms(lambda: run(lib, xq, xs, w0, ws0, b0, bh, kind, hq, hs), args.reps)
                if kind == "int8":
                    call = "torch._int_mm (int32 out)"
                    lib_ms = cuda_ms(lambda: torch._int_mm(xq, w0.t()), args.reps)
                else:
                    call = "torch._scaled_mm (row-wise scales, bf16 out, use_fast_accum=False)"
                    sa, sb = xs[:, None].contiguous(), ws0[None, :].contiguous()
                    lib_ms = cuda_ms(lambda: torch._scaled_mm(xq, w0.t(), scale_a=sa, scale_b=sb,
                                                              out_dtype=torch.bfloat16, use_fast_accum=False),
                                     args.reps)
                line.update(library_gemm_ms=lib_ms, library_gemm_call=call)
                if other is not None:
                    line["turns"] = [dict(build="parent" if which is other else "this",
                                          ms=cuda_ms(lambda: run(which, xq, xs, w0, ws0, b0, bh, kind, hq, hs),
                                                     args.reps))
                                     for which in (other, lib, lib, other)]
            print(json.dumps(line), flush=True)
            del xq, xs, w0, hq, hs
            torch.cuda.empty_cache()
    print(smi("clocks.sm,power.draw"), flush=True)
    if not ok:
        raise SystemExit("ffn_gemm1_tile.py: GEMM1 exceeded a bar or differs from the parent's int8 codes")


if __name__ == "__main__":
    main()
