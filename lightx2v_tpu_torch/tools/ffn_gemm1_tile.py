"""Checks and times the FFN's first GEMM on the card, on codes from the
port's quantize pass: the 8-bit one (``ffn_gemm1_wgmma_kernel``, the
``ffn_w8a8_gemm1`` entry point) in both kinds, or with ``--w4a8`` the
int4-weight one (at the end):

    python3 lightx2v_tpu_torch/tools/ffn_gemm1_tile.py                      # check and time
    python3 lightx2v_tpu_torch/tools/ffn_gemm1_tile.py --check-only         # small ragged shapes only
    python3 lightx2v_tpu_torch/tools/ffn_gemm1_tile.py --parent OTHER_ROOT  # and another checkout's, in turns
    python3 lightx2v_tpu_torch/tools/ffn_gemm1_tile.py --w4a8 --parent OTHER_ROOT

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

With ``--w4a8`` it takes the int4-weight FFN's first GEMM instead
(``ffn_w4a8_gemm1_wgmma_kernel``, the ``ffn_w4a8_gemm1`` entry point of
``csrc/w4a8_matmul.cu``): w0 nibble-packed (H, K/2) with per-(row, group)
scales, int8 codes in and out. hq and hs are held against the plain
version's arithmetic (``ffn_w4a8_plain``'s first half: the exact int32 sum
of each quant group, ``+ partial * xs * ws0`` group by group, the fp32
epilogue, the group absmax) with the int8 bars above, at M of 1, 333 and
4096, H of 384, 8960 and 13,824 (bh 128, 256, 512) and quant groups of 128,
256 and 512; with ``--parent`` both hq and hs must be bit-identical to ROOT's
``ffn_w4a8_gemm1`` at every shape, the main one included. At the main shape
(M = 32,760, K = 5120, H = 13,824, groups of 512) one JSON line gives the ms
beside the operation bound, in turns with ROOT's, and, as a reference point
(not a port: no GELU, no absmax), ``w4a8_gemm`` on the same codes and
weights at (M, N, K) = (32,760, 13,824, 5120).
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
SMALL4 = ((1, 5120, 384, 512), (333, 5120, 8960, 512), (4096, 5120, 13824, 512), (333, 256, 13824, 256),
          (1, 384, 8960, 128), (4096, 384, 384, 128), (200, 1024, 13824, 128))  # (M, K, H, quant group)
PEAK_OPS = 1979e12  # int8 TOP/s and dense fp8 TFLOP/s of the H100 SXM
BANDS = ((0.0, 1.0), (1.0, 16.0), (16.0, 128.0), (128.0, 449.0))  # |code| bands for where fp8 codes differ


def load_other(root: str, build_dir: Path, nvcc: str, flags, stem: str = "w8a8_matmul") -> ctypes.CDLL:
    """Another checkout's w8a8 (or w4a8) library, built with this checkout's
    flags; its GEMM1 entry point takes 13 arguments either way."""
    so = build_dir / f"{stem}_parent.so"
    build_dir.mkdir(parents=True, exist_ok=True)
    src = Path(root).resolve() / "lightx2v_tpu_torch" / "csrc" / f"{stem}.cu"
    subprocess.run([nvcc, *flags, "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.ffn_w8a8_gemm1 if stem == "w8a8_matmul" else lib.ffn_w4a8_gemm1
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
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


def w4a8_gemm1(args) -> bool:
    """The --w4a8 mode (the docstring): True if every bar held."""
    import torch

    from lightx2v_tpu_torch.ops.cuda import _build
    from lightx2v_tpu_torch.ops.cuda import w4a8_matmul as w4
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm
    from lightx2v_tpu_torch.tools.w4a8_tile import cuda_ms

    _build.build(["w4a8_matmul"], verbose=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    lib = w4._lib()
    other = (load_other(args.parent, _build.BUILD_DIR, _build.nvcc_path(), _build.NVCC_FLAGS, "w4a8_matmul")
             if args.parent else None)
    stream = torch.cuda.current_stream().cuda_stream

    def run(which, xq, xs, w0, ws0, b0, hq, hs, group, bh):
        (m, k), h = xq.shape, w0.shape[0]
        _build.check(which.ffn_w4a8_gemm1(xq.data_ptr(), w0.data_ptr(), xs.data_ptr(), ws0.data_ptr(),
                                          b0.data_ptr(), hq.data_ptr(), hs.data_ptr(), m, h, k, group, bh, stream),
                     "ffn_w4a8_gemm1")

    def outputs(m, h, bh):
        """hq, and hs filled with NaN so that an unwritten scale fails"""
        return (torch.empty((m, h), dtype=torch.int8, device=dev),
                torch.full((m, h // bh), float("nan"), device=dev))

    ok = True
    shapes = [(s, "small") for s in SMALL4] + ([] if args.check_only else [(MAIN + (512,), "main")])
    for (m, k, h, group), what in shapes:
        bh = wm.pick_bh(h)
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        xq, xs = w4._quant(lib, x, group, stream)
        del x
        w0 = torch.randint(0, 256, (h, k // 2), generator=g, device=dev, dtype=torch.uint8)
        ws0 = (0.5 + torch.rand((h, k // group), generator=g, device=dev)) * (0.02 / 7)
        b0 = torch.randn((h,), generator=g, device=dev) * 0.02
        hq, hs = outputs(m, h, bh)
        run(lib, xq, xs, w0, ws0, b0, hq, hs, group, bh)
        torch.cuda.synchronize()
        y = wm.gelu_tanh(w4._grouped_dot(xq, xs, w4.unpack_int4_plain(w0, k // group), ws0, group) + b0[None, :])
        ref_q, ref_s = wm.quantize_groups_plain(y, bh)
        del y
        line = dict(kind="w4a8", case=what, shape=dict(M=m, K=k, H=h, group=group, bh=bh),
                    plain=against_plain(hq, hs, ref_q, ref_s, "int8"))
        ok &= line["plain"]["ok"]
        del ref_q, ref_s
        if other is not None:
            pq, ps = outputs(m, h, bh)
            run(other, xq, xs, w0, ws0, b0, pq, ps, group, bh)
            torch.cuda.synchronize()
            line["parent"] = dict(hq_identical=bool(torch.equal(hq, pq)), hs_identical=bool(torch.equal(hs, ps)))
            ok &= line["parent"]["hq_identical"] and line["parent"]["hs_identical"]
            del pq, ps
        if what == "main":
            line["bound_ms"] = 2.0 * m * k * h / PEAK_OPS * 1e3
            line["ms"] = cuda_ms(lambda: run(lib, xq, xs, w0, ws0, b0, hq, hs, group, bh), args.reps)
            if other is not None:
                line["turns"] = [dict(build="parent" if which is other else "this",
                                      ms=cuda_ms(lambda: run(which, xq, xs, w0, ws0, b0, hq, hs, group, bh),
                                                 args.reps))
                                 for which in (other, lib, lib, other)]
            out = torch.empty((m, h), dtype=torch.bfloat16, device=dev)
            line["w4a8_gemm_ms"] = cuda_ms(lambda: w4._gemm(lib, xq, w0, xs, ws0, b0, out, group, stream, "w4a8_gemm"),
                                           args.reps)
            del out
        print(json.dumps(line), flush=True)
        del xq, xs, w0, hq, hs
        torch.cuda.empty_cache()
    return ok


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
    ap.add_argument("--w4a8", action="store_true", help="the int4-weight FFN's GEMM1 (ffn_w4a8_gemm1)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ffn_gemm1_tile.py: no CUDA device")
    print(smi("name,power.limit"), flush=True)
    if args.w4a8:
        ok = w4a8_gemm1(args)
        print(smi("clocks.sm,power.draw"), flush=True)
        if not ok:
            raise SystemExit("ffn_gemm1_tile.py: w4a8 GEMM1 exceeded a bar or differs from the parent's codes")
        return
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
