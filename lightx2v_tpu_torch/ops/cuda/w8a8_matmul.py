"""8-bit GEMMs with dynamic per-token activation quantization, int8 or fp8
(e4m3): CUDA kernel wrappers and their plain PyTorch versions.

Port of ``lightx2v_tpu/ops/pallas/w8a8_matmul.py``: ``w8a8_matmul_fullk``,
the k-blocked ``w8a8_matmul`` and ``ffn_w8a8``, each with the Pallas
kernels' ``kind`` argument, ``"int8"`` (the default) or ``"fp8"`` (kernel
source ``csrc/w8a8_matmul.cu``). On a CUDA tensor a wrapper launches its
kernels or raises; on a CPU tensor it runs the plain version, which repeats
the kernel's arithmetic with an exact dot of the codes, rounded once to fp32.

The activation scale is max(absmax, 1e-8) * (1/127) for int8 codes
(clip(round(x / s), +-127)) and * (1/448) for e4m3 codes ((x / s) cast to
``torch.float8_e4m3fn``, round to nearest even). Both kinds are bound by
operations on the H100 at the main-path shapes (1979 TOP/s int8, 1979
TFLOP/s dense fp8; ``csrc/w8a8_matmul.cu`` says why). Each kind counts its
launches under its own key (``w8a8_matmul_fullk`` / ``..._fp8``), so a run
shows which kind it went through.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

KINDS = ("int8", "fp8")
LAUNCHES = {f"{name}{suffix}": 0 for suffix in ("", "_fp8") for name in ("w8a8_matmul_fullk", "w8a8_matmul",
                                                                          "ffn_w8a8")}
_QMAX = {"int8": 127.0, "fp8": 448.0}
_CODE_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _launch_key(name: str, kind: str) -> str:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    return name if kind == "int8" else f"{name}_fp8"


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    """tanh-GELU in the kernels' evaluation order (fp32)."""
    return 0.5 * y * (1.0 + torch.tanh(0.7978845608028654 * (y + 0.044715 * y * y * y)))


def pick_bh(h: int, bh: int = 512) -> int:
    """The FFN's hidden requantization group: 512 halved until it divides H
    (the TPU rule; 512 at H=13824, 256 at H=8960)."""
    while bh > 128 and h % bh:
        bh //= 2
    if h % bh:
        raise ValueError(f"ffn_w8a8 needs H % bh == 0, got H={h} bh={bh}")
    return bh


def pick_kblock(k: int, bk: int = 1024) -> int:
    """The k-blocked GEMM's activation-scale block: the largest power of two
    <= 1024 dividing K (the TPU rule; 1024 at K=10,240). K % 128 == 0."""
    while bk > 128 and k % bk:
        bk //= 2
    if k % bk:
        raise ValueError(f"the k-blocked 8-bit GEMM needs K % 128 == 0, got K={k}")
    return bk


def codes(v: torch.Tensor, kind: str = "int8") -> torch.Tensor:
    """fp32 values already divided by their scale -> 8-bit codes: int8
    clip(round half to even, +-127), or e4m3 by torch's cast (round to
    nearest even; the values never pass 448 by more than an fp32 ulp)."""
    if kind == "int8":
        return torch.clamp(torch.round(v), -127, 127).to(torch.int8)
    return v.to(torch.float8_e4m3fn)


def quantize_groups_plain(x2: torch.Tensor, group: int, kind: str = "int8"):
    """(M, K) -> codes (M, K) and fp32 scales (M, K/group), per (row,
    group): scale = max(absmax, 1e-8) * (1/127) (int8) or * (1/448) (fp8),
    codes of x / scale."""
    m, k = x2.shape
    xf = x2.float().reshape(m, k // group, group)
    s = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) * (1.0 / _QMAX[kind])
    return codes(xf / s[..., None], kind).reshape(m, k), s


def quantize_rows_plain(x2: torch.Tensor, kind: str = "int8"):
    """(M, K) -> codes (M, K) and fp32 scales (M,): one group per row."""
    q, s = quantize_groups_plain(x2, x2.shape[1], kind)
    return q, s[:, 0]


def int_dot_exact(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """q (M, K) @ w (N, K)^T for int8 or e4m3 codes: the exact sum in
    float64, rounded once to fp32.

    Exact for int8 (|sum| <= K * 127^2). Exact for e4m3 too: a code has at
    most 4 significant bits, so a product has at most 8 and is a multiple of
    2^-18 (the smallest subnormal, 2^-9, squared) below 2^18 (448^2); a sum
    of up to 13,824 < 2^14 of them is a multiple of 2^-18 below 2^32, which
    50 bits hold, inside float64's 53."""
    return torch.matmul(q.double(), w.double().t()).float()


def w8a8_matmul_fullk_plain(x, w, w_scale, bias=None, act: Optional[str] = None, kind: str = "int8") -> torch.Tensor:
    *lead, k = x.shape
    n = w.shape[0]
    q, s = quantize_rows_plain(x.reshape(-1, k), kind)
    y = int_dot_exact(q, w) * s[:, None] * w_scale.float()[None, :]
    y = y + (bias.float()[None, :] if bias is not None else 0.0)
    if act == "gelu":
        y = gelu_tanh(y)
    return y.to(x.dtype).reshape(*lead, n)


def w8a8_matmul_plain(x, w, w_scale, bias=None, act: Optional[str] = None, kind: str = "int8") -> torch.Tensor:
    """k-blocked 8-bit GEMM: x quantized per (token, k-block), each block's
    exact partial times its act scale added into fp32 in k order, then
    *w_scale + bias (``_w8a8_kernel``'s order)."""
    *lead, k = x.shape
    n = w.shape[0]
    bk = pick_kblock(k)
    x2 = x.reshape(-1, k)
    q, s = quantize_groups_plain(x2, bk, kind)
    acc = torch.zeros((x2.shape[0], n), dtype=torch.float32, device=x.device)
    for i in range(s.shape[1]):
        blk = slice(i * bk, (i + 1) * bk)
        acc = acc + int_dot_exact(q[:, blk], w[:, blk]) * s[:, i:i + 1]
    y = acc * w_scale.float()[None, :] + (bias.float()[None, :] if bias is not None else 0.0)
    if act == "gelu":
        y = gelu_tanh(y)
    return y.to(x.dtype).reshape(*lead, n)


def ffn_w8a8_plain(x, w0, w0_scale, b0, w2, w2_scale, b2, kind: str = "int8") -> torch.Tensor:
    *lead, k = x.shape
    h_dim, n = w0.shape[0], w2.shape[0]
    bh = pick_bh(h_dim)
    q, xs = quantize_rows_plain(x.reshape(-1, k), kind)
    h = int_dot_exact(q, w0) * xs[:, None] * w0_scale.float()[None, :]
    h = gelu_tanh(h + (b0.float()[None, :] if b0 is not None else 0.0))
    m, g = h.shape[0], h_dim // bh
    hg = h.reshape(m, g, bh)
    hs = torch.clamp_min(hg.abs().amax(dim=-1), 1e-8) * (1.0 / _QMAX[kind])  # (M, G)
    hq = codes(hg / hs[..., None], kind)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for i in range(g):
        acc = acc + int_dot_exact(hq[:, i], w2[:, i * bh:(i + 1) * bh]) * hs[:, i:i + 1]
    y = acc * w2_scale.float()[None, :] + (b2.float()[None, :] if b2 is not None else 0.0)
    return y.to(x.dtype).reshape(*lead, n)


# ---------------------------------------------------------------------------
# CUDA kernels


def _lib():
    lib = _build.load("w8a8_matmul")
    if lib.w8a8_gemm.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.w8a8_quant_groups.argtypes = [i, p, p, p, i, i, i, p]
        lib.w8a8_gemm.argtypes = [p, p, p, i, i, p, p, p, i, i, i, i, i, p]
        lib.w8a8_gemm_fold.argtypes = [p, p, p, i, i, p, p, p, i, i, i, i, i, i, p]
        lib.ffn_w8a8_gemm1.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        for fn in (lib.w8a8_quant_groups, lib.w8a8_gemm, lib.w8a8_gemm_fold, lib.ffn_w8a8_gemm1):
            fn.restype = ctypes.c_int
    return lib


def _check_x(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    k = x.shape[-1]
    if k % 32:
        raise ValueError(f"K must be a multiple of 32, got {k}")
    return x.reshape(-1, k).contiguous()


def _check_w(w: torch.Tensor, ws: torch.Tensor, b, k: int, dev, name: str, kind: str = "int8"):
    if w.device != dev or ws.device != dev:
        raise ValueError(f"{name} is on {w.device}, expected {dev}")
    want = _CODE_DTYPE[kind]
    if w.dtype != want or w.dim() != 2 or w.shape[1] != k or not w.is_contiguous():
        raise ValueError(f"{name} must be contiguous {want} (N, {k}) for kind {kind!r}, "
                         f"got {w.dtype} {tuple(w.shape)}")
    if w.shape[0] % 2:
        raise ValueError(f"{name}: N must be even, got {w.shape[0]}")
    if w.data_ptr() % 16:
        raise ValueError(f"{name} must start at a 16-byte aligned address (TMA reads it), got {w.data_ptr():#x}")
    if ws.dtype != torch.float32 or ws.shape != (w.shape[0],) or not ws.is_contiguous():
        raise ValueError(f"{name} scale must be contiguous fp32 ({w.shape[0]},)")
    if b is None:
        return torch.zeros((w.shape[0],), dtype=torch.float32, device=dev)
    if b.device != dev or b.shape != (w.shape[0],):
        raise ValueError(f"{name} bias must be ({w.shape[0]},) on {dev}")
    return b.float().contiguous()


def quant_groups(fn, x2: torch.Tensor, group: int, stream, dtype=torch.int8):
    """Launch a library's quant_groups pass: x2 (M, K) bf16 -> 8-bit codes
    (M, K) of ``dtype`` and fp32 scales (M, K/group)."""
    m, k = x2.shape
    if k % group or group % 8:
        raise ValueError(f"quantization group {group} must divide K={k} and be a multiple of 8")
    xq = torch.empty((m, k), dtype=dtype, device=x2.device)
    xs = torch.empty((m, k // group), dtype=torch.float32, device=x2.device)
    _build.check(fn(x2.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k, group, stream), "quant_groups")
    return xq, xs


def _quant(lib, x2, group, kind, stream):
    fn = functools.partial(lib.w8a8_quant_groups, int(kind == "fp8"))
    return quant_groups(fn, x2, group, stream, dtype=_CODE_DTYPE[kind])


def _gemm(lib, a, w, a_scale, groups, group, w_scale, b, out, m, n, k, act, kind, stream, what):
    _build.check(lib.w8a8_gemm(a.data_ptr(), w.data_ptr(), a_scale.data_ptr(), groups, group, w_scale.data_ptr(),
                               b.data_ptr(), out.data_ptr(), m, n, k, int(act == "gelu"), int(kind == "fp8"),
                               stream), what)


def w8a8_matmul_fullk(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
                      kind: str = "int8") -> torch.Tensor:
    """x (..., K) bf16 -> (..., N) bf16: per-token quantization of x over all
    of K to ``kind`` codes, an 8-bit GEMM (int32 or fp32 sums), then
    acc*xs*ws + b and the optional tanh-GELU (``act="gelu"``). w (N, K) int8
    or float8_e4m3fn (matching ``kind``), w_scale (N,) fp32."""
    key = _launch_key("w8a8_matmul_fullk", kind)
    if act not in (None, "gelu"):
        raise ValueError(f"unsupported act {act!r}")
    if x.device.type == "cpu":
        return w8a8_matmul_fullk_plain(x, w, w_scale, bias, act, kind)
    *lead, k = x.shape
    x2 = _check_x(x)
    b = _check_w(w, w_scale, bias, k, x.device, "w", kind)
    n, m = w.shape[0], x2.shape[0]
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xq, xs = _quant(lib, x2, k, kind, stream)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _gemm(lib, xq, w, xs, 1, k, w_scale, b, out, m, n, k, act, kind, stream, key)
    LAUNCHES[key] += 1
    return out.reshape(*lead, n)


def w8a8_matmul(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, act: Optional[str] = None, kind: str = "int8") -> torch.Tensor:
    """k-blocked form for K past the full-K kernel's reach: x (..., K) bf16
    -> (..., N) bf16 with one act scale per (token, k-block), block from
    ``pick_kblock``; the grouped GEMM adds each block's partial times its
    scale in k order, then *w_scale + bias and the optional tanh-GELU.
    w (N, K) int8 or float8_e4m3fn (matching ``kind``), w_scale (N,)."""
    key = _launch_key("w8a8_matmul", kind)
    if act not in (None, "gelu"):
        raise ValueError(f"unsupported act {act!r}")
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, w, w_scale, bias, act, kind)
    *lead, k = x.shape
    bk = pick_kblock(k)
    x2 = _check_x(x)
    b = _check_w(w, w_scale, bias, k, x.device, "w", kind)
    n, m = w.shape[0], x2.shape[0]
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xq, xs = _quant(lib, x2, bk, kind, stream)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _gemm(lib, xq, w, xs, k // bk, bk, w_scale, b, out, m, n, k, act, kind, stream, key)
    LAUNCHES[key] += 1
    return out.reshape(*lead, n)


def ffn_w8a8(x: torch.Tensor, w0: torch.Tensor, w0_scale: torch.Tensor, b0: Optional[torch.Tensor],
             w2: torch.Tensor, w2_scale: torch.Tensor, b2: Optional[torch.Tensor], kind: str = "int8") -> torch.Tensor:
    """Whole quantized FFN: x (..., K) -> gelu(x @ w0^T) @ w2^T -> (..., N).
    The hidden is kept in fp32 through the GELU and requantized per
    (token, bh) group to ``kind`` codes, bh from ``pick_bh``. w0 (H, K),
    w2 (N, H) int8 or float8_e4m3fn (matching ``kind``)."""
    key = _launch_key("ffn_w8a8", kind)
    if x.device.type == "cpu":
        return ffn_w8a8_plain(x, w0, w0_scale, b0, w2, w2_scale, b2, kind)
    *lead, k = x.shape
    x2 = _check_x(x)
    h_dim = w0.shape[0]
    bh = pick_bh(h_dim)
    b0c = _check_w(w0, w0_scale, b0, k, x.device, "w0", kind)
    b2c = _check_w(w2, w2_scale, b2, h_dim, x.device, "w2", kind)
    n, m = w2.shape[0], x2.shape[0]
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xq, xs = _quant(lib, x2, k, kind, stream)
    hq = torch.empty((m, h_dim), dtype=_CODE_DTYPE[kind], device=x.device)
    hs = torch.empty((m, h_dim // bh), dtype=torch.float32, device=x.device)
    _build.check(lib.ffn_w8a8_gemm1(xq.data_ptr(), w0.data_ptr(), xs.data_ptr(), w0_scale.data_ptr(),
                                    b0c.data_ptr(), hq.data_ptr(), hs.data_ptr(), m, h_dim, k, bh,
                                    int(kind == "fp8"), stream), f"{key} gemm1")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _gemm(lib, hq, w2, hs, h_dim // bh, bh, w2_scale, b2c, out, m, n, h_dim, None, kind, stream, f"{key} gemm2")
    LAUNCHES[key] += 1
    return out.reshape(*lead, n)
