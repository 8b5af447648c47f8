"""int8 GEMMs with dynamic per-token activation quantization: CUDA kernel
wrappers and their plain PyTorch versions.

Port of ``lightx2v_tpu/ops/pallas/w8a8_matmul.py``: ``w8a8_matmul_fullk``
and ``ffn_w8a8`` (int8 kind; kernel source ``csrc/w8a8_matmul.cu``). On a
CUDA tensor a wrapper launches its kernels or raises; on a CPU tensor it runs
the plain version, which repeats the kernel's arithmetic with an exact
integer dot (int8 products summed in float64, exact far past any K here,
then rounded to fp32 as the kernel's int32 -> fp32 conversion does).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

LAUNCHES = {"w8a8_matmul_fullk": 0, "ffn_w8a8": 0}


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


def quantize_rows_plain(x2: torch.Tensor):
    """(M, K) -> int8 codes (M, K) and fp32 scales (M,):
    scale = max(absmax, 1e-8) * (1/127), q = clip(round(x / scale), +-127)."""
    xf = x2.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def int_dot_exact(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """q (M, K) int8 @ w (N, K)^T as the exact integer sum, rounded to fp32."""
    return torch.matmul(q.double(), w.double().t()).float()


def w8a8_matmul_fullk_plain(x, w, w_scale, bias=None, act: Optional[str] = None) -> torch.Tensor:
    *lead, k = x.shape
    n = w.shape[0]
    q, s = quantize_rows_plain(x.reshape(-1, k))
    y = int_dot_exact(q, w) * s[:, None] * w_scale.float()[None, :]
    y = y + (bias.float()[None, :] if bias is not None else 0.0)
    if act == "gelu":
        y = gelu_tanh(y)
    return y.to(x.dtype).reshape(*lead, n)


def ffn_w8a8_plain(x, w0, w0_scale, b0, w2, w2_scale, b2) -> torch.Tensor:
    *lead, k = x.shape
    h_dim, n = w0.shape[0], w2.shape[0]
    bh = pick_bh(h_dim)
    q, xs = quantize_rows_plain(x.reshape(-1, k))
    h = int_dot_exact(q, w0) * xs[:, None] * w0_scale.float()[None, :]
    h = gelu_tanh(h + (b0.float()[None, :] if b0 is not None else 0.0))
    m, g = h.shape[0], h_dim // bh
    hg = h.reshape(m, g, bh)
    hs = torch.clamp_min(hg.abs().amax(dim=-1), 1e-8) * (1.0 / 127.0)  # (M, G)
    hq = torch.clamp(torch.round(hg / hs[..., None]), -127, 127).to(torch.int8)
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
        lib.w8a8_quant_rows.argtypes = [p, p, p, i, i, p]
        lib.w8a8_gemm.argtypes = [p, p, p, i, i, p, p, p, i, i, i, i, p]
        lib.ffn_w8a8_gemm1.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        for fn in (lib.w8a8_quant_rows, lib.w8a8_gemm, lib.ffn_w8a8_gemm1):
            fn.restype = ctypes.c_int
    return lib


def _check_x(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    k = x.shape[-1]
    if k % 32:
        raise ValueError(f"K must be a multiple of 32, got {k}")
    return x.reshape(-1, k).contiguous()


def _check_w(w: torch.Tensor, ws: torch.Tensor, b, k: int, dev, name: str):
    if w.device != dev or ws.device != dev:
        raise ValueError(f"{name} is on {w.device}, expected {dev}")
    if w.dtype != torch.int8 or w.dim() != 2 or w.shape[1] != k or not w.is_contiguous():
        raise ValueError(f"{name} must be contiguous int8 (N, {k}), got {w.dtype} {tuple(w.shape)}")
    if w.shape[0] % 2:
        raise ValueError(f"{name}: N must be even, got {w.shape[0]}")
    if ws.dtype != torch.float32 or ws.shape != (w.shape[0],) or not ws.is_contiguous():
        raise ValueError(f"{name} scale must be contiguous fp32 ({w.shape[0]},)")
    if b is None:
        return torch.zeros((w.shape[0],), dtype=torch.float32, device=dev)
    if b.device != dev or b.shape != (w.shape[0],):
        raise ValueError(f"{name} bias must be ({w.shape[0]},) on {dev}")
    return b.float().contiguous()


def _quant_rows(lib, x2: torch.Tensor, stream):
    m, k = x2.shape
    xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x2.device)
    _build.check(lib.w8a8_quant_rows(x2.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k, stream),
                 "w8a8 quant_rows")
    return xq, xs


def w8a8_matmul_fullk(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, act: Optional[str] = None) -> torch.Tensor:
    """x (..., K) bf16 -> (..., N) bf16: per-token int8 quantization of x over
    all of K, int8 x int8 -> int32, then acc*xs*ws + b and the optional
    tanh-GELU (``act="gelu"``). w (N, K) int8, w_scale (N,) fp32."""
    if act not in (None, "gelu"):
        raise ValueError(f"unsupported act {act!r}")
    if x.device.type == "cpu":
        return w8a8_matmul_fullk_plain(x, w, w_scale, bias, act)
    *lead, k = x.shape
    x2 = _check_x(x)
    b = _check_w(w, w_scale, bias, k, x.device, "w")
    n = w.shape[0]
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xq, xs = _quant_rows(lib, x2, stream)
    out = torch.empty((x2.shape[0], n), dtype=torch.bfloat16, device=x.device)
    err = lib.w8a8_gemm(xq.data_ptr(), w.data_ptr(), xs.data_ptr(), 1, k, w_scale.data_ptr(),
                        b.data_ptr(), out.data_ptr(), x2.shape[0], n, k, int(act == "gelu"), stream)
    _build.check(err, "w8a8_matmul_fullk")
    LAUNCHES["w8a8_matmul_fullk"] += 1
    return out.reshape(*lead, n)


def ffn_w8a8(x: torch.Tensor, w0: torch.Tensor, w0_scale: torch.Tensor, b0: Optional[torch.Tensor],
             w2: torch.Tensor, w2_scale: torch.Tensor, b2: Optional[torch.Tensor]) -> torch.Tensor:
    """Whole quantized FFN: x (..., K) -> gelu(x @ w0^T) @ w2^T -> (..., N).
    The hidden is kept in fp32 through the GELU and requantized per
    (token, bh) group, bh from ``pick_bh``. w0 (H, K), w2 (N, H) int8."""
    if x.device.type == "cpu":
        return ffn_w8a8_plain(x, w0, w0_scale, b0, w2, w2_scale, b2)
    *lead, k = x.shape
    x2 = _check_x(x)
    h_dim = w0.shape[0]
    bh = pick_bh(h_dim)
    b0c = _check_w(w0, w0_scale, b0, k, x.device, "w0")
    b2c = _check_w(w2, w2_scale, b2, h_dim, x.device, "w2")
    n, m = w2.shape[0], x2.shape[0]
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xq, xs = _quant_rows(lib, x2, stream)
    hq = torch.empty((m, h_dim), dtype=torch.int8, device=x.device)
    hs = torch.empty((m, h_dim // bh), dtype=torch.float32, device=x.device)
    _build.check(lib.ffn_w8a8_gemm1(xq.data_ptr(), w0.data_ptr(), xs.data_ptr(), w0_scale.data_ptr(),
                                    b0c.data_ptr(), hq.data_ptr(), hs.data_ptr(), m, h_dim, k, bh,
                                    stream), "ffn_w8a8 gemm1")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _build.check(lib.w8a8_gemm(hq.data_ptr(), w2.data_ptr(), hs.data_ptr(), h_dim // bh, bh,
                               w2_scale.data_ptr(), b2c.data_ptr(), out.data_ptr(), m, n, h_dim, 0,
                               stream), "ffn_w8a8 gemm2")
    LAUNCHES["ffn_w8a8"] += 1
    return out.reshape(*lead, n)
