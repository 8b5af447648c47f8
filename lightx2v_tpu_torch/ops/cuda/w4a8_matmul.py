"""int4-weight x int8-activation GEMMs: CUDA kernel wrappers and their
plain PyTorch versions.

Port of ``lightx2v_tpu/ops/pallas/w8a8_matmul.py``: ``w4a8_matmul`` (its
full-K and k-blocked forms compute the same function, so both map to one
kernel) and ``ffn_w4a8`` (kernel source ``csrc/w4a8_matmul.cu``). Weights
are nibble-packed as ``tools.convert.quantize_int4`` writes them, with
per-(channel, group) scales; activations are quantized to int8 per (token,
group). On a CUDA tensor a wrapper launches its kernels or raises; on a CPU
tensor it runs the plain version, which repeats the kernel's arithmetic
(exact int32 sum within a group, then ``+ partial * xs * ws`` in fp32, group
by group in k order).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .int4_matmul import unpack_int4_values
from .w8a8_matmul import _check_x, gelu_tanh, int_dot_exact, quant_groups, quantize_groups_plain

LAUNCHES = {"w4a8_matmul": 0, "ffn_w4a8": 0}


# (N, K/2) uint8 nibbles -> (N, K) int8 values (nibble - 8): within each
# group, byte j holds column j (low nibble) and column j + group/2
unpack_int4_plain = unpack_int4_values


def _grouped_dot(q, xs, w8, ws, group: int) -> torch.Tensor:
    """sum_g float(q_g . w8_g) * xs[:, g] * ws[:, g], in g order, fp32."""
    acc = torch.zeros((q.shape[0], w8.shape[0]), dtype=torch.float32, device=q.device)
    for g in range(ws.shape[1]):
        blk = slice(g * group, (g + 1) * group)
        acc = acc + int_dot_exact(q[:, blk], w8[:, blk]) * xs[:, g:g + 1] * ws[:, g].float()[None, :]
    return acc


def w4a8_matmul_plain(x, packed, w_scale, bias=None) -> torch.Tensor:
    *lead, k = x.shape
    n, groups = packed.shape[0], w_scale.shape[1]
    group = k // groups
    q, xs = quantize_groups_plain(x.reshape(-1, k), group)
    y = _grouped_dot(q, xs, unpack_int4_plain(packed, groups), w_scale, group)
    y = y + (bias.float()[None, :] if bias is not None else 0.0)
    return y.to(x.dtype).reshape(*lead, n)


def ffn_w4a8_plain(x, w0, w0_scale, b0, w2, w2_scale, b2) -> torch.Tensor:
    *lead, k = x.shape
    h_dim, n = w0.shape[0], w2.shape[0]
    g0, g2 = w0_scale.shape[1], w2_scale.shape[1]
    group, bh = k // g0, h_dim // g2
    q, xs = quantize_groups_plain(x.reshape(-1, k), group)
    h = _grouped_dot(q, xs, unpack_int4_plain(w0, g0), w0_scale, group)
    h = gelu_tanh(h + (b0.float()[None, :] if b0 is not None else 0.0))
    hq, hs = quantize_groups_plain(h, bh)
    y = _grouped_dot(hq, hs, unpack_int4_plain(w2, g2), w2_scale, bh)
    y = y + (b2.float()[None, :] if b2 is not None else 0.0)
    return y.to(x.dtype).reshape(*lead, n)


# ---------------------------------------------------------------------------
# CUDA kernels


def _lib():
    lib = _build.load("w4a8_matmul")
    if lib.w4a8_gemm.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.w4a8_quant_groups.argtypes = [p, p, p, i, i, i, p]
        lib.w4a8_gemm.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.ffn_w4a8_gemm1.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        for fn in (lib.w4a8_quant_groups, lib.w4a8_gemm, lib.ffn_w4a8_gemm1):
            fn.restype = ctypes.c_int
    return lib


def _check_packed(w: torch.Tensor, ws: torch.Tensor, b, k: int, dev, name: str):
    """-> (quant group, fp32 bias). w (N, K/2) uint8, 16-byte aligned (the
    GEMM reads it by TMA), ws (N, K/group) fp32; the kernels take groups
    that are multiples of 128."""
    if w.device != dev or ws.device != dev:
        raise ValueError(f"{name} is on {w.device}, expected {dev}")
    if w.dtype != torch.uint8 or w.dim() != 2 or 2 * w.shape[1] != k or not w.is_contiguous():
        raise ValueError(f"{name} must be contiguous uint8 (N, {k // 2}), got {w.dtype} {tuple(w.shape)}")
    if w.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    n = w.shape[0]
    if n % 2:
        raise ValueError(f"{name}: N must be even, got {n}")
    if (ws.dtype != torch.float32 or ws.dim() != 2 or ws.shape[0] != n or k % ws.shape[1]
            or not ws.is_contiguous()):
        raise ValueError(f"{name} scale must be contiguous fp32 ({n}, groups) with groups | {k}, "
                         f"got {ws.dtype} {tuple(ws.shape)}")
    group = k // ws.shape[1]
    if group % 128:
        raise ValueError(f"{name}: quant group {group} is not a multiple of 128")
    if b is None:
        return group, torch.zeros((n,), dtype=torch.float32, device=dev)
    if b.device != dev or b.shape != (n,):
        raise ValueError(f"{name} bias must be ({n},) on {dev}")
    return group, b.float().contiguous()


def _quant(lib, x2, group, stream):
    return quant_groups(lib.w4a8_quant_groups, x2, group, stream)


def _gemm(lib, xq, w, xs, ws, b, out, group, stream, what):
    """The GEMM on int8 codes: out (M, N) bf16 from xq (M, K), its scales xs
    (M, K/group), w (N, K/2) packed, ws (N, K/group), fp32 bias b (N,)."""
    (m, k), n = xq.shape, w.shape[0]
    _build.check(lib.w4a8_gemm(xq.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(), b.data_ptr(),
                               out.data_ptr(), m, n, k, group, stream), what)


def _gemm1(lib, xq, xs, w0, ws0, b0, hq, hs, group, bh, stream):
    """The FFN's GEMM1: hq (M, H) int8 and hs (M, H/bh) fp32 from the codes
    xq (M, K), their scales xs, w0 (H, K/2) packed, ws0, fp32 bias b0."""
    (m, k), h = xq.shape, w0.shape[0]
    _build.check(lib.ffn_w4a8_gemm1(xq.data_ptr(), w0.data_ptr(), xs.data_ptr(), ws0.data_ptr(), b0.data_ptr(),
                                    hq.data_ptr(), hs.data_ptr(), m, h, k, group, bh, stream), "ffn_w4a8 gemm1")


def w4a8_matmul(x: torch.Tensor, packed: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) bf16 -> (..., N) bf16. packed (N, K/2) uint8 nibbles,
    w_scale (N, K/group) fp32; x is int8-quantized per (token, group)."""
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x, packed, w_scale, bias)
    *lead, k = x.shape
    x2 = _check_x(x)
    group, b = _check_packed(packed, w_scale, bias, k, x.device, "w")
    n, m = packed.shape[0], x2.shape[0]
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xq, xs = _quant(lib, x2, group, stream)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _gemm(lib, xq, packed, xs, w_scale, b, out, group, stream, "w4a8_matmul")
    LAUNCHES["w4a8_matmul"] += 1
    return out.reshape(*lead, n)


def ffn_w4a8(x: torch.Tensor, w0: torch.Tensor, w0_scale: torch.Tensor, b0: Optional[torch.Tensor],
             w2: torch.Tensor, w2_scale: torch.Tensor, b2: Optional[torch.Tensor]) -> torch.Tensor:
    """Whole int4 FFN: x (..., K) -> gelu(x @ w0^T) @ w2^T -> (..., N). w0
    (H, K/2) and w2 (N, H/2) packed with per-(channel, group) scales; the
    hidden is kept in fp32 through the GELU and requantized per (token,
    bh), bh = w2's quant group."""
    if x.device.type == "cpu":
        return ffn_w4a8_plain(x, w0, w0_scale, b0, w2, w2_scale, b2)
    *lead, k = x.shape
    x2 = _check_x(x)
    h_dim = w0.shape[0]
    group0, b0c = _check_packed(w0, w0_scale, b0, k, x.device, "w0")
    bh, b2c = _check_packed(w2, w2_scale, b2, h_dim, x.device, "w2")
    if bh not in (128, 256, 512):
        raise ValueError(f"ffn_w4a8: hidden group {bh} must be 128, 256 or 512")
    n, m = w2.shape[0], x2.shape[0]
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xq, xs = _quant(lib, x2, group0, stream)
    hq = torch.empty((m, h_dim), dtype=torch.int8, device=x.device)
    hs = torch.empty((m, h_dim // bh), dtype=torch.float32, device=x.device)
    _gemm1(lib, xq, xs, w0, w0_scale, b0c, hq, hs, group0, bh, stream)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _gemm(lib, hq, w2, hs, w2_scale, b2c, out, bh, stream, "ffn_w4a8 gemm2")
    LAUNCHES["ffn_w4a8"] += 1
    return out.reshape(*lead, n)
