"""Matmul ("mm") op table (counterpart of ``lightx2v_tpu.ops.linear``).

Each scheme is a function ``apply(params, x) -> y`` resolved through
MM_REGISTER under the same mm_type strings as the JAX package. Weights keep
the checkpoint's (out, in) layout.

``Default`` is the JAX package's ``_nt_dot(x, w.astype(x.dtype), f32)``:
on the card, bf16 operands on the tensor cores with an fp32 result
(``torch.mm(..., out_dtype=torch.float32)``), no fp32 copy of x or w; the
bias is added in fp32 and the sum rounded once to x's dtype. The CPU has no
such kernel and widens both operands to fp32 instead: the same exact
products and fp32 sums. ``Default-Force-FP32`` stays an fp32 GEMM.

The int8 and fp8 (e4m3) per-channel schemes follow the JAX dispatch's
activation-scale contract:

* min(N, K) >= 4096 and K <= 8192 (K % 128 == 0): ``w8a8_matmul_fullk``
  (CUDA kernel; its plain version on the CPU);
* min(N, K) >= 4096 and K > 8192 (or K % 128 != 0): the k-blocked
  ``w8a8_matmul`` (CUDA kernel), one act scale per (token, k-block);
* smaller dims: per-token quantization of x over all of K. On a CUDA
  tensor that is ``w8a8_matmul_fullk`` at any width. On the CPU it is plain
  torch ops, as the JAX package leaves that path to XLA (int8: absmax / 127,
  fp8: absmax / 448 -- a division here, the kernels multiply by the
  reciprocal), then an exact dot of the codes. The JAX package's 4096
  threshold is a TPU v5e measurement (XLA's int8 dot beat its Pallas kernel
  below it); on the H100 the hand kernel is the per-token path, so no 8-bit
  linear on the card runs the exact float64 dot;
* the FFN runs ``ffn_w8a8`` whole when min(H, K) >= 1024, else GEMM, GELU,
  GEMM.

The int4 scheme (``W-int4-group-sym-A-int8-token-dynamic-Tpu``) follows the
TPU kernel's contract at every size: nibble-packed weights with
per-(channel, group) scales times per-(token, group) int8 activations
through ``w4a8_matmul``, and the FFN through ``ffn_w4a8`` when its scales are
2-D and min(H, K/2) >= 2048. (The JAX package's CPU fallback runs these
linears weight-only with bf16 activations instead.)

The weight-only int4 scheme (``W-int4-group-sym-A-bf16-Tpu`` and its aliases)
runs ``int4_matmul`` at every size, as the JAX package does on its
accelerator: the same packed weights and 2-D scales, bf16 activations, the
bias added after the kernel's rounding. Its FFN is GEMM, GELU, GEMM.

The block-scaled fp8 schemes (``W-fp8-block128-*``, ``W-mxfp8-*``) and
mxfp6 (``W-mxfp6-*``) are XLA in the JAX package and torch ops here, no
kernel: ``_mm_fp8_block128`` rescales each k-group's partial product by its
token and channel scales before accumulating it (on the card one
``torch._scaled_mm`` a group), ``_mm_mxfp6`` dequantizes the packed e2m3
weights and runs the Default GEMM. ``Calib`` (``ops/calib.py``) records
activation absmax around the Default GEMM.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..utils.registry import MM_REGISTER
from .cuda.int4_matmul import int4_matmul
from .cuda.w4a8_matmul import ffn_w4a8, w4a8_matmul
from .cuda.w8a8_matmul import ffn_w8a8, int_dot_exact, w8a8_matmul, w8a8_matmul_fullk


def _bias_add(y: torch.Tensor, b: Optional[torch.Tensor], out_dtype) -> torch.Tensor:
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(out_dtype)


def nt_dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ w (out, in)^T with fp32 accumulation and an fp32
    result. Off the CPU the operands stay in x's dtype (bf16 on the tensor
    cores); the CPU widens them to fp32, which gives the same exact products
    and fp32 sums."""
    w = w.to(x.dtype)
    if x.device.type == "cpu" or x.dtype == torch.float32:
        return torch.matmul(x.float(), w.float().t())
    *lead, k = x.shape
    return torch.mm(x.reshape(-1, k), w.t(), out_dtype=torch.float32).reshape(*lead, w.shape[0])


@MM_REGISTER.register("Default")
def mm_default(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """GEMM in the activation dtype with fp32 accumulation, the bias added
    in fp32 before the one rounding to x's dtype."""
    return _bias_add(nt_dot_f32(x, params["w"]), params.get("b"), x.dtype)


@MM_REGISTER.register("Default-Force-FP32")
def mm_fp32(params: Dict, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x.float(), params["w"].float().t())
    if params.get("b") is not None:
        y = y + params["b"].float()
    return y


def quantize_per_token_int8(x: torch.Tensor):
    """Dynamic symmetric per-token int8 quantization (the JAX package's
    XLA path: scale = max(absmax, 1e-8) / 127)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_per_token_fp8(x: torch.Tensor):
    """Dynamic symmetric per-token e4m3 quantization (the JAX package's XLA
    path: scale = max(absmax, 1e-8) / 448, codes (x / scale) cast to
    float8_e4m3fn)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8) / 448.0
    return (xf / scale).to(torch.float8_e4m3fn), scale


_QUANTIZE_PER_TOKEN = {"int8": quantize_per_token_int8, "fp8": quantize_per_token_fp8}


def _mm_w8a8(params: Dict, x: torch.Tensor, kind: str, act: Optional[str] = None) -> torch.Tensor:
    w = params["w"]
    n, k = w.shape[-2:]
    if min(n, k) >= 4096 and not (k % 128 == 0 and k <= 8192):
        return w8a8_matmul(x, w, params["w_scale"], params.get("b"), act=act, kind=kind)
    if min(n, k) >= 4096 or x.device.type == "cuda":
        return w8a8_matmul_fullk(x, w, params["w_scale"], params.get("b"), act=act, kind=kind)
    *lead, _ = x.shape
    q, x_scale = _QUANTIZE_PER_TOKEN[kind](x.reshape(-1, k))
    y = int_dot_exact(q, w) * x_scale * params["w_scale"].float()
    y = y.reshape(*lead, n)
    if act == "gelu":
        if params.get("b") is not None:
            y = y + params["b"].float()
        return F.gelu(y, approximate="tanh").to(x.dtype)
    return _bias_add(y, params.get("b"), x.dtype)


def _mm_int8(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return _mm_w8a8(params, x, "int8")


def _mm_fp8(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return _mm_w8a8(params, x, "fp8")


_W8A8_KIND = {_mm_int8: "int8", _mm_fp8: "fp8"}

for _alias in [
    "W-int8-channel-sym-A-int8-channel-sym-dynamic-Vllm",
    "W-int8-channel-sym-A-int8-channel-sym-dynamic-Q8F",
    "W-int8-channel-sym-A-int8-channel-sym-dynamic-Sgl-ActVllm",
    "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu",
]:
    MM_REGISTER.register(_alias, _mm_int8)

for _alias in [
    "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Vllm",
    "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Q8F",
    "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Vllm-ActSgl",
    "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Sgl-ActVllm",
    "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Sgl",
    "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Tpu",
]:
    MM_REGISTER.register(_alias, _mm_fp8)


def _mm_int4_a8(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """int4 weights (nibble-packed, per-(channel, group) scales) x dynamic
    per-(token, group) int8 activations, at every size."""
    return w4a8_matmul(x, params["w"], params["w_scale"], params.get("b"))


for _alias in [
    "W-int4-group-sym-A-int8-token-dynamic-Tpu",
    "W-nvfp4-A-nvfp4-dynamic-Tpu",
]:
    MM_REGISTER.register(_alias, _mm_int4_a8)


def _mm_int4(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Weight-only int4 (per-(channel, group) scales), bf16 activations."""
    return int4_matmul(x, params["w"], params["w_scale"], params.get("b"))


for _alias in [
    "W-int4-group-sym-A-bf16-Tpu",
    "W-int4-group128-sym-A-bf16",
    "W-nvfp4-A-bf16-Tpu",
]:
    MM_REGISTER.register(_alias, _mm_int4)


def quantize_per_token_group_fp8(x: torch.Tensor, group: int = 128):
    """Dynamic per-(token, k-group) e4m3 quantization (the JAX package's
    ``quantize_per_token_group_fp8``): q (..., in) e4m3 and scales (...,
    in / group) fp32, scale = max(absmax, 1e-8) / 448 per group."""
    g = x.shape[-1] // group
    xf = x.float().reshape(*x.shape[:-1], g, group)
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8) / 448.0
    return (xf / scale).to(torch.float8_e4m3fn).reshape(x.shape), scale[..., 0]


def _group_scaled_dot(q: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                      group: int) -> torch.Tensor:
    """sum over k-groups g of (q_g . w_g) * (x_scale_g * ws_g) in fp32, for
    q (M, in) and w (out, in) e4m3, x_scale (M, G), ws (out, G). On the CPU,
    as the JAX scan: fp32 products of the codes, the group's partial times
    the outer product of its scales, added to the accumulator. On the card
    each group's partial is one ``torch._scaled_mm`` of the codes with an
    fp32 result (unit scales, no fast accumulation), scaled in place by the
    token's and then the channel's scale and added in place: one (M, out)
    fp32 accumulator and one partial, whatever the number of groups."""
    m, n, g = q.shape[0], w.shape[0], x_scale.shape[-1]
    if q.device.type == "cpu":
        acc = torch.zeros((m, n), dtype=torch.float32, device=q.device)
        for i in range(g):
            sl = slice(i * group, (i + 1) * group)
            part = torch.matmul(q[:, sl].float(), w[:, sl].float().t())
            acc += part * (x_scale[:, i, None] * ws[None, :, i])
        return acc
    # group-major copies: each group's codes contiguous, as cuBLAS's fp8 GEMM wants them; out_features
    # zero-padded to a multiple of 16, which it also wants
    pad = (-n) % 16
    wb = F.pad(w.view(torch.uint8), (0, 0, 0, pad)) if pad else w.view(torch.uint8)
    qg = q.view(torch.uint8).reshape(m, g, group).transpose(0, 1).contiguous().view(torch.float8_e4m3fn)
    wg = wb.reshape(n + pad, g, group).transpose(0, 1).contiguous().view(torch.float8_e4m3fn)
    one = torch.ones((), dtype=torch.float32, device=q.device)
    xs, wsc = x_scale.t().contiguous(), F.pad(ws, (0, 0, 0, pad)).t().contiguous()
    acc = torch.zeros((m, n + pad), dtype=torch.float32, device=q.device)
    for i in range(g):
        part = torch._scaled_mm(qg[i], wg[i].t(), scale_a=one, scale_b=one, out_dtype=torch.float32,
                                use_fast_accum=False)
        acc.add_(part.mul_(xs[i][:, None]).mul_(wsc[i][None, :]))
    return acc[:, :n]


def _mm_fp8_block128(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Block-scaled fp8 (the JAX package's ``_mm_fp8_block128``): weights
    e4m3 with (out/128, in/128) block scales, activations e4m3 with
    per-(token, 128-group) scales, each k-group's partial product rescaled
    before it is accumulated (``_group_scaled_dot``).

    The mx layout (per-(channel, in/32) power-of-two scales, the ``mxfp8``
    scheme) is told by ``w_scale`` rows == out_features; its activation
    group follows the weight's. In the block-128 layout the group is 128 by
    definition: where in_features % 128 != 0 x and w are zero-padded to the
    block grid. A 1-D (per-channel) scale degrades to the per-channel fp8
    path (row 3f)."""
    ws = params["w_scale"]
    if ws.ndim == 1:
        return _mm_fp8(params, x)
    w = params["w"]
    out_f, in_f = w.shape
    if ws.shape[0] == out_f:
        group = in_f // ws.shape[1]
        ws_full = ws.float()
    else:
        group = 128
        pad = (-in_f) % group
        if pad:
            x = F.pad(x, (0, pad))
            w = F.pad(w.view(torch.uint8), (0, pad)).view(torch.float8_e4m3fn)  # e4m3 0 is byte 0
            in_f += pad
        ws_full = torch.repeat_interleave(ws.float(), 128, dim=0)[:out_f]
    *lead, _ = x.shape
    q, x_scale = quantize_per_token_group_fp8(x.reshape(-1, in_f), group)
    acc = _group_scaled_dot(q, x_scale, w, ws_full, group).reshape(*lead, out_f)
    return _bias_add(acc, params.get("b"), x.dtype)


for _alias in [
    "W-fp8-block128-sym-A-fp8-channel-group128-sym-dynamic-Deepgemm",
    "W-fp8-block128-sym-A-fp8-channel-group128-sym-dynamic-Deepgemm-ActSgl",
    "W-fp8-block128-sym-A-fp8-channel-group128-sym-dynamic-Tpu",
    "W-mxfp8-A-mxfp8-dynamic-Tpu",
    "W-fp8-block128-A-fp8-block128-dynamic-Tpu",
]:
    MM_REGISTER.register(_alias, _mm_fp8_block128)


def unpack_fp6_e2m3(packed: torch.Tensor, n_cols: int) -> torch.Tensor:
    """(rows, 3 n/4) uint8 -> (rows, n) fp32: four 6-bit codes a 3-byte
    little-endian group, code s|ee|mmm -> (-1)^s (e == 0 ? m/8 : (1 + m/8)
    2^(e-1))."""
    rows = packed.shape[0]
    trip = packed.reshape(rows, -1, 3).to(torch.int32)
    bits = trip[..., 0] | (trip[..., 1] << 8) | (trip[..., 2] << 16)
    codes = torch.stack([(bits >> (6 * i)) & 63 for i in range(4)], dim=-1).reshape(rows, n_cols)
    sign = torch.where(codes & 32 != 0, -1.0, 1.0)
    e = (codes >> 3) & 3
    m = (codes & 7).float()
    mag = torch.where(e == 0, m * 0.125, (1.0 + m * 0.125) * torch.exp2((e - 1).float()))
    return sign * mag


def _mm_mxfp6(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """mxfp6 weights (packed e2m3 codes, per-(channel, in/32) power-of-two
    scales), dequantized to x's dtype, then the Default GEMM with fp32
    accumulation: weight-only, as in the JAX package."""
    w, ws = params["w"], params["w_scale"]
    out_f, in_f = w.shape[0], x.shape[-1]
    wf = unpack_fp6_e2m3(w, in_f).reshape(out_f, ws.shape[1], -1) * ws.float()[:, :, None]
    return _bias_add(nt_dot_f32(x, wf.reshape(out_f, in_f)), params.get("b"), x.dtype)


for _alias in ["W-mxfp6-A-mxfp8-dynamic-Tpu", "W-mxfp6-A-bf16-Tpu"]:
    MM_REGISTER.register(_alias, _mm_mxfp6)


def mm_gelu(mm_fn, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """matmul + tanh-GELU (fused into the GEMM epilogue on the int8 and fp8
    paths)."""
    kind = _W8A8_KIND.get(mm_fn)
    if kind:
        return _mm_w8a8(params, x, kind, act="gelu")
    h = mm_fn(params, x)
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)


def mm_ffn(mm_fn, p0: Dict, p2: Dict, x: torch.Tensor) -> torch.Tensor:
    """Whole FFN (mm -> gelu -> mm): one ``ffn_w8a8`` call on the int8 and
    fp8 paths at min(H, K) >= 1024, one ``ffn_w4a8`` call on the int4 path
    with 2-D scales at min(H, K/2) >= 2048 (w0's stored shape), else two
    GEMMs around the GELU."""
    n, k = p0["w"].shape[-2:]
    kind = _W8A8_KIND.get(mm_fn)
    if kind and min(n, k) >= 1024:
        return ffn_w8a8(x, p0["w"], p0["w_scale"], p0.get("b"), p2["w"], p2["w_scale"], p2.get("b"), kind=kind)
    if mm_fn is _mm_int4_a8 and p0["w_scale"].ndim == 2 and min(n, k) >= 2048:
        return ffn_w4a8(x, p0["w"], p0["w_scale"], p0.get("b"), p2["w"], p2["w_scale"], p2.get("b"))
    h = mm_gelu(mm_fn, p0, x)
    return mm_fn(p2, h)


def resolve_mm(mm_type: str):
    """Resolve an mm_type string to its apply function (every key of the JAX
    package's table; an unknown one raises ``KeyError``)."""
    return MM_REGISTER[mm_type]


from . import calib  # noqa: E402,F401  (registers "Calib")
