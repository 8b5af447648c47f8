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

The int8 and fp8 (e4m3) per-channel schemes mirror the JAX dispatch
exactly, so a given shape gets the same activation-scale contract:

* min(N, K) >= 4096 and K <= 8192 (K % 128 == 0): ``w8a8_matmul_fullk``
  (CUDA kernel; its plain version on the CPU);
* min(N, K) >= 4096 and K > 8192 (K % 128 == 0): the k-blocked
  ``w8a8_matmul`` (CUDA kernel), one act scale per (token, k-block);
* smaller dims: per-token quantization in plain torch ops, as the JAX
  package leaves that path to XLA (int8: absmax / 127, fp8: absmax / 448 --
  a division here, the kernels multiply by the reciprocal), then an exact
  dot of the codes;
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
    if min(n, k) >= 4096:
        if k % 128 == 0 and k <= 8192:
            return w8a8_matmul_fullk(x, w, params["w_scale"], params.get("b"), act=act, kind=kind)
        return w8a8_matmul(x, w, params["w_scale"], params.get("b"), act=act, kind=kind)
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
    """Resolve an mm_type string to its apply function. Schemes of the JAX
    package that this port has not reached yet raise here."""
    if mm_type not in MM_REGISTER:
        raise NotImplementedError(
            f"mm_type {mm_type!r} is not ported yet (ROADMAP.md, Queue 1 item 2: ops/linear.py)")
    return MM_REGISTER[mm_type]
