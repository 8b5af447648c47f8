"""Matmul ("mm") op table (counterpart of ``lightx2v_tpu.ops.linear``).

Each scheme is a function ``apply(params, x) -> y`` resolved through
MM_REGISTER under the same mm_type strings as the JAX package. Weights keep
the checkpoint's (out, in) layout. The int8 schemes mirror the JAX dispatch
exactly, so a given shape gets the same activation-scale contract:

* min(N, K) >= 4096 and K <= 8192 (K % 128 == 0): ``w8a8_matmul_fullk``
  (CUDA kernel; its plain version on the CPU);
* min(N, K) >= 4096 and K > 8192: the k-blocked ``w8a8_matmul``, not
  ported yet, so it raises;
* smaller dims: per-token quantization in plain torch ops, as the JAX
  package leaves that path to XLA;
* the FFN runs ``ffn_w8a8`` whole when min(H, K) >= 1024, else GEMM, GELU,
  GEMM.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..utils.registry import MM_REGISTER
from .cuda.w8a8_matmul import ffn_w8a8, int_dot_exact, w8a8_matmul_fullk


def _bias_add(y: torch.Tensor, b: Optional[torch.Tensor], out_dtype) -> torch.Tensor:
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(out_dtype)


def _nt_dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ w (out, in)^T in fp32 (exact products of the inputs'
    values, fp32 accumulation)."""
    return torch.matmul(x.float(), w.float().t())


@MM_REGISTER.register("Default")
def mm_default(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """GEMM in the activation dtype with fp32 accumulation."""
    w = params["w"].to(x.dtype)
    return _bias_add(_nt_dot_f32(x, w), params.get("b"), x.dtype)


@MM_REGISTER.register("Default-Force-FP32")
def mm_fp32(params: Dict, x: torch.Tensor) -> torch.Tensor:
    y = _nt_dot_f32(x, params["w"])
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


def _mm_w8a8(params: Dict, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    w = params["w"]
    n, k = w.shape[-2:]
    if min(n, k) >= 4096:
        if k % 128 == 0 and k <= 8192:
            return w8a8_matmul_fullk(x, w, params["w_scale"], params.get("b"), act=act)
        raise NotImplementedError(
            f"int8 linear with K={k} needs the k-blocked w8a8_matmul kernel, which is not "
            "ported yet (ROADMAP.md, Queue 2: w8a8_matmul)")
    *lead, _ = x.shape
    q, x_scale = quantize_per_token_int8(x.reshape(-1, k))
    y = int_dot_exact(q, w) * x_scale * params["w_scale"].float()
    y = y.reshape(*lead, n)
    if act == "gelu":
        if params.get("b") is not None:
            y = y + params["b"].float()
        return F.gelu(y, approximate="tanh").to(x.dtype)
    return _bias_add(y, params.get("b"), x.dtype)


def _mm_int8(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return _mm_w8a8(params, x)


for _alias in [
    "W-int8-channel-sym-A-int8-channel-sym-dynamic-Vllm",
    "W-int8-channel-sym-A-int8-channel-sym-dynamic-Q8F",
    "W-int8-channel-sym-A-int8-channel-sym-dynamic-Sgl-ActVllm",
    "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu",
]:
    MM_REGISTER.register(_alias, _mm_int8)


def mm_gelu(mm_fn, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """matmul + tanh-GELU (fused into the GEMM epilogue on the int8 path)."""
    if mm_fn is _mm_int8:
        return _mm_w8a8(params, x, act="gelu")
    h = mm_fn(params, x)
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)


def mm_ffn(mm_fn, p0: Dict, p2: Dict, x: torch.Tensor) -> torch.Tensor:
    """Whole FFN (mm -> gelu -> mm): one ``ffn_w8a8`` call on the int8 path
    at min(H, K) >= 1024, else two GEMMs around the GELU."""
    n, k = p0["w"].shape[-2:]
    if mm_fn is _mm_int8 and min(n, k) >= 1024:
        return ffn_w8a8(x, p0["w"], p0["w_scale"], p0.get("b"), p2["w"], p2["w_scale"], p2.get("b"))
    h = mm_gelu(mm_fn, p0, x)
    return mm_fn(p2, h)


def resolve_mm(mm_type: str):
    """Resolve an mm_type string to its apply function. Schemes of the JAX
    package that this port has not reached yet raise here."""
    if mm_type not in MM_REGISTER:
        raise NotImplementedError(
            f"mm_type {mm_type!r} is not ported yet (ROADMAP.md, Queue 1 item 2: ops/linear.py)")
    return MM_REGISTER[mm_type]
