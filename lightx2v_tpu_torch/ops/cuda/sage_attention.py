"""Int8-QK (SageAttention-style) flash attention: CUDA kernel wrapper and its
plain PyTorch version.

Port of ``lightx2v_tpu/ops/pallas/sage_attention.py:sage_attention`` (kernel
source ``csrc/sage_attention.cu``). q and k are quantized to int8 per token
row over the head dim from their raw bf16 values (``sc = max(absmax, 1e-6) *
(1/127)``, ``clip(round(x / sc), +-127)``, IEEE division, round-half-even);
the logits are the exact int32 code product times ``(q_sc * scale * log2e)``
times ``k_sc`` in fp32; softmax in the exp2 domain in fp32; P rounded to bf16
before P.V; output ``acc / max(l, 1e-30)``. Public functions keep the JAX
(B, S, N, D) layout. On a CUDA tensor the wrapper launches the kernels or
raises; on a CPU tensor it runs the plain version, which repeats that
arithmetic with the same int32 logits (an exact integer dot), so only the
logits' last roundings (the kernel applies q's scale in its exp2 FMA), the
softmax's running maxima and the summation order differ from the kernel.
Keys at or past ``kv_len`` are masked by index; the TPU kernel's closed-form
removal of its zero pad rows' mass gives the same sums.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .flash_attention import HEAD_DIM, LOG2E, _check, _check_qkv, _kv_limit

LAUNCHES = {"sage_attention": 0}


def quant_rows_plain(x: torch.Tensor):
    """(..., D) -> int8 codes (..., D) and fp32 scales (..., 1), per row."""
    xf = x.float()
    sc = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-6) * (1.0 / 127.0)
    return torch.clamp(torch.round(xf / sc), -127, 127).to(torch.int8), sc


def sage_attention_plain(q, k, v, kv_len=None) -> torch.Tensor:
    b, sq, n, d = q.shape
    sk = k.shape[1]
    kv_limit = _kv_limit(kv_len, sk)
    out = torch.zeros((b, sq, n, d), dtype=torch.bfloat16, device=q.device)
    if kv_limit <= 0:
        return out
    q8, qs = quant_rows_plain(q)
    k8, ks = quant_rows_plain(k[:, :kv_limit])
    qa = (qs * ((1.0 / math.sqrt(d)) * LOG2E)).permute(0, 2, 1, 3)  # (B, N, Sq, 1)
    ksr = ks.permute(0, 2, 3, 1)  # (B, N, 1, Sk')
    kd = k8.double().permute(0, 2, 3, 1)  # (B, N, D, Sk')
    vf = v[:, :kv_limit].float().permute(0, 2, 1, 3)
    rows = max(1, (1 << 27) // max(1, b * n * kv_limit))
    for r0 in range(0, sq, rows):
        si = torch.matmul(q8[:, r0:r0 + rows].double().permute(0, 2, 1, 3), kd).float()  # exact int32 sums
        s = si * qa[:, :, r0:r0 + rows] * ksr
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        o = torch.matmul(p.to(torch.bfloat16).float(), vf) / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
        out[:, r0:r0 + rows] = o.permute(0, 2, 1, 3).to(torch.bfloat16)
    return out


def _lib():
    lib = _build.load("sage_attention")
    if lib.sage_attention_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sage_quant_rows.argtypes = [p, p, p, i, i, i, i, ll, ll, ll, p]
        lib.sage_attention_fwd.argtypes = [p, p, i, p, p, i, p, p] + [i] * 5 + [ll] * 6 + [ctypes.c_float, p]
        lib.sage_quant_rows.restype = lib.sage_attention_fwd.restype = ctypes.c_int
    return lib


def _quant_rows(lib, x: torch.Tensor, stream):
    """The row quantization pre-pass: codes (B, S, N, D) int8 and scales
    (B, N, pitch) fp32, head-major so that a key tile's scales are
    contiguous; the pitch is S rounded up to 4 (16-byte rows, as TMA reads
    them) and the columns past S are never read."""
    b, s, n, d = x.shape
    codes = torch.empty((b, s, n, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((b, n, -(-s // 4) * 4), dtype=torch.float32, device=x.device)
    _build.check(lib.sage_quant_rows(x.data_ptr(), codes.data_ptr(), scales.data_ptr(), b, s, n, scales.shape[2],
                                     *x.stride()[:3], stream), "sage_attention quantize")
    return codes, scales


def _attend(lib, q8, qs, k8, ks, v, kv_len, stream, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The attention kernel on the pre-pass's codes and scales, into ``out``
    (checked as v is) or a new tensor."""
    b, sq, n, d = q8.shape
    sk = k8.shape[1]
    if out is None:
        out = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=q8.device)
    else:
        _check(out, "out", q8.device)
        if out.shape != q8.shape:
            raise ValueError(f"out must be {tuple(q8.shape)}, got {tuple(out.shape)}")
    gain = (1.0 / math.sqrt(HEAD_DIM)) * LOG2E
    err = lib.sage_attention_fwd(q8.data_ptr(), qs.data_ptr(), qs.shape[2], k8.data_ptr(), ks.data_ptr(),
                                 ks.shape[2], v.data_ptr(), out.data_ptr(), b, n, sq, sk, _kv_limit(kv_len, sk),
                                 *v.stride()[:3], *out.stride()[:3], gain, stream)
    _build.check(err, "sage_attention")
    LAUNCHES["sage_attention"] += 1
    return out


def sage_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: Optional[int] = None) -> torch.Tensor:
    """q/k/v (B, S, N, 128) bf16 -> (B, Sq, N, 128); keys at or past
    ``kv_len`` are masked."""
    if q.device.type == "cpu":
        return sage_attention_plain(q, k, v, kv_len)
    _check_qkv(q, k, v)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    q8, qs = _quant_rows(lib, q, stream)
    k8, ks = _quant_rows(lib, k, stream)
    return _attend(lib, q8, qs, k8, ks, v, kv_len, stream)
