"""Flash attention: CUDA kernel wrappers and their plain PyTorch versions.

Port of ``lightx2v_tpu/ops/pallas/flash_attention.py``: ``flash_attention``
and ``flash_attention_fused_rope`` (kernel source ``csrc/flash_attention.cu``).
Public functions keep the JAX (B, S, N, D) layout. On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it runs the plain
version, which repeats the kernel's arithmetic (q scaled by scale*log2(e)
and re-rounded to bf16, exp2 softmax in fp32, P rounded to bf16 before P.V).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

LOG2E = 1.4426950408889634
HEAD_DIM = 128

LAUNCHES = {"flash_attention": 0, "flash_attention_fused_rope": 0}


def _kv_limit(kv_len, sk: int) -> int:
    if kv_len is None:
        return sk
    return min(int(kv_len), sk)


# ---------------------------------------------------------------------------
# plain versions


def _rotate_half_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, s_rope: int,
                       gain: float) -> torch.Tensor:
    """x (B, S, N, D) -> fp32 ((x*[c|c] + roll_half(x)*[-s|s]) * gain); rows
    at or past s_rope keep the identity rotation."""
    xf = x.float()
    d2 = xf.shape[-1] // 2
    s = xf.shape[1]
    c = torch.ones((s, d2), dtype=torch.float32, device=x.device)
    sn = torch.zeros((s, d2), dtype=torch.float32, device=x.device)
    n = min(s_rope, s)
    c[:n] = cos[:n].float()
    sn[:n] = sin[:n].float()
    c, sn = c[None, :, None, :], sn[None, :, None, :]
    x1, x2 = xf[..., :d2], xf[..., d2:]
    lo = x1 * c + x2 * (-sn)
    hi = x2 * c + x1 * sn
    return torch.cat([lo, hi], dim=-1) * gain


def _attend_plain(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_limit: int) -> torch.Tensor:
    """qs: (B, Sq, N, D) bf16 already scaled into the exp2 domain."""
    b, sq, n, d = qs.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=qs.device)
    if kv_limit <= 0:
        return out.zero_()
    kf = k[:, :kv_limit].float().permute(0, 2, 3, 1)  # (B, N, D, Sk')
    vf = v[:, :kv_limit].float().permute(0, 2, 1, 3)  # (B, N, Sk', D)
    rows = max(1, (1 << 28) // max(1, b * n * sk))
    for r0 in range(0, sq, rows):
        qc = qs[:, r0:r0 + rows].float().permute(0, 2, 1, 3)  # (B, N, r, D)
        s = torch.matmul(qc, kf)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(torch.bfloat16).float(), vf) / torch.clamp_min(l, 1e-30)
        out[:, r0:r0 + rows] = o.permute(0, 2, 1, 3).to(torch.bfloat16)
    return out


def flash_attention_plain(q, k, v, kv_len=None) -> torch.Tensor:
    gain = (1.0 / math.sqrt(q.shape[-1])) * LOG2E
    qs = (q.float() * gain).to(torch.bfloat16)
    return _attend_plain(qs, k, v, _kv_limit(kv_len, k.shape[1]))


def flash_attention_fused_rope_plain(q, k, v, cos, sin, kv_len=None) -> torch.Tensor:
    gain = (1.0 / math.sqrt(q.shape[-1])) * LOG2E
    s_rope = min(cos.shape[0], q.shape[1])
    qs = _rotate_half_plain(q, cos, sin, s_rope, gain).to(torch.bfloat16)
    kr = _rotate_half_plain(k, cos, sin, s_rope, 1.0).to(torch.bfloat16)
    return _attend_plain(qs, kr, v, _kv_limit(kv_len, k.shape[1]))


# ---------------------------------------------------------------------------
# CUDA kernel


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dev: torch.device):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name} must be (B, S, N, {HEAD_DIM}), got {tuple(t.shape)}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a unit-stride head dim and 16-byte aligned rows, "
                         f"got strides {t.stride()}")


def _launch(q, k, v, cos, sin, kv_len, rope: bool) -> torch.Tensor:
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, dev)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != n:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    s_rope = 0
    cptr = sptr = None
    if rope:
        if (cos.device != dev or sin.device != dev or cos.dtype != torch.float32
                or sin.dtype != torch.float32 or cos.shape != sin.shape
                or cos.dim() != 2 or cos.shape[1] != d // 2
                or not cos.is_contiguous() or not sin.is_contiguous()):
            raise ValueError("rope tables must be contiguous fp32 (S_rope, D/2) on the q device")
        s_rope = min(cos.shape[0], sq)
        cptr, sptr = cos.data_ptr(), sin.data_ptr()
    out = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=dev)
    gain = (1.0 / math.sqrt(d)) * LOG2E
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), cptr, sptr, s_rope,
                 b, n, sq, sk, _kv_limit(kv_len, sk),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 gain, int(rope), stream)
    _build.check(err, "flash_attention_fused_rope" if rope else "flash_attention")
    LAUNCHES["flash_attention_fused_rope" if rope else "flash_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q/k/v (B, S, N, 128) bf16 -> (B, Sq, N, 128); keys at or past
    ``kv_len`` are masked."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len)
    return _launch(q, k, v, None, None, kv_len, rope=False)


def flash_attention_fused_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               cos: torch.Tensor, sin: torch.Tensor,
                               kv_len: Optional[int] = None) -> torch.Tensor:
    """As ``flash_attention`` with q and k (half-split pair layout) rotated
    in-kernel by the (S_rope, D/2) cos/sin tables; positions past S_rope
    keep the identity rotation."""
    if q.device.type == "cpu":
        return flash_attention_fused_rope_plain(q, k, v, cos, sin, kv_len)
    return _launch(q, k, v, cos, sin, kv_len, rope=True)
