"""Flash attention: CUDA kernel wrappers and their plain PyTorch versions.

Port of ``lightx2v_tpu/ops/pallas/flash_attention.py``: ``flash_attention``,
``flash_attention_fused_rope`` and ``flash_attention_with_lse`` (kernel
source ``csrc/flash_attention.cu``). All three launch one dense kernel;
``flash_attention_fused_rope`` first rotates q and k once in the RoPE pass
``rope_rotate`` (its own kernel and counter).
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
LN2 = 0.6931471805599453
HEAD_DIM = 128

LAUNCHES = {"flash_attention": 0, "flash_attention_fused_rope": 0, "flash_attention_with_lse": 0, "rope_rotate": 0}


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


def _attend_plain(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_limit: int,
                  lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """qs: (B, Sq, N, D) bf16 already scaled into the exp2 domain. ``lse``
    (B, Sq, N) fp32, when given, receives m*ln2 + log(max(l, 1e-30))."""
    b, sq, n, d = qs.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=qs.device)
    if kv_limit <= 0:
        if lse is not None:
            lse.fill_(float("-inf"))
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
        if lse is not None:
            lse[:, r0:r0 + rows] = (m * LN2 + torch.log(torch.clamp_min(l, 1e-30)))[..., 0].permute(0, 2, 1)
    return out


def flash_attention_plain(q, k, v, kv_len=None) -> torch.Tensor:
    gain = (1.0 / math.sqrt(q.shape[-1])) * LOG2E
    qs = (q.float() * gain).to(torch.bfloat16)
    return _attend_plain(qs, k, v, _kv_limit(kv_len, k.shape[1]))


def flash_attention_with_lse_plain(q, k, v, kv_len=None):
    """(out, lse): ``flash_attention_plain`` plus the natural-log row
    log-sum-exp of the scaled logits. Keys are masked by index; the TPU
    kernel's closed-form removal of its zero pad rows' mass gives the same
    sums."""
    gain = (1.0 / math.sqrt(q.shape[-1])) * LOG2E
    qs = (q.float() * gain).to(torch.bfloat16)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return _attend_plain(qs, k, v, _kv_limit(kv_len, k.shape[1]), lse), lse


def flash_attention_fused_rope_plain(q, k, v, cos, sin, kv_len=None) -> torch.Tensor:
    gain = (1.0 / math.sqrt(q.shape[-1])) * LOG2E
    s_rope = min(cos.shape[0], q.shape[1])
    qs = _rotate_half_plain(q, cos, sin, s_rope, gain).to(torch.bfloat16)
    kr = _rotate_half_plain(k, cos, sin, s_rope, 1.0).to(torch.bfloat16)
    return _attend_plain(qs, kr, v, _kv_limit(kv_len, k.shape[1]))


def _s_rope(cos, q) -> int:
    return min(cos.shape[0], q.shape[1])


def rope_rotate_plain(q, k, cos, sin, gain: float):
    """(bf16(rotate(q) * gain), bf16(rotate(k))), both rotated by the first
    min(S_rope, Sq) table rows: the RoPE pass of the card path."""
    s_rope = _s_rope(cos, q)
    return (_rotate_half_plain(q, cos, sin, s_rope, gain).to(torch.bfloat16),
            _rotate_half_plain(k, cos, sin, s_rope, 1.0).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# CUDA kernels


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_bf16.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_bf16.argtypes = [p] * 5 + [i] * 5 + [ll] * 12 + [ctypes.c_float, p]
        lib.rope_rotate_bf16.argtypes = [p] * 4 + [i] * 5 + [ll] * 6 + [p] * 2 + [ctypes.c_float, p]
        lib.flash_attention_bf16.restype = lib.rope_rotate_bf16.restype = ctypes.c_int
    return lib


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


def _check_qkv(q, k, v):
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, dev)
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")


def _launch(q, k, v, kv_len, gain: float, name: str, lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense kernel on q/k/v (already checked); q is scaled by ``gain``
    in the kernel (1.0: left as it is)."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      None if lse is None else lse.data_ptr(), b, n, sq, sk, _kv_limit(kv_len, sk),
                                      *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], gain,
                                      stream)
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


def _gain(d: int) -> float:
    return (1.0 / math.sqrt(d)) * LOG2E


def rope_rotate(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, gain: float):
    """The RoPE pass: q/k (B, S, N, 128) bf16 by stride -> contiguous
    (bf16(rotate(q) * gain), bf16(rotate(k))) by the (S_rope, 64) fp32
    tables; positions at or past min(S_rope, Sq) keep the identity
    rotation. Bit-identical to ``rope_rotate_plain``."""
    if q.device.type == "cpu":
        return rope_rotate_plain(q, k, cos, sin, gain)
    dev = q.device
    _check(q, "q", dev)
    _check(k, "k", dev)
    if (cos.device != dev or sin.device != dev or cos.dtype != torch.float32
            or sin.dtype != torch.float32 or cos.shape != sin.shape
            or cos.dim() != 2 or cos.shape[1] != HEAD_DIM // 2
            or not cos.is_contiguous() or not sin.is_contiguous()):
        raise ValueError("rope tables must be contiguous fp32 (S_rope, D/2) on the q device")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)}")
    b, sq, n, _ = q.shape
    qo = torch.empty(q.shape, dtype=torch.bfloat16, device=dev)
    ko = torch.empty(k.shape, dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().rope_rotate_bf16(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(), _s_rope(cos, q), b, n,
                                  sq, k.shape[1], *q.stride()[:3], *k.stride()[:3], qo.data_ptr(), ko.data_ptr(),
                                  gain, stream)
    _build.check(err, "rope_rotate")
    LAUNCHES["rope_rotate"] += 1
    return qo, ko


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q/k/v (B, S, N, 128) bf16 -> (B, Sq, N, 128); keys at or past
    ``kv_len`` are masked."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len)
    _check_qkv(q, k, v)
    return _launch(q, k, v, kv_len, _gain(q.shape[-1]), "flash_attention")


def flash_attention_fused_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               cos: torch.Tensor, sin: torch.Tensor,
                               kv_len: Optional[int] = None) -> torch.Tensor:
    """As ``flash_attention`` with q and k (half-split pair layout) rotated
    by the (S_rope, D/2) cos/sin tables; positions past S_rope keep the
    identity rotation. On the card the RoPE pass writes rotated, scaled
    copies of q and k (2 * B * S * N * D bf16 of scratch, freed on return)
    and the dense kernel runs on them with gain 1."""
    if q.device.type == "cpu":
        return flash_attention_fused_rope_plain(q, k, v, cos, sin, kv_len)
    _check_qkv(q, k, v)
    qr, kr = rope_rotate(q, k, cos, sin, _gain(q.shape[-1]))
    return _launch(qr, kr, v, kv_len, 1.0, "flash_attention_fused_rope")


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             kv_len: Optional[int] = None):
    """``flash_attention`` that also returns lse (B, Sq, N) fp32, the
    natural-log row log-sum-exp of the scaled logits (-inf for a row whose
    keys are all masked): the partial that ``merge_partials`` combines."""
    if q.device.type == "cpu":
        return flash_attention_with_lse_plain(q, k, v, kv_len)
    _check_qkv(q, k, v)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return _launch(q, k, v, kv_len, _gain(q.shape[-1]), "flash_attention_with_lse", lse), lse
