"""Attention dispatch (counterpart of ``lightx2v_tpu.ops.attention``).

* ``flash_attn2`` / ``flash_attn3`` -> the flash-attention kernel
  (ops/cuda/flash_attention.py), with RoPE fused in when rope tables are
  passed (arch.rope_fused: q/k in half-split pair layout);
* ``Sparge`` / ``sparge`` / ``sparge_attn`` -> Sparge block selection and
  the per-head block-sparse kernel (ops/sparge.py);
* ``sage_attn2`` -> the int8-QK kernel (ops/cuda/sage_attention.py);
* ``radial_attn`` -> radial attention (ops/radial.py): the radial block mask
  through the shared-mask block-sparse kernel, or the two-pass execution;
* ``torch_sdpa`` / ``xla`` -> plain softmax attention in torch ops;
* ``xla_chunked`` -> online-softmax attention over 2048-token chunks in
  torch ops (``attn_chunked``).

All functions take q, k, v of shape (B, S, N, D) and return (B, S, N, D) in
the input dtype; softmax statistics are fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils.registry import ATTN_REGISTER
from .cuda.flash_attention import flash_attention, flash_attention_fused_rope
from .cuda.sage_attention import sage_attention
from .radial import radial_attention
from .rope import apply_rope_half
from .sparge import sparge_attention


def attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len=None) -> torch.Tensor:
    """Softmax attention that materializes the (S_q, S_k) logits; keys at or
    past ``kv_len`` are masked."""
    if kv_len is not None:
        kv = int(kv_len)
        k, v = k[:, :kv], v[:, :kv]
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attn_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len=None, q_chunk: int = 2048,
                 k_chunk: int = 2048) -> torch.Tensor:
    """Online-softmax attention in torch ops (the JAX package's
    ``attn_xla_chunked``, an XLA scan there, no kernel): per query chunk, a
    running max, sum and fp32 accumulator over key chunks, so the logits held
    at once are (B, N, q_chunk, k_chunk). Keys at or past ``kv_len`` are
    masked; P is rounded to v's dtype before the PV product, as there."""
    if kv_len is not None:
        kv = int(kv_len)
        k, v = k[:, :kv], v[:, :kv]
    b, sq, n, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    for q0 in range(0, sq, q_chunk):
        qi = q[:, q0:q0 + q_chunk]
        m = torch.full((b, n, qi.shape[1]), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, n, qi.shape[1], d), dtype=torch.float32, device=q.device)
        for k0 in range(0, sk, k_chunk):
            kc, vc = k[:, k0:k0 + k_chunk], v[:, k0:k0 + k_chunk]
            s = torch.einsum("bqnd,bknd->bnqk", qi.float(), kc.float()) * scale
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bnqk,bknd->bnqd", p.to(vc.dtype).float(), vc.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, q0:q0 + q_chunk] = (acc / l.clamp_min(1e-20)[..., None]).transpose(1, 2).to(q.dtype)
    return out


def _dispatch_flash(q, k, v, kv_len: Optional[int] = None, rope_cos=None, rope_sin=None, **kw):
    if rope_cos is not None:
        return flash_attention_fused_rope(q, k, v, rope_cos, rope_sin, kv_len=kv_len)
    return flash_attention(q, k, v, kv_len=kv_len)


def _dispatch_sparge(q, k, v, kv_len: Optional[int] = None, keep_ratio=0.3, l1=0.07, block_q=2048,
                     block_k=1024, **kw):
    return sparge_attention(q, k, v, keep_ratio=keep_ratio, l1=l1, block_q=block_q, block_k=block_k)


def _dispatch_sage(q, k, v, kv_len: Optional[int] = None, **kw):
    return sage_attention(q, k, v, kv_len=kv_len)


def _dispatch_radial(q, k, v, kv_len: Optional[int] = None, mask_map=None, sparsity_type="radial",
                     decay_factor=1.0, block_q=2048, block_k=1024, **kw):
    return radial_attention(q, k, v, mask_map=mask_map, sparsity_type=sparsity_type,
                            decay_factor=decay_factor, block_q=block_q, block_k=block_k)


ATTN_REGISTER.register(["flash_attn2", "flash_attn3"], _dispatch_flash)
ATTN_REGISTER.register("sage_attn2", _dispatch_sage)
ATTN_REGISTER.register("radial_attn", _dispatch_radial)
ATTN_REGISTER.register(["Sparge", "sparge", "sparge_attn"], _dispatch_sparge)
ATTN_REGISTER.register(["torch_sdpa", "xla"], lambda q, k, v, kv_len=None, **kw: attn_plain(q, k, v, kv_len))
ATTN_REGISTER.register("xla_chunked", lambda q, k, v, kv_len=None, **kw: attn_chunked(q, k, v, kv_len))


def attention(attention_type: str, q, k, v, **kw):
    """Functional dispatch. ``rope_cos``/``rope_sin`` mean q/k arrive
    un-rotated in half-split pair layout: flash rotates in-kernel, every
    other type applies ``apply_rope_half`` first."""
    if "rope_cos" in kw and attention_type not in ("flash_attn2", "flash_attn3"):
        cos = kw.pop("rope_cos")
        sin = kw.pop("rope_sin")
        q = apply_rope_half(q, cos, sin)
        k = apply_rope_half(k, cos, sin)
    return ATTN_REGISTER[attention_type](q, k, v, **kw)
