"""Attention dispatch (counterpart of ``lightx2v_tpu.ops.attention``).

* ``flash_attn2`` / ``flash_attn3`` -> the flash-attention kernel
  (ops/cuda/flash_attention.py), with RoPE fused in when rope tables are
  passed (arch.rope_fused: q/k in half-split pair layout);
* ``torch_sdpa`` / ``xla`` -> plain softmax attention in torch ops.

All functions take q, k, v of shape (B, S, N, D) and return (B, S, N, D) in
the input dtype; softmax statistics are fp32. Other attention types of the
JAX package (sage, sparge, radial) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils.registry import ATTN_REGISTER
from .cuda.flash_attention import flash_attention, flash_attention_fused_rope
from .rope import apply_rope_half


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


def _dispatch_flash(q, k, v, kv_len: Optional[int] = None, rope_cos=None, rope_sin=None, **kw):
    if rope_cos is not None:
        return flash_attention_fused_rope(q, k, v, rope_cos, rope_sin, kv_len=kv_len)
    return flash_attention(q, k, v, kv_len=kv_len)


ATTN_REGISTER.register(["flash_attn2", "flash_attn3"], _dispatch_flash)
ATTN_REGISTER.register(["torch_sdpa", "xla"], lambda q, k, v, kv_len=None, **kw: attn_plain(q, k, v, kv_len))


def attention(attention_type: str, q, k, v, **kw):
    """Functional dispatch. ``rope_cos``/``rope_sin`` mean q/k arrive
    un-rotated in half-split pair layout: flash rotates in-kernel, every
    other type applies ``apply_rope_half`` first."""
    if attention_type not in ATTN_REGISTER:
        raise NotImplementedError(
            f"attention type {attention_type!r} is not ported yet (ROADMAP.md, Queue 1 item 2)")
    if "rope_cos" in kw and attention_type not in ("flash_attn2", "flash_attn3"):
        cos = kw.pop("rope_cos")
        sin = kw.pop("rope_sin")
        q = apply_rope_half(q, cos, sin)
        k = apply_rope_half(k, cos, sin)
    return ATTN_REGISTER[attention_type](q, k, v, **kw)
