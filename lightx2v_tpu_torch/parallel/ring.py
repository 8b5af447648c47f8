"""Attention partials and their merge (counterpart of
``lightx2v_tpu.parallel.ring``'s single-device pieces): a partial is the
attention of q over one key set together with the row log-sum-exp of its
logits, and two partials over disjoint key sets merge exactly into the
attention over their union. The two-pass radial attention builds on them;
``ring_attention`` itself (K/V shards rotating between devices) is not ported
yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..ops.cuda.flash_attention import flash_attention_with_lse


def _partial_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense partial attention in plain torch ops, materializing the logits:
    (out (B, S, N, D) in q's dtype, lse (B, S, N) fp32). The reference form
    of ``partial_attention`` (softmax in the natural-exp domain, P / l
    rounded to v's dtype before P.V)."""
    d = q.shape[-1]
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / math.sqrt(d)
    if kv_len is not None:
        col = torch.arange(k.shape[1], device=q.device)
        logits = torch.where(col[None, None, None, :] < int(kv_len), logits, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bnqk,bknd->bqnd", (p / l).to(v.dtype).float(), v.float())
    lse = (m + torch.log(l))[..., 0].permute(0, 2, 1)
    return out.to(q.dtype), lse


def partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) through the flash kernel with its LSE output (its plain
    version on a CPU tensor)."""
    return flash_attention_with_lse(q, k, v, kv_len=kv_len)


def merge_partials(out_a: torch.Tensor, lse_a: torch.Tensor, out_b: torch.Tensor, lse_b: torch.Tensor):
    """Numerically stable online-softmax merge, in fp32:
    out = out_a * sigmoid(lse_a - lse_b) + out_b * (1 - sigmoid(lse_a - lse_b)),
    lse = logaddexp(lse_a, lse_b); out is rounded to out_a's dtype."""
    wa = torch.sigmoid(lse_a - lse_b)[..., None]
    out = out_a.float() * wa + out_b.float() * (1.0 - wa)
    return out.to(out_a.dtype), torch.logaddexp(lse_a, lse_b)
