"""Ring attention (counterpart of ``lightx2v_tpu.parallel.ring``; the
reference's ``attentions/distributed/ring/attn.py:25-162`` and
``comm/ring_comm.py:7-47``).

A partial is the attention of q over one key set together with the row
log-sum-exp of its logits (the flash kernel with its LSE output, row 5), and
two partials over disjoint key sets merge exactly into the attention over
their union. ``ring_attention`` rotates the K/V shards around the sp group
with ``batch_isend_irecv`` (to rank + 1, from rank - 1), merging one partial
a step; the next rotation is in flight while the current partial runs. The
two-pass radial attention builds on the partials too.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.cuda.flash_attention import flash_attention_with_lse
from .mesh import Mesh, mesh_axis_size


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


def _rotate(kc: torch.Tensor, vc: torch.Tensor, mesh: Mesh, axis: str):
    """Start sending (kc, vc) to the next rank of the ring and receiving the
    previous rank's; returns (requests, k_in, v_in)."""
    members = mesh.group_ranks[axis]
    i, n = mesh.index(axis), len(members)
    nxt, prv = members[(i + 1) % n], members[(i - 1) % n]
    g = mesh.group(axis)
    k_in, v_in = torch.empty_like(kc), torch.empty_like(vc)
    ops = [dist.P2POp(dist.isend, kc, nxt, g), dist.P2POp(dist.irecv, k_in, prv, g),
           dist.P2POp(dist.isend, vc, nxt, g), dist.P2POp(dist.irecv, v_in, prv, g)]
    return dist.batch_isend_irecv(ops), k_in, v_in


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Optional[Mesh], axis: str = "sp",
                   txt_k: Optional[torch.Tensor] = None, txt_v: Optional[torch.Tensor] = None,
                   pad_tail: int = 0) -> torch.Tensor:
    """q/k/v seq-sharded (B, S/sp, N, D) -> (B, S/sp, N, D): attention of
    this rank's queries over every rank's keys. After t rotations rank d
    holds chunk (d - t) % sp. ``pad_tail``: the sequence-parallel pad rows
    at the global tail, in the last rank's chunk (their k rows are not zero:
    the zero embeddings pick up modulation shifts), so the step that holds
    that chunk masks them with ``kv_len = chunk - pad_tail``. Optional
    replicated text K/V (``txt_k``, ``txt_v``) are merged after the last
    step (reference ``:160-162``)."""
    n = mesh_axis_size(mesh, axis)
    d_idx = mesh.index(axis) if n > 1 else 0
    chunk = k.shape[1]

    def kv_len_for(src: int):
        return chunk - pad_tail if pad_tail and src == n - 1 else None

    kc, vc = k.contiguous(), v.contiguous()
    pending = _rotate(kc, vc, mesh, axis) if n > 1 else None
    out, lse = partial_attention(q, kc, vc, kv_len=kv_len_for(d_idx))
    for t in range(1, n):
        reqs, kc, vc = pending
        for r in reqs:
            r.wait()
        pending = _rotate(kc, vc, mesh, axis) if t < n - 1 else None
        o2, l2 = partial_attention(q, kc, vc, kv_len=kv_len_for((d_idx - t) % n))
        out, lse = merge_partials(out, lse, o2, l2)
    if txt_k is not None:
        o2, l2 = partial_attention(q, txt_k, txt_v)
        out, lse = merge_partials(out, lse, o2, l2)
    return out
