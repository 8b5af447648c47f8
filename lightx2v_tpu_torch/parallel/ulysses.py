"""Ulysses sequence parallelism: the seq-shard <-> head-shard all-to-all
(counterpart of ``lightx2v_tpu.parallel.ulysses``; the reference's
``dist.all_to_all_single``, ``attentions/distributed/ulysses/attn.py:7-91``,
``comm/all2all.py:7-89``).

Layouts (per rank, ``sp`` ranks in the group):
  seq-sharded:  (B, S/sp, N, D)
  head-sharded: (B, S, N/sp, D)

The swaps are one ``all_to_all_single`` over the sp group on a contiguous
(sp, ...) buffer: rank j's chunk j goes to rank j, and the received chunks
are concatenated in rank order, as the JAX form (``tiled=True``) does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, mesh_axis_size


def _a2a(buf: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=mesh.group(axis))
    return out


def seq2head(x: torch.Tensor, mesh: Optional[Mesh], axis: str = "sp") -> torch.Tensor:
    """(B, S/sp, N, D) -> (B, S, N/sp, D)."""
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return x
    b, s, h, d = x.shape
    buf = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    out = _a2a(buf, mesh, axis)  # (sp, B, S/sp, N/sp, D): chunk i is rank i's tokens
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def head2seq(x: torch.Tensor, mesh: Optional[Mesh], axis: str = "sp") -> torch.Tensor:
    """(B, S, N/sp, D) -> (B, S/sp, N, D)."""
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return x
    b, s, h, d = x.shape
    buf = x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4).contiguous()
    out = _a2a(buf, mesh, axis)  # (sp, B, S/sp, N/sp, D): chunk i is rank i's heads
    return out.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


def ulysses_attention(attn_fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Optional[Mesh],
                      axis: str = "sp", kv_len: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention with per-rank head slices: q/k/v (B, S/sp,
    N, D) seq-sharded -> (B, S/sp, N, D). ``attn_fn(q, k, v)`` computes dense
    attention on (B, S, N/sp, D); ``kv_len`` masks the global tail after the
    swap (the sequence-parallel pad tokens, whose k rows are not zero)."""
    qh, kh, vh = seq2head(q, mesh, axis), seq2head(k, mesh, axis), seq2head(v, mesh, axis)
    oh = attn_fn(qh, kh, vh) if kv_len is None else attn_fn(qh, kh, vh, kv_len=kv_len)
    del qh, kh, vh
    return head2seq(oh, mesh, axis)


def ulysses_concat_attention(attn_fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, img_len: int,
                             mesh: Optional[Mesh], axis: str = "sp", kv_len: Optional[int] = None) -> torch.Tensor:
    """Ulysses over a concatenated [image; text] stream (the HunyuanVideo and
    CogVideoX joint blocks): the first ``img_len`` rows are this rank's
    image tokens, the rest the replicated text. Only the image part goes
    through the all-to-all; each rank takes its head slice of the text,
    attends over [all image tokens; text], and the text outputs are
    all-gathered back to full heads, so every rank returns the same text
    stream. q/k/v: (B, img_len + St, N, D) -> the same shape."""
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return attn_fn(q, k, v) if kv_len is None else attn_fn(q, k, v, kv_len=kv_len)
    hs = q.shape[2] // n
    h0 = mesh.index(axis) * hs

    def joined(x):
        return torch.cat([seq2head(x[:, :img_len], mesh, axis), x[:, img_len:, h0:h0 + hs]], dim=1)

    qh, kh, vh = joined(q), joined(k), joined(v)
    oh = attn_fn(qh, kh, vh) if kv_len is None else attn_fn(qh, kh, vh, kv_len=kv_len)
    del qh, kh, vh
    si = img_len * n
    oi = head2seq(oh[:, :si], mesh, axis)
    ot = oh[:, si:].contiguous()
    parts = [torch.empty_like(ot) for _ in range(n)]
    dist.all_gather(parts, ot, group=mesh.group(axis))
    return torch.cat([oi, torch.cat(parts, dim=2)], dim=1)


def partial_heads_attention(attn_fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Head-parallel attention (the reference's ``partial_heads_attn``):
    q/k/v already hold this rank's heads (B, S, N/sp, D) over the whole
    sequence, so there is nothing to exchange inside."""
    return attn_fn(q, k, v)
