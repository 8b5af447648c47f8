"""Sparge attention: dynamic mean-similarity block sparsity (counterpart of
``lightx2v_tpu.ops.sparge``).

Selection is torch ops, as it is XLA ops in the JAX package, and gives the
same indices and counts from the same inputs: block means over 128 tokens
(the ragged tail's mean over its valid tokens only), scores
mean_q . mean_k / sqrt(d), max-pooled to (block_q x block_k) superblocks
with -inf padding, diagonal superblocks forced in by a +1e9 bump, a static
top-``nnz`` (``keep_ratio`` of the key superblocks), and a per-row count
from the cumulative softmax mass over the selected scores (the smallest
prefix holding 1 - l1 of it). The survivors run through the per-head
block-sparse flash kernel (``ops/cuda/block_sparse_attention.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .cuda.block_sparse_attention import block_sparse_attention, block_sparse_attention_plain, clamp_blocks

BLOCK = 128


def _block_means(x: torch.Tensor) -> torch.Tensor:
    """(B, S, N, D) -> (B*N, ceil(S/128), D) fp32 means; the tail block
    averages its valid tokens only."""
    b, s, n, d = x.shape
    nb_full = s // BLOCK
    parts = []
    if nb_full:
        xb = x[:, :nb_full * BLOCK].reshape(b, nb_full, BLOCK, n, d)
        parts.append(torch.mean(xb, dim=2, dtype=torch.float32))
    if s % BLOCK:
        parts.append(torch.mean(x[:, nb_full * BLOCK:], dim=1, dtype=torch.float32)[:, None])
    m = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return m.permute(0, 2, 1, 3).reshape(b * n, m.shape[1], d)


def sparge_select_blocks(q: torch.Tensor, k: torch.Tensor, keep_ratio: float = 0.3, l1: float = 0.07,
                         block_q: int = BLOCK, block_k: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k (B, S, N, D) -> (indices (B*N, nq, nnz) int32, counts (B*N, nq)
    int32) at (block_q x block_k) granularity. Entries past a row's count
    repeat its last counted block, as in the JAX package."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if block_q % BLOCK or block_k % BLOCK:
        raise ValueError(f"sparge block_q/block_k must be multiples of the {BLOCK}-token selection "
                         f"granularity, got ({block_q}, {block_k})")
    block_q, block_k = clamp_blocks(sq, sk, block_q, block_k)
    scores = torch.einsum("bqd,bkd->bqk", _block_means(q), _block_means(k)) / math.sqrt(d)
    nq_f, nk_f = scores.shape[1:]
    fq, fk = block_q // BLOCK, block_k // BLOCK
    nq, nk = -(-nq_f // fq), -(-nk_f // fk)
    if fq > 1 or fk > 1:
        scores = torch.nn.functional.pad(scores, (0, nk * fk - nk_f, 0, nq * fq - nq_f), value=-math.inf)
        scores = scores.reshape(b * n, nq, fq, nk, fk).amax(dim=(2, 4))

    # every key superblock overlapping the q superblock's token range
    qlo, klo = np.arange(nq) * block_q, np.arange(nk) * block_k
    diag = (klo[None, :] < qlo[:, None] + block_q) & (klo[None, :] + block_k > qlo[:, None])
    nnz = max(int(diag.sum(axis=1).max()), min(nk, int(math.ceil(nk * keep_ratio))))
    diag_t = torch.from_numpy(diag).to(scores.device)

    # top-nnz by bumped score; a stable descending sort puts the lower index
    # first among equal scores, as lax.top_k does (the bumped diagonal
    # blocks all round to 1e9 in fp32 and tie)
    bumped = scores + torch.where(diag_t, 1e9, 0.0).to(torch.float32)[None]
    top_idx = torch.sort(bumped, dim=-1, descending=True, stable=True).indices[..., :nnz]
    top_scores = torch.gather(scores, -1, top_idx)
    e = torch.exp(top_scores - top_scores.amax(dim=-1, keepdim=True))
    cmass = torch.cumsum(e / e.sum(dim=-1, keepdim=True), dim=-1)
    thr = torch.tensor(1.0 - float(l1), dtype=torch.float32, device=scores.device)
    needed = (cmass < thr).sum(dim=-1).to(torch.int32) + 1
    lo = torch.from_numpy(diag.sum(axis=1).astype(np.int32)).to(scores.device)[None]
    counts = torch.minimum(torch.maximum(needed, lo), torch.tensor(nnz, dtype=torch.int32, device=scores.device))
    last = torch.gather(top_idx, -1, (counts.long() - 1).clamp_min(0)[..., None])
    sel = torch.arange(nnz, device=scores.device)[None, None, :] < counts[..., None]
    top_idx = torch.where(sel, top_idx, last)
    return top_idx.to(torch.int32).contiguous(), counts.to(torch.int32).contiguous()


def sparge_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len=None, keep_ratio: float = 0.3,
                     l1: float = 0.07, block_q: int = BLOCK, block_k: int = BLOCK) -> torch.Tensor:
    """(B, S, N, D) -> (B, S, N, D): selection, then the block-sparse kernel.
    ``kv_len`` is accepted for the dispatch table and unused (video
    self-attention, every key valid), as in the JAX package."""
    indices, counts = sparge_select_blocks(q, k, keep_ratio=keep_ratio, l1=l1, block_q=block_q, block_k=block_k)
    return block_sparse_attention(q, k, v, indices, counts, bq=block_q, bk=block_k)


def sparge_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, keep_ratio: float = 0.3,
                           l1: float = 0.07, block_q: int = BLOCK, block_k: int = BLOCK) -> torch.Tensor:
    """The same selection, then the block-sparse kernel's plain version."""
    indices, counts = sparge_select_blocks(q, k, keep_ratio=keep_ratio, l1=l1, block_q=block_q, block_k=block_k)
    return block_sparse_attention_plain(q, k, v, indices, counts, bq=block_q, bk=block_k)
