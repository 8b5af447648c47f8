"""Block-sparse flash attention: CUDA kernel wrapper and its plain PyTorch
version.

Port of ``lightx2v_tpu/ops/pallas/block_sparse_attention.py:
block_sparse_attention`` in both forms: per head (indices (B*N, nq, nnz),
counts (B*N, nq): Sparge's selection) and shared (indices (nq, nnz), counts
(nq,) read by every (batch, head): radial attention's static mask, whose
padding entries repeat the last block and are never reached since only
j < counts[i] is swept). The kernel is ``sparse_wgmma_kernel`` of
``csrc/flash_attention.cu``, the dense flash kernel's wgmma + TMA body
walking each 128-row work tile's list of selected key superblocks; the
shared form is one flag on its row lookup, so the table is not copied per
head. Row i of the tables covers q tokens
[i*bq, (i+1)*bq); entry j < counts[..., i] names a bk-token key superblock.
Public functions keep the JAX (B, S, N, D) layout. On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it runs the plain
version, which repeats the kernel's arithmetic over the selected keys (q
scaled by scale*log2(e) and re-rounded to bf16, exp2 softmax in fp32, P
rounded to bf16 before P.V, output acc / max(l, 1e-30)).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import HEAD_DIM, LOG2E, _check_qkv

# the per-head and the shared-mask form count apart
LAUNCHES = {"block_sparse_attention": 0, "block_sparse_attention_shared": 0}


def clamp_blocks(sq: int, sk: int, bq: int, bk: int):
    """The TPU wrapper's superblock clamp: no larger than the next power of
    two of the sequence, and at least 128."""
    return (min(bq, max(128, 1 << (sq - 1).bit_length())), min(bk, max(128, 1 << (sk - 1).bit_length())))


def block_sparse_attention_plain(q, k, v, indices, counts, bq: int = 128, bk: int = 128) -> torch.Tensor:
    b, sq, n, d = q.shape
    sk = k.shape[1]
    bq, bk = clamp_blocks(sq, sk, bq, bk)
    qs = (q.float() * ((1.0 / math.sqrt(d)) * LOG2E)).to(torch.bfloat16)
    out = torch.zeros((b, sq, n, d), dtype=torch.bfloat16, device=q.device)
    idx, cnt = indices.cpu(), counts.cpu()
    if idx.dim() == 2:  # shared mask: every (batch, head) reads the same rows
        idx, cnt = idx[None].expand(b * n, -1, -1), cnt[None].expand(b * n, -1)
    for bh in range(b * n):
        bi, ni = divmod(bh, n)
        for iq in range(-(-sq // bq)):
            blocks = idx[bh, iq, :int(cnt[bh, iq])].tolist()
            keys = [torch.arange(j * bk, min((j + 1) * bk, sk)) for j in blocks if j * bk < sk]
            if not keys:
                continue
            keys = torch.cat(keys).to(q.device)
            rows = slice(iq * bq, min((iq + 1) * bq, sq))
            s = torch.matmul(qs[bi, rows, ni].float(), k[bi, keys, ni].float().t())
            p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
            o = torch.matmul(p.to(torch.bfloat16).float(), v[bi, keys, ni].float())
            out[bi, rows, ni] = (o / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)).to(torch.bfloat16)
    return out


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.block_sparse_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, indices: torch.Tensor,
                           counts: torch.Tensor, bq: int = 128, bk: int = 128) -> torch.Tensor:
    """q/k/v (B, S, N, 128) bf16 -> (B, S, N, 128); indices (B*N, nq, nnz)
    and counts (B*N, nq) int32, or (nq, nnz) and (nq,) shared by every
    (batch, head), at (bq x bk) granularity, clamped as the TPU wrapper
    does. Keys past S are masked."""
    if q.device.type == "cpu":
        return block_sparse_attention_plain(q, k, v, indices, counts, bq, bk)
    dev = q.device
    _check_qkv(q, k, v)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    bq, bk = clamp_blocks(sq, sk, bq, bk)
    nq = -(-sq // bq)
    shared = indices.dim() == 2
    if (indices.device != dev or counts.device != dev or indices.dtype != torch.int32
            or counts.dtype != torch.int32 or indices.dim() not in (2, 3)
            or (not shared and indices.shape[0] != b * n)
            or indices.shape[-2] < nq or counts.shape != indices.shape[:-1]
            or not indices.is_contiguous() or not counts.is_contiguous()):
        raise ValueError(f"indices/counts must be contiguous int32 ({b * n}, >={nq}, nnz) / ({b * n}, >={nq}), or "
                         f"(>={nq}, nnz) / (>={nq},) shared, on {dev}, got {tuple(indices.shape)} "
                         f"{indices.dtype} / {tuple(counts.shape)}")
    if bq % 128 or bk % 64:
        raise ValueError(f"superblocks must be multiples of 128 queries and 64 keys, got ({bq}, {bk})")
    out = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=dev)
    gain = (1.0 / math.sqrt(HEAD_DIM)) * LOG2E
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), indices.data_ptr(), counts.data_ptr(),
                 int(shared), indices.shape[-2], indices.shape[-1], bq, bk, b, n, sq, sk,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], gain, stream)
    _build.check(err, "block_sparse_attention")
    LAUNCHES["block_sparse_attention_shared" if shared else "block_sparse_attention"] += 1
    return out
