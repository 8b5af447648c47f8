"""Radial (block-sparse spatiotemporal-decay) attention (counterpart of
``lightx2v_tpu.ops.radial``).

The radial mask: full attention within a frame, a window whose width halves
with temporal distance (power-of-2 groups), frame 0 as attention sink, text
rows/columns dense. Two executions:

* block-sparse (the default, and ``sparsity_type="bsr"``): the 128-token
  block mask, union-pooled to (block_q x block_k) superblocks, feeds the
  shared-mask block-sparse flash kernel;
* ``sparsity_type="two_pass"``: two dense attentions over gathered keys (a
  near pass over whole frames, a far pass over windows of key blocks), each
  with its row log-sum-exp, merged exactly; falls to the block-sparse
  execution when the shape does not fit the plan.

The mask and plan code is host-side numpy.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.ring import merge_partials, partial_attention
from .cuda.block_sparse_attention import block_sparse_attention, clamp_blocks
from .cuda.flash_attention import flash_attention

BLOCK = 128


def _window_width(dist: int, token_per_frame: int, decay_factor: float, model_type: str) -> float:
    if model_type == "wan":
        if dist < 1:
            return token_per_frame
        if dist == 1:
            return token_per_frame // 2
    elif model_type == "hunyuan":
        if dist <= 1:
            return token_per_frame
    group = dist.bit_length()
    decay = 2 ** token_per_frame.bit_length() / 2**group * decay_factor
    return decay if decay >= BLOCK else BLOCK


def _diag_split_keep(dist: int, token_per_frame: int) -> bool:
    """Distant frame pairs are kept only every split_factor-th diagonal."""
    group = dist.bit_length()
    decay = 2 ** token_per_frame.bit_length() / 2**group
    if decay >= BLOCK:
        return True
    return dist % int(BLOCK / decay) == 0


def radial_block_mask(seq_len: int, video_token_num: int, num_frame: int, decay_factor: float = 0.5,
                      model_type: str = "wan", block_size: int = BLOCK) -> np.ndarray:
    """(nq, nk) boolean block mask, computed directly at block granularity."""
    s = ((seq_len + block_size - 1) // block_size) * block_size
    nb = s // block_size
    tpf = video_token_num // num_frame
    mask = np.zeros((nb, nb), bool)
    border = video_token_num // block_size
    mask[border:, :] = True
    mask[:, border:] = True

    centers = np.arange(nb) * block_size + block_size // 2  # block center tokens
    frame_of = np.minimum(centers // tpf, num_frame - 1)
    pos_in_frame = centers - frame_of * tpf

    for bi in range(min(border + 1, nb)):
        for bj in range(min(border + 1, nb)):
            i, j = int(frame_of[bi]), int(frame_of[bj])
            dist = abs(i - j)
            if j == 0:  # attention sink
                mask[bi, bj] = True
                continue
            if (not _diag_split_keep(dist, tpf) and dist >= 1
                    and _window_width(dist, tpf, decay_factor, model_type) <= block_size):
                continue
            w = _window_width(dist, tpf, decay_factor, model_type)
            # block centers within the intra-frame window (block-granular test)
            if abs(int(pos_in_frame[bi]) - int(pos_in_frame[bj])) <= w + block_size:
                mask[bi, bj] = True
    np.fill_diagonal(mask, True)
    return mask


class MaskMap:
    """Cached block mask per (seq_len, config), and the device index tables
    made from it (one upload per configuration, not one per layer)."""

    def __init__(self, video_token_num: int, num_frame: int):
        self.video_token_num = video_token_num
        self.num_frame = num_frame
        self._mask: Optional[np.ndarray] = None
        self._tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def query_mask(self, seq_len: int, decay_factor: float = 0.5, model_type: str = "wan") -> np.ndarray:
        if self._mask is None or self._mask.shape[0] * BLOCK < seq_len:
            self._mask = radial_block_mask(seq_len, self.video_token_num, self.num_frame,
                                           decay_factor, model_type)
        return self._mask

    def block_tables(self, seq_len: int, decay_factor: float, model_type: str, bq: int, bk: int, device):
        """(indices (nq, nnz), counts (nq,)) int32 on ``device`` for the mask
        coarsened to (bq x bk) superblocks."""
        key = (seq_len, decay_factor, model_type, bq, bk, str(device))
        if key not in self._tables:
            coarse = coarsen_block_mask(self.query_mask(seq_len, decay_factor, model_type), bq // BLOCK, bk // BLOCK)
            idx, counts = mask_to_indices(coarse)
            self._tables[key] = (torch.from_numpy(idx).to(device), torch.from_numpy(counts).to(device))
        return self._tables[key]


def coarsen_block_mask(mask: np.ndarray, fq: int, fk: int) -> np.ndarray:
    """Union-pool a fine block mask to (fq x fk) superblocks: a superset of
    the fine mask, run at larger kernel tiles. The union over a q superblock
    of many frames' shifted windows inflates the density towards dense as the
    superblocks grow."""
    nq, nk = mask.shape
    pq, pk = (-nq) % fq, (-nk) % fk
    m = np.pad(mask, ((0, pq), (0, pk)))
    return m.reshape((nq + pq) // fq, fq, (nk + pk) // fk, fk).any(axis=(1, 3))


def mask_to_indices(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(nq, nk) bool -> (indices (nq, max_nnz) int32, counts (nq,) int32);
    entries past a row's count repeat its last block."""
    nq = mask.shape[0]
    counts = mask.sum(axis=1).astype(np.int32)
    max_nnz = max(int(counts.max()), 1)
    idx = np.zeros((nq, max_nnz), np.int32)
    for i in range(nq):
        nz = np.nonzero(mask[i])[0]
        idx[i, : len(nz)] = nz
        if len(nz) < max_nnz:
            idx[i, len(nz):] = nz[-1] if len(nz) else 0
    return idx, counts


@lru_cache(maxsize=8)
def _two_pass_plan(seq_len: int, video_token_num: int, num_frame: int,
                   decay_factor: float, model_type: str, block_q: int):
    """Host-side plan for the two-pass radial decomposition.

    The radial mask is, per frame pair, a diagonal band of width w(dist)
    (plus the frame-0 sink and dense text rows/cols). It splits into two
    dense attentions over gathered keys:

    * near pass: for query frame fi, the full keys of 4 frames
      {sink 0} + 3 consecutive frames around fi, plus the text tail;
    * far pass: for every kept far pair (diag-split rule) and q tile of
      bq rows, a window of bq-sized key blocks covering the band
      [tile_start - w, tile_start + bq + w) of fj;

    merged exactly by their log-sum-exps. Gathers are coarse: whole frames
    for the near pass, bq-row blocks for the far pass. Every gathered set is
    a superset of the band mask (block rounding and clamping widen coverage;
    adjacent-frame bands widen dist 1's T/2 to T).

    Returns (tpf, bq, near_frames (F, 4) int32 frame ids, far_blocks
    (F, nt, NWIN) int32 into the F*nt block axis), or None when the shape
    does not fit."""
    F = num_frame
    tpf = video_token_num // F
    if F < 5 or tpf < 2 * BLOCK:
        return None  # too small for the decomposition
    # bq: largest divisor of tpf <= block_q (tiles must cover frames evenly)
    bq = max(d for d in range(1, min(block_q, tpf) + 1) if tpf % d == 0)
    nt = tpf // bq

    near_frames = []
    far_specs = []  # per frame: list of (fj, nwin_blocks)
    for fi in range(F):
        start = int(np.clip(fi - 1, 1, F - 3))
        nf = [0, start, start + 1, start + 2]
        near_frames.append(nf)

        spec = []
        near_set = set(nf)
        for fj in range(1, F):
            if fj in near_set:
                continue
            dist = abs(fi - fj)
            w = _window_width(dist, tpf, decay_factor, model_type)
            if not _diag_split_keep(dist, tpf) and w <= BLOCK:
                continue  # dropped diagonal
            h = int(np.ceil(w / bq))  # band half-width in blocks
            spec.append([fj, min(2 * h + 1, nt)])
        far_specs.append(spec)

    if any(not s for s in far_specs):
        return None  # a frame with no far pairs: near pass would miss keys

    # uniform window-block count across frames: growing a window by whole
    # blocks is a superset
    nwin = max(sum(nw for _, nw in s) for s in far_specs)
    if any(len(s) * nt < nwin for s in far_specs):
        return None  # can't uniformize (toy shapes: bands ~ whole frames)

    far_rows = []
    for spec in far_specs:
        nws = [nw for _, nw in spec]
        deficit = nwin - sum(nws)
        for i_ in range(len(nws)):
            if deficit <= 0:
                break
            grow = min(deficit, nt - nws[i_])
            nws[i_] += grow
            deficit -= grow
        assert deficit == 0
        tiles = []
        for (fj, _), nw in zip(spec, nws):
            h = (nw - 1) // 2
            starts = np.clip(np.arange(nt) - h, 0, nt - nw)
            idx = fj * nt + starts[:, None] + np.arange(nw)[None, :]
            tiles.append(idx.astype(np.int32))
        far_rows.append(np.concatenate(tiles, axis=1))  # (nt, nwin)

    return tpf, bq, np.asarray(near_frames, np.int32), np.stack(far_rows)


def two_pass_token_mask(seq_len: int, video_token_num: int, num_frame: int, decay_factor: float = 0.5,
                        model_type: str = "wan", block_q: int = 256) -> np.ndarray:
    """Token-level coverage of the two-pass plan: the exact mask that
    ``radial_two_pass`` attends under."""
    plan = _two_pass_plan(seq_len, video_token_num, num_frame, decay_factor, model_type, block_q)
    assert plan is not None
    tpf, bq, near_frames, far_blocks = plan
    nt = tpf // bq
    mask = np.zeros((seq_len, seq_len), bool)
    mask[video_token_num:, :] = True  # text rows dense
    mask[:, video_token_num:] = True  # text cols in the near key set
    for fi in range(num_frame):
        rows = slice(fi * tpf, (fi + 1) * tpf)
        for fr in near_frames[fi]:
            mask[rows, fr * tpf:(fr + 1) * tpf] = True
        for t in range(nt):
            r = slice(fi * tpf + t * bq, fi * tpf + (t + 1) * bq)
            for blk in far_blocks[fi, t]:
                mask[r, blk * bq:(blk + 1) * bq] = True
    return mask


def radial_two_pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask_map: MaskMap,
                    decay_factor: float = 0.5, model_type: str = "wan",
                    block_q: int = 256) -> Optional[torch.Tensor]:
    """Two-pass near/far radial attention (see ``_two_pass_plan``). q/k/v
    (B, S, N, D). Returns None when the shape does not fit the plan. The far
    pass runs frame by frame: one batched gather would hold
    F * nt * nwin * bq keys at once."""
    b, s, n, d = q.shape
    plan = _two_pass_plan(s, mask_map.video_token_num, mask_map.num_frame, decay_factor, model_type, block_q)
    if plan is None:
        return None
    tpf, bq, near_frames, far_blocks = plan
    F = mask_map.num_frame
    nt = tpf // bq
    nwin = far_blocks.shape[2]
    video = F * tpf
    dev = q.device

    # near pass: frame-granular gather + text tail
    kfr = k[:, :video].reshape(b, F, tpf, n, d)
    vfr = v[:, :video].reshape(b, F, tpf, n, d)
    nearf = torch.from_numpy(near_frames.reshape(-1).astype(np.int64)).to(dev)
    ka = kfr.index_select(1, nearf).reshape(b, F, 4 * tpf, n, d)
    va = vfr.index_select(1, nearf).reshape(b, F, 4 * tpf, n, d)
    if s > video:  # text keys replicated into every frame's near set
        ka = torch.cat([ka, k[:, None, video:].expand(b, F, s - video, n, d)], dim=2)
        va = torch.cat([va, v[:, None, video:].expand(b, F, s - video, n, d)], dim=2)
    k_a = ka.shape[2]
    qv = q[:, :video].reshape(b, F, tpf, n, d)
    out_a, lse_a = partial_attention(qv.reshape(b * F, tpf, n, d), ka.reshape(b * F, k_a, n, d),
                                     va.reshape(b * F, k_a, n, d))
    del ka, va

    # far pass: bq-block-granular windows, one frame at a time
    kb = k[:, :video].reshape(b, F * nt, bq, n, d)
    vb = v[:, :video].reshape(b, F * nt, bq, n, d)
    fidx_all = torch.from_numpy(far_blocks.reshape(F, nt * nwin).astype(np.int64)).to(dev)
    out_f = torch.empty((b, F, tpf, n, d), dtype=q.dtype, device=dev)
    lse_f = torch.empty((b, F, tpf, n), dtype=torch.float32, device=dev)
    for fi in range(F):
        kf = kb.index_select(1, fidx_all[fi]).reshape(b * nt, nwin * bq, n, d)
        vf = vb.index_select(1, fidx_all[fi]).reshape(b * nt, nwin * bq, n, d)
        o, l = partial_attention(qv[:, fi].reshape(b * nt, bq, n, d), kf, vf)
        out_f[:, fi] = o.reshape(b, tpf, n, d)
        lse_f[:, fi] = l.reshape(b, tpf, n)

    out, _ = merge_partials(out_a, lse_a, out_f.reshape(b * F, tpf, n, d), lse_f.reshape(b * F, tpf, n))
    video_out = out.reshape(b, video, n, d)
    if s > video:  # dense text rows over all keys
        out_t, _ = partial_attention(q[:, video:], k, v)
        video_out = torch.cat([video_out, out_t], dim=1)
    return video_out.to(q.dtype)


def radial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask_map: Optional[MaskMap] = None,
                     sparsity_type: str = "radial", decay_factor: float = 0.5, model_type: str = "wan",
                     block_q: int = 2048, block_k: int = 1024) -> torch.Tensor:
    """q/k/v (B, S, N, D). Dense flash attention when no ``mask_map`` is
    given. ``sparsity_type="two_pass"`` opts into the near/far execution;
    every other value runs the block mask, coarsened to (block_q x block_k)
    superblocks, through the shared-mask block-sparse kernel."""
    s = q.shape[1]
    if mask_map is None:
        return flash_attention(q, k, v)
    if sparsity_type == "two_pass":
        out = radial_two_pass(q, k, v, mask_map, decay_factor, model_type, block_q=min(block_q, 256))
        if out is not None:
            return out
    bq, bk = clamp_blocks(s, k.shape[1], block_q, block_k)
    idx, counts = mask_map.block_tables(s, decay_factor, model_type, bq, bk, q.device)
    return block_sparse_attention(q, k, v, idx, counts, bq=bq, bk=bk)
