"""Multi-GPU Wan DiT (counterpart of ``lightx2v_tpu.models.wan.sharded``):
Ulysses or ring sequence parallelism, CFG data parallelism and tensor
parallelism on ``torch.distributed``, one process per GPU.

* ``dp`` shards the batch (the cond / uncond CFG pair runs on different
  ranks);
* ``sp`` shards the video tokens; the self-attention swaps to head sharding
  with the Ulysses all-to-all, or rotates K/V around the ring;
* ``tp`` shards the heads and the FFN (``parallel/tensor_parallel.py``);
* the cross-attention needs no exchange (local queries, replicated text).

The pre- and post-processing (patchify, the embeddings, the head) run
replicated on every rank; each rank slices its (dp, sp) shard of x, and the
tokens (sp) and the batch (dp) are all-gathered before the head. RoPE: with
``rope_fused`` and Ulysses the flash kernel rotates the full-sequence head
slice after the all-to-all with the whole tables (the all-to-all
concatenates the sp chunks in rank order, so positions line up); ring must
rotate each K chunk before it travels, so it keeps the half-split pass on
the rank's own rows, as does every non-flash attention.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from ...ops.attention import attention
from ...ops.linear import resolve_mm
from ...ops.rope import apply_rope_half
from ...parallel.mesh import Mesh, all_gather_cat, mesh_axis_size, shard
from ...parallel.ring import ring_attention
from ...parallel.tensor_parallel import tp_shard_block, wan_block_tp
from ...parallel.ulysses import ulysses_attention
from ...utils.logging_utils import logger
from .config import WanArch
from .model import wan_block_parts, wan_post_process, wan_pre_process

PARALLEL_ATTN_TYPES = ("ulysses", "ring")


def _ring_pad(kv_tokens: int, sp: int, local_chunk: int) -> int:
    """Pad rows at the global tail: the padded length minus the true token
    count (0 when the sequence divides sp)."""
    return max(sp * local_chunk - kv_tokens, 0)


def tp_shard_blocks(blocks, mesh: Optional[Mesh]):
    """This rank's tp shard of every block (the blocks themselves at tp 1)."""
    tp = mesh_axis_size(mesh, "tp")
    if tp == 1:
        return blocks
    return [tp_shard_block(b, tp, mesh.index("tp")) for b in blocks]


class ShardedTransformer:
    """The block stack on this rank's shard: ``self(blocks, x, embed0,
    context, context_img, cos, sin)`` takes x (B / dp, S / sp, D), the
    conditioning's dp rows, this rank's tp shard of the blocks
    (``tp_shard_blocks``) and the whole (padded) RoPE tables. ``shard_x`` /
    ``shard_batch`` / ``gather_x`` move between the replicated and the
    sharded layouts; ``self_fn``, ``cross_fn``, ``block_parts`` and
    ``block_rope`` serve the feature-caching loops, which run their per-module
    caches on the shard. ``kv_tokens``: the true token count where sp padding
    exists (the pad rows' K are masked out of every attention path, as the
    single-device forward's ``kv_len`` does)."""

    def __init__(self, mesh: Mesh, arch: WanArch, mm_type: str = "Default", self_attn_type: str = "flash_attn3",
                 cross_attn_type: str = "flash_attn3", parallel_attn_type: str = "ulysses",
                 kv_tokens: Optional[int] = None):
        if parallel_attn_type not in PARALLEL_ATTN_TYPES:
            raise ValueError(f"unsupported parallel_attn_type: {parallel_attn_type}")
        self.mesh, self.arch, self.kv_tokens = mesh, arch, kv_tokens
        self.sp, self.tp, self.dp = (mesh_axis_size(mesh, a) for a in ("sp", "tp", "dp"))
        self.ring = self.sp > 1 and parallel_attn_type == "ring"
        split = self.tp * (1 if self.ring else self.sp)  # Ulysses splits the tp shard's heads over sp
        if arch.num_heads % split:
            raise ValueError(f"heads {arch.num_heads} must divide {split} (tp x sp for Ulysses, tp for ring)")
        self.rope_fused_in_attn = arch.rope_fused and self_attn_type in ("flash_attn2", "flash_attn3") \
            and not self.ring
        if arch.rope_fused and not self.rope_fused_in_attn:
            logger.warning(f"rope_fused + {parallel_attn_type if self.ring else self_attn_type}: RoPE runs as the "
                           "half-split pass (the in-kernel rotation needs flash and Ulysses)")
        self.mm_fn = resolve_mm(mm_type)
        self.dense_self = partial(attention, self_attn_type)
        self.cross_fn = partial(attention, cross_attn_type)

    # ------------------------------------------------------------ layouts
    def shard_x(self, x: torch.Tensor) -> torch.Tensor:
        return shard(shard(x, self.mesh, "dp", 0), self.mesh, "sp", 1)

    def shard_batch(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if t is None else shard(t, self.mesh, "dp", 0)

    def gather_x(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather_cat(all_gather_cat(x, self.mesh, "sp", 1), self.mesh, "dp", 0)

    def block_rope(self, cos: torch.Tensor, sin: torch.Tensor):
        """The tables the blocks see: whole under fused-RoPE Ulysses (the
        kernel rotates the full sequence), else this rank's rows."""
        if self.rope_fused_in_attn and self.sp > 1:
            return cos, sin
        return shard(cos, self.mesh, "sp", 0), shard(sin, self.mesh, "sp", 0)

    # ------------------------------------------------------------ attention
    def _sp_attn(self, q, k, v, **rope):
        if self.ring:
            assert not rope, "ring pre-rotates; the tables must not reach it"
            pad = 0 if self.kv_tokens is None else _ring_pad(self.kv_tokens, self.sp, k.shape[1])
            return ring_attention(q, k, v, self.mesh, pad_tail=pad)
        if self.sp > 1:
            return ulysses_attention(lambda qh, kh, vh, **kw: self.dense_self(qh, kh, vh, **rope, **kw), q, k, v,
                                     self.mesh, kv_len=self.kv_tokens)
        if self.kv_tokens is not None:
            rope["kv_len"] = self.kv_tokens
        return self.dense_self(q, k, v, **rope)

    def self_fn(self, q, k, v, rope_cos=None, rope_sin=None):
        if rope_cos is not None and not self.rope_fused_in_attn:
            # rope_fused weights (half-split layout) on a path that cannot fuse: rotate the local rows here
            q, k = apply_rope_half(q, rope_cos, rope_sin), apply_rope_half(k, rope_cos, rope_sin)
            rope_cos = rope_sin = None
        if rope_cos is not None:
            return self._sp_attn(q, k, v, rope_cos=rope_cos, rope_sin=rope_sin)
        return self._sp_attn(q, k, v)

    def block_parts(self, block, x, embed0, ctx, ctx_img, cos, sin, arch, mm_fn, self_fn, cross_fn):
        """``wan_block_parts`` on the shard (its tp form under tp)."""
        if self.tp > 1:
            return wan_block_tp(block, x, embed0, ctx, ctx_img, cos, sin, arch, mm_fn, self_fn, cross_fn, self.mesh,
                                parts=True)
        return wan_block_parts(block, x, embed0, ctx, ctx_img, cos, sin, arch, mm_fn, self_fn, cross_fn)

    def __call__(self, blocks, x, embed0, context, context_img, cos, sin):
        cos, sin = self.block_rope(cos, sin)
        for block in blocks:
            x = self.block_parts(block, x, embed0, context, context_img, cos, sin, self.arch, self.mm_fn,
                                 self.self_fn, self.cross_fn)[0]
        return x


def wan_forward_sharded(params, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                        rope_cos: torch.Tensor, rope_sin: torch.Tensor, arch: WanArch, mesh: Mesh,
                        y: Optional[torch.Tensor] = None, clip_fea: Optional[torch.Tensor] = None,
                        cfg_scale: Optional[torch.Tensor] = None, mm_type: str = "Default",
                        self_attn_type: str = "flash_attn3", cross_attn_type: str = "flash_attn3",
                        seq_len: Optional[int] = None, parallel_attn_type: str = "ulysses") -> torch.Tensor:
    """``wan_forward`` over the mesh, on every rank with the same inputs and
    the whole params (sharded over tp here; a runner shards once at load).
    The padded token count (``seq_len``) must divide sp, the batch dp."""
    x, embed, embed0, ctx, ctx_img, grid, s_tokens = wan_pre_process(params, latents, t, context, arch, y=y,
                                                                      clip_fea=clip_fea, seq_len=seq_len,
                                                                      cfg_scale=cfg_scale)
    kv_tokens = s_tokens if seq_len is not None and seq_len > s_tokens else None
    st = ShardedTransformer(mesh, arch, mm_type, self_attn_type, cross_attn_type, parallel_attn_type, kv_tokens)
    x = st(tp_shard_blocks(params["blocks"], mesh), st.shard_x(x), st.shard_batch(embed0), st.shard_batch(ctx),
           st.shard_batch(ctx_img), rope_cos, rope_sin)
    return wan_post_process(params, st.gather_x(x), embed, grid, s_tokens, arch)
