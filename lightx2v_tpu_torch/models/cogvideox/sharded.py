"""Multi-GPU CogVideoX DiT (counterpart of
``lightx2v_tpu.models.cogvideox.sharded``): Ulysses over the joint [text;
video] stream, one process per GPU.

The block attends over one stream with the text first. The sharded forward
reuses the [image; text] primitive (``parallel/ulysses.py``
``ulysses_concat_attention``, sharded part first) by rotating the stream to
[video; text] around the attention call and back (attention is equivariant
under a permutation of the rows, so the rotation is exact). The video tokens
and their RoPE rows shard over ``sp``; the text, the time embedding and the
blocks are replicated; the text outputs are all-gathered back to full
heads, and the video tokens before the head. The batch (CFG's pair) stays
whole on every rank, as in the JAX package.
"""

from __future__ import annotations

from functools import partial

import torch

from ...ops.attention import attention
from ...ops.linear import resolve_mm
from ...parallel.mesh import Mesh, all_gather_cat, mesh_axis_size, shard
from ...parallel.ulysses import ulysses_concat_attention
from .config import CogArch
from .model import cog_block, cog_post_process, cog_pre_process


def cog_forward_sharded(params, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                        rope_cos: torch.Tensor, rope_sin: torch.Tensor, arch: CogArch, mesh: Mesh,
                        mm_type: str = "Default", attn_type: str = "flash_attn3") -> torch.Tensor:
    """``CogTransformer.forward`` over the mesh's sp axis, on every rank
    with the same inputs. The video tokens must divide sp."""
    sp = mesh_axis_size(mesh, "sp")
    mm_blk = resolve_mm(mm_type)
    dense = partial(attention, attn_type)
    x, enc, temb, grid, f_lat = cog_pre_process(params, latents, t, context, arch)
    if x.shape[1] % sp:
        raise ValueError(f"video tokens {x.shape[1]} must divide sp = {sp}")

    def attn_fn(q, k, v, txt_len=None):
        def rot(z):  # [text; video] -> [video; text]
            return torch.cat([z[:, txt_len:], z[:, :txt_len]], dim=1)

        vid = q.shape[1] - txt_len
        out = ulysses_concat_attention(dense, rot(q), rot(k), rot(v), vid, mesh)
        return torch.cat([out[:, vid:], out[:, :vid]], dim=1)

    x = shard(x, mesh, "sp", 1)
    cos, sin = shard(rope_cos, mesh, "sp", 0), shard(rope_sin, mesh, "sp", 0)
    for block in params["blocks"]:
        x, enc = cog_block(block, x, enc, temb, cos, sin, arch, mm_blk, attn_fn)
    return cog_post_process(params, all_gather_cat(x, mesh, "sp", 1), enc, temb, grid, f_lat, arch)
