"""Multi-GPU HunyuanVideo MMDiT (counterpart of
``lightx2v_tpu.models.hunyuan.sharded``; the reference's
``parallelize_hunyuan``): Ulysses over the concatenated [image; text]
stream, one process per GPU.

The pre-processing (patchify, the text refiner, the modulation vector) runs
replicated on every rank; the image tokens and their RoPE rows shard over
``sp``; the text, the vectors and the blocks are replicated. Each double and
single block runs ``ulysses_concat_attention``: the image q/k/v through the
all-to-all, the rank's head slice of the text appended, dense attention over
[all image tokens; text] masked at the global ``kv_len``, the image output
back through the all-to-all, the text output all-gathered. The image tokens
are all-gathered before the head. t2v only: token replace needs the global
token index of the first latent frame, which the shard hides (the JAX
runner runs i2v on one device).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from ...ops.attention import attention
from ...ops.linear import resolve_mm
from ...parallel.mesh import Mesh, all_gather_cat, mesh_axis_size, shard
from ...parallel.ulysses import ulysses_concat_attention
from .config import HunyuanArch
from .model import _silu_bf16, hunyuan_double_block, hunyuan_head, hunyuan_pre_process, hunyuan_single_block


def hunyuan_forward_sharded(params, latents: torch.Tensor, t: torch.Tensor, text_states: torch.Tensor,
                            text_mask: torch.Tensor, text_states_2: torch.Tensor, rope_cos: torch.Tensor,
                            rope_sin: torch.Tensor, kv_len: int, arch: HunyuanArch, mesh: Mesh,
                            guidance: Optional[torch.Tensor] = None, mm_type: str = "Default",
                            attn_type: str = "flash_attn3") -> torch.Tensor:
    """``HunyuanTransformer.forward`` (t2v) over the mesh's sp axis, on every
    rank with the same inputs. ``kv_len``: image tokens + valid text tokens
    (``text_kv_len``). The image tokens must divide sp."""
    sp = mesh_axis_size(mesh, "sp")
    mm_blk = resolve_mm(mm_type)
    dense = partial(attention, attn_type)
    img, txt, vec, _, grid = hunyuan_pre_process(params, latents, t, text_states, text_mask, text_states_2,
                                                 guidance, arch)
    if img.shape[1] % sp:
        raise ValueError(f"image tokens {img.shape[1]} must divide sp = {sp}")
    vec_silu = _silu_bf16(vec, img.dtype)

    def attn_fn(q, k, v, kv_len=None, img_len=None):
        return ulysses_concat_attention(dense, q, k, v, img_len, mesh, kv_len=kv_len)

    img = shard(img, mesh, "sp", 1)
    cos, sin = shard(rope_cos, mesh, "sp", 0), shard(rope_sin, mesh, "sp", 0)
    for block in params["double_blocks"]:
        img, txt = hunyuan_double_block(block, img, txt, vec_silu, cos, sin, kv_len, arch, mm_blk, attn_fn)
    li = img.shape[1]
    x = torch.cat([img, txt], dim=1)
    del img, txt
    for block in params["single_blocks"]:
        x = hunyuan_single_block(block, x, vec_silu, li, cos, sin, kv_len, arch, mm_blk, attn_fn)
    return hunyuan_head(params, all_gather_cat(x[:, :li], mesh, "sp", 1), vec_silu, grid, arch)
