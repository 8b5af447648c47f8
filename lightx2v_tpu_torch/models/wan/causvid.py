"""CausVid: block-autoregressive Wan generation with KV caches (counterpart
of ``lightx2v_tpu.models.wan.causvid``).

Each layer keeps a bf16 self-attention K/V cache of shape (B, kv_size, N,
D) inside one (L, B, kv_size, N, D) pair. A forward over one AR block of
frames writes the block's k/v in place at ``[kv_start:kv_start + S]`` and
its queries attend ``cache[:kv_len]`` through the flash kernel's ``kv_len``
(slots past it are never read). The cross-attention K/V over the text is
computed once per prompt (``precompute_cross_kv``). q, k and the cross q/k
are RMS-normed at eps 1e-5, as in the JAX module, not at the arch's eps."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ...ops.attention import attention
from ...ops.linear import mm_ffn, resolve_mm
from ...ops.norms import layer_norm, modulated_layer_norm, rms_norm
from ...ops.rope import apply_rope, apply_rope_half
from .config import WanArch
from .model import _gated_add, _split_modulation, patchify, time_embeddings, unpatchify, wan_head

Params = Dict[str, object]
QK_EPS = 1e-5


def init_kv_cache(arch: WanArch, kv_size: int, batch: int = 1, device="cpu",
                  dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    shape = (arch.num_layers, batch, kv_size, arch.num_heads, arch.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def precompute_cross_kv(params: Params, context: torch.Tensor, arch: WanArch,
                        mm_fn=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer cross-attention (k, v), each (B, Lt, N, D), over the
    embedded text context."""
    mm_fn = mm_fn or resolve_mm("Default")
    b, n, hd = context.shape[0], arch.num_heads, arch.head_dim
    out = []
    for block in params["blocks"]:
        ca = block["cross_attn"]
        k = rms_norm(mm_fn(ca["k"], context), ca["norm_k"], eps=QK_EPS).reshape(b, -1, n, hd)
        out.append((k, mm_fn(ca["v"], context).reshape(b, -1, n, hd)))
    return out


def causvid_block(block: Params, x: torch.Tensor, kv_k: torch.Tensor, kv_v: torch.Tensor, cross_k: torch.Tensor,
                  cross_v: torch.Tensor, embed0: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                  kv_start: int, kv_len: int, arch: WanArch, mm_fn, attn_type: str) -> torch.Tensor:
    """One block over an AR block's tokens x (B, S, D); writes its k/v into
    the layer's cache ``kv_k``/``kv_v`` (B, kv_size, N, D) in place."""
    b, s, d = x.shape
    n, hd = arch.num_heads, arch.head_dim
    shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = _split_modulation(block, embed0)
    rope = apply_rope_half if arch.rope_fused else apply_rope  # half-split q/k weights under rope_fused

    sa = block["self_attn"]
    norm1 = modulated_layer_norm(x, shift_msa, scale_msa, eps=arch.eps)
    q = rope(rms_norm(mm_fn(sa["q"], norm1), sa["norm_q"], eps=QK_EPS).reshape(b, s, n, hd), rope_cos, rope_sin)
    k = rope(rms_norm(mm_fn(sa["k"], norm1), sa["norm_k"], eps=QK_EPS).reshape(b, s, n, hd), rope_cos, rope_sin)
    kv_k[:, kv_start:kv_start + s] = k
    kv_v[:, kv_start:kv_start + s] = mm_fn(sa["v"], norm1).reshape(b, s, n, hd)
    del norm1, k
    attn_out = attention(attn_type, q, kv_k, kv_v, kv_len=kv_len).reshape(b, s, d)
    x = _gated_add(x, mm_fn(sa["o"], attn_out), gate_msa)

    ca = block["cross_attn"]
    norm3 = layer_norm(x, block["norm3"]["w"], block["norm3"]["b"], eps=arch.eps)
    cq = rms_norm(mm_fn(ca["q"], norm3), ca["norm_q"], eps=QK_EPS).reshape(b, s, n, hd)
    x = x + mm_fn(ca["o"], attention(attn_type, cq, cross_k, cross_v).reshape(b, s, d))

    norm2 = modulated_layer_norm(x, c_shift, c_scale, eps=arch.eps)
    return _gated_add(x, mm_ffn(mm_fn, block["ffn"]["0"], block["ffn"]["2"], norm2), c_gate)


def causvid_forward(params: Params, latents: torch.Tensor, t: torch.Tensor, kv_cache: Dict[str, torch.Tensor],
                    cross_kv: List[Tuple[torch.Tensor, torch.Tensor]], rope_cos: torch.Tensor,
                    rope_sin: torch.Tensor, kv_start: int, kv_len: int, arch: WanArch, mm_type: str = "Default",
                    attn_type: str = "flash_attn3") -> torch.Tensor:
    """One denoise forward over an AR block of frames, latents (B, C, F_blk,
    H, W) at timestep t (B,), updating ``kv_cache`` in place. Returns the
    flow prediction (B, out_dim, F_blk, H, W) fp32."""
    mm_default = resolve_mm("Default")
    x = mm_default(params["patch_embedding"], patchify(latents.to(torch.bfloat16), arch.patch_size))
    pt, ph, pw = arch.patch_size
    grid = (latents.shape[2] // pt, latents.shape[3] // ph, latents.shape[4] // pw)
    embed, embed0 = time_embeddings(params, t, arch)
    mm_fn = resolve_mm(mm_type)
    for li, block in enumerate(params["blocks"]):
        ck, cv = cross_kv[li]
        x = causvid_block(block, x, kv_cache["k"][li], kv_cache["v"][li], ck, cv, embed0, rope_cos, rope_sin,
                          kv_start, kv_len, arch, mm_fn, attn_type)
    out = wan_head(params, x, embed, arch, mm_default)
    return unpatchify(out.float(), grid, arch.patch_size, arch.out_dim)
