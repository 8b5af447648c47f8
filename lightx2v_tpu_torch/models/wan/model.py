"""Wan2.1 DiT forward pass in PyTorch (counterpart of
``lightx2v_tpu.models.wan.model``): patchify -> embeddings -> a Python loop
over the blocks -> AdaLN head -> unpatchify. Timestep/text embeddings run
in fp32, the bulk in bf16. For i2v, ``y`` (the mask and the VAE latents of
the conditioning video) joins the latents on channels before the patch
embedding, and ``clip_fea`` (CLIP tokens) becomes the image context that
each block's cross-attention attends to beside the text."""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.linear import mm_ffn, resolve_mm
from ...ops.norms import layer_norm, modulated_layer_norm, rms_norm
from ...ops.rope import apply_rope, guidance_scale_embedding, sinusoidal_embedding_1d
from .config import WanArch

Params = Dict[str, Any]


def patchify(x: torch.Tensor, patch: Tuple[int, int, int]) -> torch.Tensor:
    """(B, C, F, H, W) -> (B, S, C*pt*ph*pw), flattened (c, kt, kh, kw)."""
    b, c, f, h, w = x.shape
    pt, ph, pw = patch
    x = x.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


def unpatchify(x: torch.Tensor, grid, patch, out_dim: int) -> torch.Tensor:
    """(B, S, pt*ph*pw*out_dim) -> (B, out_dim, F, H, W)."""
    b = x.shape[0]
    f, h, w = grid
    pt, ph, pw = patch
    x = x.reshape(b, f, h, w, pt, ph, pw, out_dim)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, out_dim, f * pt, h * ph, w * pw)


def time_embeddings(params: Params, t: torch.Tensor, arch: WanArch, cfg_scale: Optional[torch.Tensor] = None):
    """timestep (B,) -> (embed (B, D) fp32, embed0 (B, 6, D) fp32). With
    ``cfg_scale`` (B,) and a checkpoint's ``cfg_cond_proj`` (dynamic-CFG
    distilled models), the projected guidance-scale embedding joins the
    timestep's."""
    mm = resolve_mm("Default-Force-FP32")
    sin_emb = sinusoidal_embedding_1d(arch.freq_dim, t)
    if cfg_scale is not None and "cfg_cond_proj" in params:
        sin_emb = sin_emb + mm(params["cfg_cond_proj"], guidance_scale_embedding(cfg_scale, 256))
    e = F.silu(mm(params["time_embedding"]["0"], sin_emb))
    embed = mm(params["time_embedding"]["2"], e)
    e0 = mm(params["time_projection"]["1"], F.silu(embed))
    return embed, e0.reshape(*e0.shape[:-1], 6, arch.dim)


def text_embeddings(params: Params, context: torch.Tensor, mm_fn) -> torch.Tensor:
    """(B, Lt, text_dim) padded T5 context -> (B, Lt, D) bf16."""
    h = mm_fn(params["text_embedding"]["0"], context.to(torch.bfloat16))
    h = F.gelu(h.float(), approximate="tanh").to(torch.bfloat16)
    return mm_fn(params["text_embedding"]["2"], h)


def img_embeddings(params: Params, clip_fea: torch.Tensor, mm_fn, eps: float = 1e-6) -> torch.Tensor:
    """i2v CLIP features (B, 257, clip_dim) -> (B, 257, D) bf16: LayerNorm
    -> Linear -> exact GELU -> Linear -> LayerNorm."""
    p = params["img_emb"]
    h = layer_norm(clip_fea.float(), p["norm0"]["w"], p["norm0"]["b"], eps=eps)
    h = mm_fn(p["1"], h.to(torch.bfloat16))
    h = F.gelu(h.float(), approximate="none").to(torch.bfloat16)
    h = mm_fn(p["3"], h)
    return layer_norm(h, p["norm4"]["w"], p["norm4"]["b"], eps=eps).to(torch.bfloat16)


def _split_modulation(block: Params, embed0: torch.Tensor):
    """e = modulation + embed0 -> six (B, 1, D) chunks."""
    e = block["modulation"] + embed0.float()
    return [e[:, i:i + 1, :] for i in range(6)]


def wan_block_parts(block: Params, x: torch.Tensor, embed0: torch.Tensor, context: torch.Tensor,
                    context_img: Optional[torch.Tensor], rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                    arch: WanArch, mm_fn, self_attn_fn, cross_attn_fn):
    """One DiT block; also returns the self-attention, cross-attention and
    FFN outputs. With ``context_img`` (i2v) the image cross-attention's
    output is added to the text one's before the output projection."""
    b, s, d = x.shape
    n, hd = arch.num_heads, arch.head_dim
    shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = _split_modulation(block, embed0)

    sa = block["self_attn"]
    norm1 = modulated_layer_norm(x, shift_msa, scale_msa, eps=arch.eps)
    q = rms_norm(mm_fn(sa["q"], norm1), sa["norm_q"], eps=arch.eps).reshape(b, s, n, hd)
    k = rms_norm(mm_fn(sa["k"], norm1), sa["norm_k"], eps=arch.eps).reshape(b, s, n, hd)
    v = mm_fn(sa["v"], norm1).reshape(b, s, n, hd)
    del norm1
    if arch.rope_fused:
        attn_out = self_attn_fn(q, k, v, rope_cos=rope_cos, rope_sin=rope_sin).reshape(b, s, d)
    else:
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
        attn_out = self_attn_fn(q, k, v).reshape(b, s, d)
    del q, k, v
    y_sa = mm_fn(sa["o"], attn_out)
    x = (x.float() + y_sa.float() * gate_msa.float()).to(x.dtype)

    ca = block["cross_attn"]
    norm3 = layer_norm(x, block["norm3"]["w"], block["norm3"]["b"], eps=arch.eps)
    cq = rms_norm(mm_fn(ca["q"], norm3), ca["norm_q"], eps=arch.eps).reshape(b, s, n, hd)
    ck = rms_norm(mm_fn(ca["k"], context), ca["norm_k"], eps=arch.eps).reshape(b, -1, n, hd)
    cv = mm_fn(ca["v"], context).reshape(b, -1, n, hd)
    cross_out = cross_attn_fn(cq, ck, cv).reshape(b, s, d)
    if context_img is not None and "k_img" in ca:
        ik = rms_norm(mm_fn(ca["k_img"], context_img), ca["norm_k_img"], eps=arch.eps).reshape(b, -1, n, hd)
        iv = mm_fn(ca["v_img"], context_img).reshape(b, -1, n, hd)
        cross_out = cross_out + cross_attn_fn(cq, ik, iv).reshape(b, s, d)
    cross_proj = mm_fn(ca["o"], cross_out)
    x = x + cross_proj

    norm2 = modulated_layer_norm(x, c_shift, c_scale, eps=arch.eps)
    y_ffn = mm_ffn(mm_fn, block["ffn"]["0"], block["ffn"]["2"], norm2)
    x = (x.float() + y_ffn.float() * c_gate.float()).to(x.dtype)
    return x, y_sa, cross_proj, y_ffn


def wan_block(block: Params, x: torch.Tensor, embed0, context, context_img, rope_cos, rope_sin, arch: WanArch,
              mm_fn, self_attn_fn, cross_attn_fn) -> torch.Tensor:
    return wan_block_parts(block, x, embed0, context, context_img, rope_cos, rope_sin, arch, mm_fn,
                           self_attn_fn, cross_attn_fn)[0]


def wan_transformer(blocks, x: torch.Tensor, embed0: torch.Tensor, context: torch.Tensor,
                    context_img: Optional[torch.Tensor], rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                    arch: WanArch,
                    mm_type: str = "Default", self_attn_type: str = "flash_attn3",
                    cross_attn_type: str = "flash_attn3",
                    self_attn_kwargs: Optional[dict] = None) -> torch.Tensor:
    """A Python loop over the blocks.

    ``self_attn_kwargs["l1_per_layer"]`` gives block i its own Sparge mass
    budget ``l1``; ``self_attn_kwargs["dense_prefix"]`` = p runs blocks
    i < p with dense ``flash_attn3`` instead of the sparse self-attention
    (the tuned table's leading layers that could not be sparsified). As in
    the JAX package, a dense prefix without a per-layer table runs the
    sparse blocks at l1 = 0."""
    kw = dict(self_attn_kwargs or {})
    l1_layers = kw.pop("l1_per_layer", None)
    dense_prefix = int(kw.pop("dense_prefix", 0) or 0)
    if dense_prefix and l1_layers is None:
        l1_layers = [0.0] * len(blocks)
    mm_fn = resolve_mm(mm_type)
    self_attn_fn = partial(attention, self_attn_type, **kw)
    dense_fn = partial(attention, "flash_attn3")
    cross_attn_fn = partial(attention, cross_attn_type)
    for i, block in enumerate(blocks):
        attn_fn = self_attn_fn
        if i < dense_prefix:
            attn_fn = dense_fn
        elif l1_layers is not None:
            attn_fn = partial(self_attn_fn, l1=float(l1_layers[i]))
        x = wan_block(block, x, embed0, context, context_img, rope_cos, rope_sin, arch, mm_fn, attn_fn,
                      cross_attn_fn)
    return x


def wan_head(params: Params, x: torch.Tensor, embed: torch.Tensor, arch: WanArch, mm_fn) -> torch.Tensor:
    """Final AdaLN + linear head."""
    e = params["head"]["modulation"][None, :, :] + embed[:, None, :].float()
    shift, scale = e[:, 0:1, :], e[:, 1:2, :]
    out = modulated_layer_norm(x, shift, scale, eps=arch.eps)
    return mm_fn(params["head"], out)


def wan_pre_process(params: Params, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                    arch: WanArch, y: Optional[torch.Tensor] = None, clip_fea: Optional[torch.Tensor] = None,
                    seq_len: Optional[int] = None, cfg_scale: Optional[torch.Tensor] = None):
    """Patchify + embeddings. Returns (x, embed, embed0, ctx, ctx_img, grid,
    s_tokens). Pre/post layers always run the Default GEMM."""
    pt, ph, pw = arch.patch_size
    if y is not None:
        latents = torch.cat([latents, y.to(latents.dtype)], dim=1)
    grid = (latents.shape[2] // pt, latents.shape[3] // ph, latents.shape[4] // pw)
    mm_fn = resolve_mm("Default")
    x = mm_fn(params["patch_embedding"], patchify(latents.to(torch.bfloat16), arch.patch_size))
    s_tokens = x.shape[1]
    if seq_len is not None and seq_len > s_tokens:
        x = F.pad(x, (0, 0, 0, seq_len - s_tokens))
    embed, embed0 = time_embeddings(params, t, arch, cfg_scale)
    ctx = text_embeddings(params, context, mm_fn)
    ctx_img = None
    if clip_fea is not None and "img_emb" in params:
        ctx_img = img_embeddings(params, clip_fea, mm_fn, eps=arch.eps)
    return x, embed, embed0, ctx, ctx_img, grid, s_tokens


def wan_post_process(params: Params, x: torch.Tensor, embed: torch.Tensor, grid, s_tokens: int,
                     arch: WanArch) -> torch.Tensor:
    """Head + unpatchify."""
    out = wan_head(params, x, embed, arch, resolve_mm("Default"))[:, :s_tokens]
    return unpatchify(out.float(), grid, arch.patch_size, arch.out_dim)


def wan_forward(params: Params, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                rope_cos: torch.Tensor, rope_sin: torch.Tensor, arch: WanArch,
                y: Optional[torch.Tensor] = None, clip_fea: Optional[torch.Tensor] = None,
                mm_type: str = "Default", self_attn_type: str = "flash_attn3",
                cross_attn_type: str = "flash_attn3", seq_len: Optional[int] = None,
                self_attn_kwargs: Optional[dict] = None, cfg_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full DiT forward: latents (B, C, F, H, W) + timestep (B,) + context
    (B, Lt, text_dim) -> flow prediction (B, out_dim, F, H, W) fp32. i2v
    adds ``y`` (B, 4 + z, F, H, W) and ``clip_fea`` (B, 257, clip_dim)."""
    x, embed, embed0, ctx, ctx_img, grid, s_tokens = wan_pre_process(params, latents, t, context, arch, y=y,
                                                                      clip_fea=clip_fea, seq_len=seq_len,
                                                                      cfg_scale=cfg_scale)
    if seq_len is not None and seq_len > s_tokens:
        self_attn_kwargs = dict(self_attn_kwargs or {})
        self_attn_kwargs.setdefault("kv_len", s_tokens)
    x = wan_transformer(params["blocks"], x, embed0, ctx, ctx_img, rope_cos, rope_sin, arch, mm_type,
                        self_attn_type, cross_attn_type, self_attn_kwargs)
    return wan_post_process(params, x, embed, grid, s_tokens, arch)


def wan_forward_cfg(params: Params, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                    context_null: torch.Tensor, guide_scale: float, rope_cos: torch.Tensor,
                    rope_sin: torch.Tensor, arch: WanArch, **kw) -> torch.Tensor:
    """Classifier-free guidance as one batched forward (B doubles: cond
    rows, then uncond rows): ``uncond + guide_scale * (cond - uncond)``.
    The i2v ``y`` and ``clip_fea`` double with the batch."""
    b = latents.shape[0]
    for key in ("y", "clip_fea", "cfg_scale"):
        if kw.get(key) is not None:
            kw[key] = torch.cat([kw[key], kw[key]])
    out = wan_forward(params, torch.cat([latents, latents]), torch.cat([t, t]),
                      torch.cat([context, context_null]), rope_cos, rope_sin, arch, **kw)
    cond, uncond = out[:b], out[b:]
    return uncond + guide_scale * (cond - uncond)
