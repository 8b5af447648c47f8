"""CogVideoX1.5 DiT forward pass in PyTorch (counterpart of
``lightx2v_tpu.models.cogvideox.model``): one joint [text; video] token
stream through AdaLN blocks with per-stream shift / scale / gate, QK
LayerNorm over the head dim, 3D RoPE on the video tokens only (interleaved
pair form), attention over the whole joint stream, a gelu-tanh FFN, temporal
patching p_t = 2 (the latent frames padded to a multiple of it).

The block linears run ``mm_type`` (bf16 ``Default`` GEMMs with fp32
accumulation, or int8 / fp8 on weights from
``init_random_cog_params_on_device(scheme=...)``); the embeddings and the
head run ``Default`` (``proj_out`` ``Default-Force-FP32``); attention goes through
``ops.attention.attention`` (``flash_attn3``: the dense flash kernel at head
dim 64); norms, gates and the GELU are torch ops, in the JAX package's
dtypes and order."""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.linear import resolve_mm
from ...ops.norms import layer_norm
from ...ops.rope import apply_rope
from .config import CogArch

Params = Dict[str, Any]


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) -> (B, dim) fp32 sinusoidal embedding, [cos | sin]
    (flip_sin_to_cos)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def cog_patchify(x: torch.Tensor, p: int, p_t: int) -> torch.Tensor:
    """(B, C, F, H, W) -> (B, S, C*p_t*p*p), each token's features ordered
    (C, p_t, p, p)."""
    b, c, f, h, w = x.shape
    x = x.permute(0, 2, 3, 4, 1).reshape(b, f // p_t, p_t, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, (f // p_t) * (h // p) * (w // p), c * p_t * p * p)


def cog_unpatchify(x: torch.Tensor, grid, p: int, p_t: int, c: int) -> torch.Tensor:
    """(B, S, c*p_t*p*p) -> (B, c, F, H, W), the inverse of ``cog_patchify``."""
    b = x.shape[0]
    f, h, w = grid
    x = x.reshape(b, f, h, w, c, p_t, p, p).permute(0, 4, 1, 5, 2, 6, 3, 7)
    return x.reshape(b, c, f * p_t, h * p, w * p)


def _ada_dual(p_lin: Params, temb: torch.Tensor, x: torch.Tensor, enc: torch.Tensor, norm: Params, mm_fn):
    """silu(temb) -> linear -> six chunks; LayerNorm (eps 1e-5) of both
    streams, each modulated by its own shift and scale. Returns (x, enc,
    gate, enc_gate)."""
    tm = mm_fn(p_lin, F.silu(temb.float()).to(x.dtype))
    sh, sc, g, esh, esc, eg = tm.chunk(6, dim=-1)
    xn = layer_norm(x, norm["w"], norm["b"], eps=1e-5) * (1 + sc[:, None]) + sh[:, None]
    en = layer_norm(enc, norm["w"], norm["b"], eps=1e-5) * (1 + esc[:, None]) + esh[:, None]
    return xn.to(x.dtype), en.to(x.dtype), g, eg


def cog_block(block: Params, x: torch.Tensor, enc: torch.Tensor, temb: torch.Tensor, rope_cos: torch.Tensor,
              rope_sin: torch.Tensor, arch: CogArch, mm_fn, attn_type):
    """One joint block: video tokens x (B, Lv, D), text tokens enc (B, Lt, D).
    ``attn_type``: an attention type, or a callable ``(q, k, v, txt_len=)``
    over the joint stream (the sharded forward's Ulysses)."""
    b, lt = x.shape[0], enc.shape[1]
    n, hd = arch.num_heads, arch.head_dim

    xn, en, gate, egate = _ada_dual(block["norm1_linear"], temb, x, enc, block["norm1_norm"], mm_fn)
    h = torch.cat([en, xn], dim=1)  # [text; video]
    del xn, en
    q = mm_fn(block["to_q"], h).reshape(b, -1, n, hd)
    k = mm_fn(block["to_k"], h).reshape(b, -1, n, hd)
    v = mm_fn(block["to_v"], h).reshape(b, -1, n, hd)
    del h
    # QK LayerNorm over the head dim at eps 1e-6 (norm1/norm2 use 1e-5)
    q = layer_norm(q, block["norm_q"]["w"], block["norm_q"]["b"], eps=1e-6)
    k = layer_norm(k, block["norm_k"]["w"], block["norm_k"]["b"], eps=1e-6)
    q = torch.cat([q[:, :lt], apply_rope(q[:, lt:], rope_cos, rope_sin)], dim=1)
    k = torch.cat([k[:, :lt], apply_rope(k[:, lt:], rope_cos, rope_sin)], dim=1)
    attn = attn_type(q, k, v, txt_len=lt) if callable(attn_type) else attention(attn_type, q, k, v)
    del q, k, v
    attn = mm_fn(block["to_out"], attn.reshape(b, attn.shape[1], n * hd))
    enc = enc + egate[:, None] * attn[:, :lt]
    x = x + gate[:, None] * attn[:, lt:]
    del attn

    xn, en, gate, egate = _ada_dual(block["norm2_linear"], temb, x, enc, block["norm2_norm"], mm_fn)
    h = torch.cat([en, xn], dim=1)
    del xn, en
    h = mm_fn(block["ff_0"], h)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    h = mm_fn(block["ff_2"], h)
    enc = enc + egate[:, None] * h[:, :lt]
    x = x + gate[:, None] * h[:, lt:]
    return x, enc


class CogTransformer(torch.nn.Module):
    """The DiT forward (the JAX package's ``cog_forward``) over a params
    dict: latents (B, C, F, H, W) + timestep (B,) + context (B, text_len,
    text_dim) -> prediction (B, C, F, H, W) fp32. The rope tables cover the
    padded frame grid; ``mm_type`` is the block linears' scheme."""

    def __init__(self, params: Params, arch: CogArch, attn_type: str = "flash_attn3"):
        super().__init__()
        self.params = params
        self.arch = arch
        self.attn_type = attn_type

    def forward(self, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor, rope_cos: torch.Tensor,
                rope_sin: torch.Tensor, mm_type: str = "Default") -> torch.Tensor:
        mm_blk = resolve_mm(mm_type)
        x, enc, temb, grid, f_lat = cog_pre_process(self.params, latents, t, context, self.arch)
        for block in self.params["blocks"]:
            x, enc = cog_block(block, x, enc, temb, rope_cos, rope_sin, self.arch, mm_blk, self.attn_type)
        return cog_post_process(self.params, x, enc, temb, grid, f_lat, self.arch)


def cog_pre_process(params: Params, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor, arch: CogArch):
    """-> (video tokens x, text tokens enc, temb, token grid, latent frames
    before the p_t padding)."""
    mm = resolve_mm("Default")
    p, p_t = arch.patch_size, arch.patch_size_t
    f_lat = latents.shape[2]
    pad_f = (-f_lat) % p_t
    if pad_f:  # CogVideoX1.5 repeats the last frames up to a p_t multiple
        latents = torch.cat([latents, latents[:, :, -pad_f:]], dim=2)
    grid = (latents.shape[2] // p_t, latents.shape[3] // p, latents.shape[4] // p)
    temb = mm(params["time_embedding"]["1"], timestep_embedding(t, arch.dim).to(torch.bfloat16))
    temb = mm(params["time_embedding"]["2"], F.silu(temb.float()).to(torch.bfloat16))
    enc = mm(params["text_proj"], context.to(torch.bfloat16))
    x = mm(params["patch_proj"], cog_patchify(latents.to(torch.bfloat16), p, p_t))
    return x, enc, temb, grid, f_lat


def cog_post_process(params: Params, x: torch.Tensor, enc: torch.Tensor, temb: torch.Tensor, grid, f_lat: int,
                     arch: CogArch) -> torch.Tensor:
    """The final norm over the joint stream, then the AdaLN head on the
    video tokens -> (B, C, F, H, W) fp32."""
    mm = resolve_mm("Default")
    joint = layer_norm(torch.cat([enc, x], dim=1), params["norm_final"]["w"], params["norm_final"]["b"], eps=1e-5)
    x = joint[:, arch.text_len:]
    del joint, enc
    shift, scale = mm(params["norm_out_linear"], F.silu(temb.float()).to(x.dtype)).chunk(2, dim=-1)
    x = layer_norm(x, params["norm_out_norm"]["w"], params["norm_out_norm"]["b"], eps=1e-5)
    x = x * (1 + scale[:, None]) + shift[:, None]
    out = resolve_mm("Default-Force-FP32")(params["proj_out"], x)
    video = cog_unpatchify(out, grid, arch.patch_size, arch.patch_size_t, arch.out_channels)
    return video[:, :, :f_lat]
