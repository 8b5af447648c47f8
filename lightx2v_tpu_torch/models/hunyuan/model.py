"""HunyuanVideo MMDiT forward pass in PyTorch (counterpart of
``lightx2v_tpu.models.hunyuan.model``): the patch embedding, the time,
CLIP-pooled and embedded-guidance vector, the two-block token refiner over
the Llama hidden states, 20 double-stream blocks (separate image and text
weights, one joint attention over [image; text]), 40 single-stream blocks
(one fused qkv + MLP linear, RoPE on the image tokens only), the AdaLN head.
i2v's token replace: with ``token_replace`` (and an i2v arch) the tokens of
the first latent frame take the modulation of t = 0 (``tr_vec``), in the
image stream of the double blocks and in the single blocks. RIFLEx lowers
the k-th temporal frequency of the RoPE for clips past 192 frames
(``riflex_k_for``).

The block linears (the modulation projections included) run ``mm_type``
(bf16 ``Default`` GEMMs with fp32 accumulation, or a quantized scheme on
weights from ``init_random_hunyuan_params_on_device(scheme=...)``); the
embeddings, the refiner and the head run ``Default`` (the head's linear
``Default-Force-FP32``); the joint attention goes through
``ops.attention.attention`` (``flash_attn3``: the dense flash kernel at head
dim 128) with the padded text keys masked by ``kv_len``: image tokens plus
the prompt's valid text tokens, counted once per request on the host
(``text_kv_len``), never read back from the device in a step. Padded text
queries are still computed; they attend the valid keys. The refiner's
attention is plain einsum and softmax (fp32 logits), as in the JAX package,
with key column 0 kept valid for every row so that no row is all masked.
Norms, gates and GELUs are torch ops in the JAX package's dtypes and order.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.linear import resolve_mm
from ...ops.norms import layer_norm, rms_norm
from ...ops.rope import apply_rope
from ..cogvideox.model import timestep_embedding
from ..wan.model import patchify
from .config import HunyuanArch

Params = Dict[str, Any]


def build_hunyuan_rope(arch: HunyuanArch, f: int, h: int, w: int, riflex_k: Optional[int] = None,
                       l_test: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """cos, sin (f*h*w, head_dim//2) fp32 over the token grid, theta 256,
    the head dim split per axis by ``rope_dim_list`` (interleaved pairs).
    RIFLEx: with ``riflex_k`` the k-th temporal frequency becomes
    0.9 * 2 pi / ``l_test`` (the latent frame count)."""
    sizes = (f, h, w)
    cos_parts, sin_parts = [], []
    for i, dim in enumerate(arch.rope_dim_list):
        freqs = 1.0 / (arch.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        if i == 0 and riflex_k is not None:
            freqs[riflex_k - 1] = 0.9 * 2 * np.pi / l_test
        ang = np.outer(np.arange(sizes[i], dtype=np.float64), freqs)
        shape = [1, 1, 1, ang.shape[1]]
        shape[i] = sizes[i]
        ang = np.broadcast_to(ang.reshape(shape), (f, h, w, ang.shape[1]))
        cos_parts.append(np.cos(ang))
        sin_parts.append(np.sin(ang))
    cos = np.concatenate(cos_parts, axis=-1).reshape(f * h * w, -1).astype(np.float32)
    sin = np.concatenate(sin_parts, axis=-1).reshape(f * h * w, -1).astype(np.float32)
    return cos, sin


def riflex_k_for(video_length: int, l_train: int = 25) -> Optional[int]:
    """RIFLEx's frequency index for a clip of ``video_length`` frames: None
    up to 192 frames, else 2 + (video_length + 3) // (4 * l_train) clipped
    to 4..8."""
    if video_length <= 192:
        return None
    return max(4, min(8, 2 + (video_length + 3) // (4 * l_train)))


def text_kv_len(img_len: int, text_mask) -> int:
    """The joint attention's valid key count: the image tokens and the first
    prompt's valid text tokens (the text mask of batch row 0, on the host)."""
    return int(img_len) + int((np.asarray(text_mask)[0] > 0).sum())


def _silu_bf16(x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return F.silu(x.float()).to(dtype)


def _mlp2(p: Params, x: torch.Tensor, mm) -> torch.Tensor:
    return mm(p["2"], _silu_bf16(mm(p["0"], x), x.dtype))


def _gelu_tanh(x: torch.Tensor, dtype) -> torch.Tensor:
    return F.gelu(x.float(), approximate="tanh").to(dtype)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, tr: Optional[Tuple] = None,
              tr_len: int = 0) -> torch.Tensor:
    """AdaLN modulation; with ``tr`` = (shift, scale) of the token-replace
    vector the first ``tr_len`` tokens take it instead."""
    out = x * (1.0 + scale[:, None, :]) + shift[:, None, :]
    if tr is not None and tr_len > 0:
        out[:, :tr_len] = x[:, :tr_len] * (1.0 + tr[1][:, None, :]) + tr[0][:, None, :]
    return out


def _gate(out: torch.Tensor, gate: torch.Tensor, tr_gate: Optional[torch.Tensor] = None,
          tr_len: int = 0) -> torch.Tensor:
    g = out * gate[:, None, :]
    if tr_gate is not None and tr_len > 0:
        g[:, :tr_len] = out[:, :tr_len] * tr_gate[:, None, :]
    return g


def _refiner_block(p: Params, x: torch.Tensor, c: torch.Tensor, mask_bias: torch.Tensor, arch: HunyuanArch,
                   mm) -> torch.Tensor:
    """Token refiner block: LayerNorm -> qkv self-attention under the text
    mask, gated by adaLN, then a SiLU MLP, gated."""
    b, L, d = x.shape
    n, hd = arch.heads_num, arch.head_dim
    gate_msa, gate_mlp = mm(p["adaLN"], _silu_bf16(c, x.dtype)).chunk(2, dim=-1)
    normx = layer_norm(x, p["norm1"]["w"], p["norm1"]["b"], eps=1e-6)
    q, k, v = mm(p["qkv"], normx).reshape(b, L, 3, n, hd).unbind(2)
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / math.sqrt(hd) + mask_bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    attn = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(v.dtype).reshape(b, L, d)
    x = x + mm(p["proj"], attn) * gate_msa[:, None, :]
    h = layer_norm(x, p["norm2"]["w"], p["norm2"]["b"], eps=1e-6)
    h = mm(p["mlp_fc2"], _silu_bf16(mm(p["mlp_fc1"], h), x.dtype))
    return x + h * gate_mlp[:, None, :]


def hunyuan_pre_process(params: Params, latents: torch.Tensor, t: torch.Tensor, text_states: torch.Tensor,
                        text_mask: torch.Tensor, text_states_2: torch.Tensor, guidance: Optional[torch.Tensor],
                        arch: HunyuanArch, token_replace: bool = False):
    """-> (img (B, Li, D), txt (B, Lt, D), vec (B, D), tr_vec (B, D) or
    None, token grid). ``tr_vec``, the vector at t = 0 without guidance,
    is made for ``token_replace`` on an i2v arch."""
    mm = resolve_mm("Default")
    grid = tuple(latents.shape[2 + i] // arch.patch_size[i] for i in range(3))
    img = mm(params["img_in"], patchify(latents.to(torch.bfloat16), arch.patch_size))

    temb = lambda v: timestep_embedding(v, 256).to(torch.bfloat16)  # noqa: E731
    vec = _mlp2(params["time_in"], temb(t), mm)
    vec = vec + _mlp2(params["vector_in"], text_states_2.to(torch.bfloat16), mm)
    if guidance is not None and "guidance_in" in params:
        vec = vec + _mlp2(params["guidance_in"], temb(guidance), mm)
    tr_vec = None
    if token_replace and arch.task == "i2v":
        tr_vec = _mlp2(params["time_in"], temb(torch.zeros_like(t)), mm)
        tr_vec = tr_vec + _mlp2(params["vector_in"], text_states_2.to(torch.bfloat16), mm)

    txt_in = params["txt_in"]
    ts = text_states.to(torch.bfloat16)
    c = _mlp2(txt_in["t_embedder"], temb(t), mm)
    maskf = text_mask.float()[..., None]
    pooled = (ts.float() * maskf).sum(dim=1) / torch.clamp_min(maskf.sum(dim=1), 1e-6)
    cemb = mm(txt_in["c_embedder_1"], pooled.to(torch.bfloat16))
    c = c + mm(txt_in["c_embedder_2"], _silu_bf16(cemb))
    txt = mm(txt_in["input_embedder"], ts)
    m1 = text_mask[:, None, None, :] > 0
    keep = m1 & m1.transpose(2, 3)
    keep[..., 0] = True
    bias = torch.where(keep, 0.0, -1e9).float()
    for rb in txt_in["refiner"]:
        txt = _refiner_block(rb, txt, c, bias, arch, mm)
    return img, txt, vec, tr_vec, grid


def hunyuan_double_block(block: Params, img: torch.Tensor, txt: torch.Tensor, vec_silu: torch.Tensor,
                         rope_cos: torch.Tensor, rope_sin: torch.Tensor, kv_len: int, arch: HunyuanArch, mm,
                         attn_type: str, tr_vec_silu: Optional[torch.Tensor] = None, tr_len: int = 0):
    b, li, d = img.shape
    lt = txt.shape[1]
    n, hd = arch.heads_num, arch.head_dim
    im1s, im1c, im1g, im2s, im2c, im2g = mm(block["img_mod"], vec_silu).chunk(6, dim=-1)
    tm1s, tm1c, tm1g, tm2s, tm2c, tm2g = mm(block["txt_mod"], vec_silu).chunk(6, dim=-1)
    trs = [None] * 6
    if tr_vec_silu is not None:
        trs = mm(block["img_mod"], tr_vec_silu).chunk(6, dim=-1)

    iq, ik, iv = mm(block["img_attn_qkv"], _modulate(layer_norm(img, eps=1e-6), im1s, im1c, trs[0:2],
                                                     tr_len)).reshape(b, li, 3, n, hd).unbind(2)
    iq = apply_rope(rms_norm(iq, block["img_attn_q_norm"], eps=1e-6), rope_cos, rope_sin)
    ik = apply_rope(rms_norm(ik, block["img_attn_k_norm"], eps=1e-6), rope_cos, rope_sin)
    tq, tk, tv = mm(block["txt_attn_qkv"], _modulate(layer_norm(txt, eps=1e-6), tm1s, tm1c)).reshape(
        b, lt, 3, n, hd).unbind(2)
    tq = rms_norm(tq, block["txt_attn_q_norm"], eps=1e-6)
    tk = rms_norm(tk, block["txt_attn_k_norm"], eps=1e-6)
    q = torch.cat([iq, tq], dim=1)
    k = torch.cat([ik, tk], dim=1)
    v = torch.cat([iv, tv], dim=1)
    del iq, ik, iv, tq, tk, tv
    attn = attention(attn_type, q, k, v, kv_len=kv_len).reshape(b, li + lt, d)
    del q, k, v

    img = img + _gate(mm(block["img_attn_proj"], attn[:, :li]), im1g, trs[2], tr_len)
    txt = txt + mm(block["txt_attn_proj"], attn[:, li:]) * tm1g[:, None, :]
    del attn
    h = mm(block["img_mlp_fc1"], _modulate(layer_norm(img, eps=1e-6), im2s, im2c, trs[3:5], tr_len))
    img = img + _gate(mm(block["img_mlp_fc2"], _gelu_tanh(h, img.dtype)), im2g, trs[5], tr_len)
    h = mm(block["txt_mlp_fc1"], _modulate(layer_norm(txt, eps=1e-6), tm2s, tm2c))
    txt = txt + mm(block["txt_mlp_fc2"], _gelu_tanh(h, txt.dtype)) * tm2g[:, None, :]
    return img, txt


def hunyuan_single_block(block: Params, x: torch.Tensor, vec_silu: torch.Tensor, img_len: int,
                         rope_cos: torch.Tensor, rope_sin: torch.Tensor, kv_len: int, arch: HunyuanArch, mm,
                         attn_type: str, tr_vec_silu: Optional[torch.Tensor] = None,
                         tr_len: int = 0) -> torch.Tensor:
    b, L, d = x.shape
    n, hd = arch.heads_num, arch.head_dim
    ms, mc, mg = mm(block["modulation"], vec_silu).chunk(3, dim=-1)
    trs = [None] * 3
    if tr_vec_silu is not None:
        trs = mm(block["modulation"], tr_vec_silu).chunk(3, dim=-1)
    h = mm(block["linear1"], _modulate(layer_norm(x, eps=1e-6), ms, mc, trs[0:2], tr_len))
    q, k, v = h[..., :3 * d].reshape(b, L, 3, n, hd).unbind(2)
    q = rms_norm(q, block["q_norm"], eps=1e-6)
    k = rms_norm(k, block["k_norm"], eps=1e-6)
    # RoPE on the image tokens only
    q = torch.cat([apply_rope(q[:, :img_len], rope_cos, rope_sin), q[:, img_len:]], dim=1)
    k = torch.cat([apply_rope(k[:, :img_len], rope_cos, rope_sin), k[:, img_len:]], dim=1)
    attn = attention(attn_type, q, k, v, kv_len=kv_len).reshape(b, L, d)
    del q, k, v
    mlp = _gelu_tanh(h[..., 3 * d:], x.dtype)
    del h
    out = mm(block["linear2"], torch.cat([attn, mlp], dim=-1))
    return x + _gate(out, mg, trs[2], tr_len)


class HunyuanTransformer(torch.nn.Module):
    """The DiT forward (the JAX package's ``hunyuan_forward``) over a
    params dict: latents (B, C, F, H, W) + timestep (B,) + Llama states
    (B, Lt, 4096) and their mask (B, Lt) + CLIP pooled (B, 768) + guidance
    (B,) -> the flow prediction (B, C, F, H, W) fp32. ``kv_len``: image
    tokens + valid text tokens (``text_kv_len``). ``mm_type``: the block
    linears' scheme; ``token_replace`` (i2v arch): the first latent frame's
    tokens take the t = 0 modulation."""

    def __init__(self, params: Params, arch: HunyuanArch, attn_type: str = "flash_attn3"):
        super().__init__()
        self.params = params
        self.arch = arch
        self.attn_type = attn_type

    def forward(self, latents: torch.Tensor, t: torch.Tensor, text_states: torch.Tensor, text_mask: torch.Tensor,
                text_states_2: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor, kv_len: int,
                guidance: Optional[torch.Tensor] = None, mm_type: str = "Default",
                token_replace: bool = False) -> torch.Tensor:
        params, arch = self.params, self.arch
        mm, mm_blk = resolve_mm("Default"), resolve_mm(mm_type)
        img, txt, vec, tr_vec, grid = hunyuan_pre_process(params, latents, t, text_states, text_mask,
                                                          text_states_2, guidance, arch, token_replace)
        b, li, _ = img.shape
        vec_silu = _silu_bf16(vec, img.dtype)
        tr_vec_silu, tr_len = None, 0
        if tr_vec is not None:
            tr_vec_silu, tr_len = _silu_bf16(tr_vec, img.dtype), grid[1] * grid[2]  # the first latent frame
        for block in params["double_blocks"]:
            img, txt = hunyuan_double_block(block, img, txt, vec_silu, rope_cos, rope_sin, kv_len, arch, mm_blk,
                                            self.attn_type, tr_vec_silu, tr_len)
        x = torch.cat([img, txt], dim=1)
        del img, txt
        for block in params["single_blocks"]:
            x = hunyuan_single_block(block, x, vec_silu, li, rope_cos, rope_sin, kv_len, arch, mm_blk,
                                     self.attn_type, tr_vec_silu, tr_len)
        img = x[:, :li]
        del x

        # the head: AdaLN, then an fp32 linear; its features are ordered (c, pt, ph, pw)
        shift, scale = mm(params["final_layer"]["adaLN"], vec_silu).chunk(2, dim=-1)
        out = _modulate(layer_norm(img, eps=1e-6), shift, scale)
        out = resolve_mm("Default-Force-FP32")(params["final_layer"]["linear"], out)
        f, h, w = grid
        pt, ph, pw = arch.patch_size
        c = arch.out_channels
        out = out.reshape(b, f, h, w, c, pt, ph, pw).permute(0, 4, 1, 5, 2, 6, 3, 7)
        return out.reshape(b, c, f * pt, h * ph, w * pw)
