"""Llama text encoder, llava-llama-3-8b class, in PyTorch (counterpart of
``lightx2v_tpu.encoders.llama``): HunyuanVideo's per-token text states.

The decoder stack runs causally over the templated prompt and returns the
activations after ``num_layers - hidden_state_skip_layer`` blocks (30 of 32),
before any final norm (the reference's ``hidden_states[-3]``), with the first
``crop_start`` (95) template tokens dropped. A block: RMSNorm -> q, k, v
(32 query heads, 8 KV heads of 128, each KV head serving 4 query heads) ->
RoPE (theta 5e5, rotate-half) -> softmax attention under the causal and
padding bias (fp32 logits, plain einsum: the JAX package has no Pallas
kernel here) -> o; RMSNorm -> SiLU-gated MLP. Activations bf16, norms and
softmax statistics fp32, linears bf16 GEMMs with fp32 accumulation.

Only the blocks that run are kept: the loader and the synthesizer drop the
top ``hidden_state_skip_layer`` blocks and the final norm, which the
encoder never reads. ``load_llama_dir`` reads an HF Llama directory
(``config.json`` and safetensors, sharded with ``model.safetensors.index.json``
or one file; keys with or without ``LlamaForCausalLM``'s ``model.``): only
the embedding and those blocks, each straight to the device."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.wan.weights import to_tensor
from ..ops.linear import nt_dot_f32
from ..utils.safetensors_io import load_dir

Params = Dict[str, Any]


@dataclass(frozen=True)
class LlamaArch:
    vocab_size: int = 128320  # llava-llama-3-8b (llama3 base: 128256)
    dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    hidden_state_skip_layer: int = 2
    crop_start: int = 95

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def run_layers(self) -> int:
        return self.num_layers - self.hidden_state_skip_layer

    @property
    def max_length(self) -> int:
        """Tokens a prompt is padded to: the template's ``crop_start`` and 256."""
        return self.crop_start + 256


LLAVA_LLAMA3_8B = LlamaArch()

PROMPT_TEMPLATE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by "
    "detailing the following aspects: 1. The main content and theme of "
    "the video.2. The color, shape, size, texture, quantity, text, and "
    "spatial relationships of the objects.3. Actions, events, behaviors "
    "temporal relationships, physical movement changes of the objects.4. "
    "background environment, light, style and atmosphere.5. camera "
    "angles, movements, and transitions used in the video:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")


def llama_arch_from_config(cfg: Dict[str, Any], crop_start: int = 95, hidden_state_skip_layer: int = 2) -> LlamaArch:
    """An HF Llama ``config.json`` (as a dict) -> ``LlamaArch``. What the
    tower does not run raises ``NotImplementedError`` instead of being
    ignored: a ``rope_scaling``, a ``head_dim`` other than hidden / heads,
    biased projections, an activation other than SiLU."""
    unported = [k for k in ("rope_scaling", "attention_bias", "mlp_bias") if cfg.get(k)]
    dim, heads = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    if cfg.get("head_dim") not in (None, dim // heads):
        unported.append("head_dim")
    if cfg.get("hidden_act", "silu") != "silu":
        unported.append("hidden_act")
    if unported:
        raise NotImplementedError(f"Llama config {unported}: the port's Llama tower runs plain RoPE, unbiased "
                                  "projections and a SiLU MLP (ROADMAP.md, Queue 1 item 22)")
    return LlamaArch(vocab_size=int(cfg["vocab_size"]), dim=dim, num_layers=int(cfg["num_hidden_layers"]),
                     num_heads=heads, num_kv_heads=int(cfg.get("num_key_value_heads") or heads),
                     ffn_dim=int(cfg["intermediate_size"]), rope_theta=float(cfg.get("rope_theta", 10000.0)),
                     rms_eps=float(cfg.get("rms_norm_eps", 1e-6)), hidden_state_skip_layer=hidden_state_skip_layer,
                     crop_start=crop_start)


def llama_hf_config(arch: LlamaArch) -> Dict[str, Any]:
    """The HF ``LlamaForCausalLM`` ``config.json`` of ``arch`` (bf16): the
    inverse of ``llama_arch_from_config``."""
    return {"model_type": "llama", "architectures": ["LlamaForCausalLM"], "vocab_size": arch.vocab_size,
            "hidden_size": arch.dim, "intermediate_size": arch.ffn_dim, "num_hidden_layers": arch.num_layers,
            "num_attention_heads": arch.num_heads, "num_key_value_heads": arch.num_kv_heads,
            "rms_norm_eps": arch.rms_eps, "rope_theta": arch.rope_theta, "rope_scaling": None,
            "hidden_act": "silu", "torch_dtype": "bfloat16"}


def _rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the weight multiplied in fp32 (``ops.norms.rms_norm``
    multiplies in x's dtype), as the JAX Llama does."""
    xf = x.float()
    return (w.float() * (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps))).to(x.dtype)


def _lin(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return nt_dot_f32(x, w).to(x.dtype)


def build_llama_rope(length: int, head_dim: int, theta: float) -> Tuple[np.ndarray, np.ndarray]:
    """cos, sin (length, head_dim) fp32, the half-dim frequencies repeated
    (the rotate-half convention)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    freqs = np.outer(np.arange(length, dtype=np.float64), inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos[None, :, None, :] + rot.float() * sin[None, :, None, :]).to(x.dtype)


def llama_block(block: Params, x: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                arch: LlamaArch) -> torch.Tensor:
    b, L, d = x.shape
    n, nkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    h = _rms_norm(block["norm1"], x, arch.rms_eps)
    q = _apply_rope(_lin(block["q"], h).reshape(b, L, n, hd), cos, sin)
    k = _apply_rope(_lin(block["k"], h).reshape(b, L, nkv, hd), cos, sin)
    v = _lin(block["v"], h).reshape(b, L, nkv, hd)
    k = k.repeat_interleave(n // nkv, dim=2)
    v = v.repeat_interleave(n // nkv, dim=2)
    logits = torch.einsum("bqnc,bknc->bnqk", q.float(), k.float()) / math.sqrt(hd)
    probs = torch.softmax(logits + bias, dim=-1).to(v.dtype)
    attn = torch.einsum("bnqk,bknc->bqnc", probs.float(), v.float()).to(v.dtype).reshape(b, L, d)
    x = x + _lin(block["o"], attn)
    h = _rms_norm(block["norm2"], x, arch.rms_eps)
    y = F.silu(_lin(block["gate"], h).float()) * _lin(block["up"], h).float()
    return x + _lin(block["down"], y.to(x.dtype))


def llama_encode(params: Params, ids: torch.Tensor, mask: torch.Tensor, arch: LlamaArch = LLAVA_LLAMA3_8B
                 ) -> torch.Tensor:
    """ids, mask (B, L) -> (B, L, dim) bf16: the states after
    ``arch.run_layers`` blocks, no final norm."""
    dev = params["token_embedding"].device
    ids, mask = ids.to(dev), mask.to(dev)
    L = ids.shape[1]
    cos, sin = (torch.from_numpy(a).to(dev) for a in build_llama_rope(L, arch.head_dim, arch.rope_theta))
    x = params["token_embedding"][ids.long()].to(torch.bfloat16)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
    keep = causal[None, None] & (mask[:, None, None, :] > 0)
    bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min).float()
    for block in params["blocks"]:
        x = llama_block(block, x, bias, cos, sin, arch)
    return x


def llama_encode_cropped(params: Params, ids: torch.Tensor, mask: torch.Tensor,
                         arch: LlamaArch = LLAVA_LLAMA3_8B) -> Tuple[torch.Tensor, torch.Tensor]:
    """The states and the mask with the first ``crop_start`` template tokens
    dropped."""
    x = llama_encode(params, ids, mask, arch)
    return x[:, arch.crop_start:], mask[:, arch.crop_start:]


# a block's params -> its HF module names (``.weight`` each): norms fp32, matmuls bf16
_HF_BLOCK_KEYS = (("norm1", "input_layernorm"), ("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                  ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"), ("norm2", "post_attention_layernorm"),
                  ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"), ("down", "mlp.down_proj"))


def load_llama_params(sd: Dict[str, Any], arch: LlamaArch = LLAVA_LLAMA3_8B, device="cpu") -> Params:
    """HF LlamaModel state dict (keys with or without ``model.``) -> params:
    the bf16 embedding and the first ``arch.run_layers`` blocks."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    def w(key):
        return to_tensor(sd[key], torch.bfloat16, device).contiguous()

    def block(i):
        return {ours: (to_tensor(sd[f"layers.{i}.{theirs}.weight"], torch.float32, device) if ours.startswith("norm")
                       else w(f"layers.{i}.{theirs}.weight")) for ours, theirs in _HF_BLOCK_KEYS}

    return {"token_embedding": w("embed_tokens.weight"), "blocks": [block(i) for i in range(arch.run_layers)]}


def load_llama_dir(path: str, arch: LlamaArch, device="cpu") -> Params:
    """An HF Llama directory -> params on ``device``: reads only the
    embedding and the first ``arch.run_layers`` blocks (never the other
    blocks, the final norm or ``lm_head``), each tensor moved to the device
    as it is read."""
    keep = ("embed_tokens.",) + tuple(f"layers.{i}." for i in range(arch.run_layers))
    sd = load_dir(path, lambda k: k.removeprefix("model.").startswith(keep), device)
    return load_llama_params(sd, arch, device)


def llama_params_to_hf_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """The inverse of ``load_llama_params``: ``LlamaForCausalLM``'s keys
    (``model.`` prefix) for the embedding and every block of
    ``params["blocks"]``, each value a view of the params on their device."""
    sd = {"model.embed_tokens.weight": params["token_embedding"]}
    for i, b in enumerate(params["blocks"]):
        sd.update({f"model.layers.{i}.{theirs}.weight": b[ours] for ours, theirs in _HF_BLOCK_KEYS})
    return sd


def init_random_llama_params_on_device(arch: LlamaArch = LLAVA_LLAMA3_8B, seed: int = 0, scale: float = 0.02,
                                       device="cuda") -> Params:
    """bf16 params synthesized directly on ``device`` from a seeded
    ``torch.Generator`` (the 30 blocks and the embedding of the 8B model are
    15 GB), in ``load_llama_params``' layout: normal * scale matmul weights
    and embedding, unit norms. The JAX synthesizer's int8, fp8 and w4a8
    schemes are not ported."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, df, dkv = arch.dim, arch.ffn_dim, arch.num_kv_heads * arch.head_dim

    def nrm(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).mul_(scale).to(torch.bfloat16)

    ones = lambda: torch.ones((d,), dtype=torch.float32, device=dev)  # noqa: E731
    blocks = [{"norm1": ones(), "q": nrm(d, d), "k": nrm(dkv, d), "v": nrm(dkv, d), "o": nrm(d, d), "norm2": ones(),
               "gate": nrm(df, d), "up": nrm(df, d), "down": nrm(d, df)} for _ in range(arch.run_layers)]
    return {"token_embedding": nrm(arch.vocab_size, d), "blocks": blocks}


class LlamaEncoderModel:
    """Prompt -> (states (B, max_length - crop_start, dim) bf16, mask (B,
    max_length - crop_start) int32 numpy): the prompt template (the video
    one by default), the tokenizer (injectable: a callable ``(texts,
    return_mask=True) -> (ids, mask)`` padding to ``arch.max_length``), the
    encoder, the crop."""

    def __init__(self, arch: LlamaArch = LLAVA_LLAMA3_8B, params: Optional[Params] = None, tokenizer=None,
                 prompt_template: str = PROMPT_TEMPLATE):
        self.arch = arch
        self.params = params
        self.tokenizer = tokenizer
        self.prompt_template = prompt_template

    def infer(self, texts) -> Tuple[torch.Tensor, np.ndarray]:
        ids, mask = self.tokenizer([self.prompt_template.format(t) for t in texts], return_mask=True)
        states, _ = llama_encode_cropped(self.params, torch.from_numpy(np.asarray(ids)),
                                         torch.from_numpy(np.asarray(mask)), self.arch)
        return states, np.asarray(mask)[:, self.arch.crop_start:]
