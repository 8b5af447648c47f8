"""UMT5-XXL and T5 v1.1-XXL text encoders in PyTorch (counterpart of
``lightx2v_tpu.encoders.t5``): pre-norm blocks with T5 RMS norm, unscaled
attention plus a bidirectional relative-position bias (per layer for UMT5,
one table shared by every layer for T5 v1.1, ``shared_pos``), gated-GELU
FFN, final norm; rows past each prompt's length are zeroed. Linears are
bf16 GEMMs with fp32 accumulation, or int8 or e4m3 codes with per-channel
scales (``{"w", "w_scale"}``, the quantized encoder) through the int8 or
fp8 matmul path; attention is plain einsum/softmax in fp32."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.wan.weights import to_tensor
from ..ops.linear import nt_dot_f32, resolve_mm
from ..tools.convert import quantize_weight
from ..utils.safetensors_io import read_state_dict

Params = Dict[str, Any]


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    shared_pos: bool = False


UMT5_XXL = T5Config()
# CogVideoX's text encoder: T5 v1.1-XXL, English vocabulary, one shared bias table
T5_V1_1_XXL = T5Config(vocab_size=32128, shared_pos=True)


def relative_position_buckets(lq: int, lk: int, num_buckets: int = 32, max_dist: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket ids (lq, lk)."""
    rel_pos = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    nb = num_buckets // 2
    buckets = (rel_pos > 0).astype(np.int64) * nb
    rel = np.abs(rel_pos)
    max_exact = nb // 2
    is_small = rel < max_exact
    rel_large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / np.log(max_dist / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    rel_large = np.minimum(rel_large, nb - 1)
    buckets += np.where(is_small, rel, rel_large)
    return buckets


def t5_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (w.float() * out).to(x.dtype)


def _quant_mm(kind: str) -> str:
    return f"W-{kind}-channel-sym-A-{kind}-channel-sym-dynamic-Tpu"


def _lin(w, x: torch.Tensor) -> torch.Tensor:
    """(out, in) bias-free linear, fp32 accumulation (``nt_dot_f32``: bf16
    operands on the card's tensor cores), rounded once to x's dtype; an int8
    or e4m3 ``{"w", "w_scale"}`` dict
    goes through that kind's matmul path, chosen by the weight's dtype as in
    the JAX package (per-token quantized activations: the full-K kernel, or
    the k-blocked one for K > 8192, at UMT5-XXL widths)."""
    if isinstance(w, dict):
        kind = "int8" if w["w"].dtype == torch.int8 else "fp8"
        return resolve_mm(_quant_mm(kind))({"w": w["w"], "w_scale": w["w_scale"], "b": None}, x)
    return nt_dot_f32(x, w).to(x.dtype)


def t5_block(block: Params, x: torch.Tensor, bias_mask: torch.Tensor, bucket_ids: torch.Tensor,
             cfg: T5Config) -> torch.Tensor:
    b, L, _ = x.shape
    n, hd = cfg.num_heads, cfg.dim_attn // cfg.num_heads
    h = t5_norm(block["norm1"], x)
    q = _lin(block["q"], h).reshape(b, L, n, hd)
    k = _lin(block["k"], h).reshape(b, L, n, hd)
    v = _lin(block["v"], h).reshape(b, L, n, hd)
    bias = block["rel_emb"][bucket_ids].permute(2, 0, 1)[None].float()  # (1, n, L, L)
    logits = torch.einsum("bqnc,bknc->bnqk", q.float(), k.float()) + bias + bias_mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    attn = torch.einsum("bnqk,bknc->bqnc", probs.float(), v.float()).to(v.dtype).reshape(b, L, cfg.dim_attn)
    x = x + _lin(block["o"], attn)
    h = t5_norm(block["norm2"], x)
    gate = F.gelu(_lin(block["gate"], h).float(), approximate="tanh")
    y = _lin(block["fc1"], h).float() * gate
    return x + _lin(block["fc2"], y.to(x.dtype))


def t5_encode(params: Params, ids: torch.Tensor, mask: torch.Tensor, cfg: T5Config = UMT5_XXL) -> torch.Tensor:
    """ids, mask: (B, L) -> (B, L, dim) bf16 context with padded rows zeroed."""
    L = ids.shape[1]
    dev = params["norm"].device
    ids, mask = ids.to(dev).long(), mask.to(dev)
    bucket_ids = torch.from_numpy(relative_position_buckets(L, L, cfg.num_buckets, cfg.max_dist)).to(dev)
    x = params["token_embedding"][ids].to(torch.bfloat16)
    neg = torch.finfo(torch.float32).min
    bias_mask = torch.where(mask[:, None, None, :] > 0, 0.0, neg).float()
    for block in params["blocks"]:
        x = t5_block(block, x, bias_mask, bucket_ids, cfg)
    x = t5_norm(params["norm"], x)
    return (x * (mask[..., None] > 0)).to(torch.bfloat16)


def load_t5_params(state_dict: Dict[str, Any], cfg: T5Config = UMT5_XXL, dtype=torch.bfloat16,
                   device="cpu") -> Params:
    """torch-layout state dict (reference T5Encoder keys) -> params with a
    per-block list."""
    sd = state_dict

    def w(key):
        return to_tensor(sd[key], dtype, device)

    def f32(key):
        return to_tensor(sd[key], torch.float32, device)

    def block(i):
        p = f"blocks.{i}"
        rel_key = "pos_embedding.embedding.weight" if cfg.shared_pos else f"{p}.pos_embedding.embedding.weight"
        return {
            "norm1": f32(f"{p}.norm1.weight"),
            "q": w(f"{p}.attn.q.weight"), "k": w(f"{p}.attn.k.weight"),
            "v": w(f"{p}.attn.v.weight"), "o": w(f"{p}.attn.o.weight"),
            "rel_emb": f32(rel_key),
            "norm2": f32(f"{p}.norm2.weight"),
            "gate": w(f"{p}.ffn.gate.0.weight"), "fc1": w(f"{p}.ffn.fc1.weight"), "fc2": w(f"{p}.ffn.fc2.weight"),
        }

    return {"token_embedding": w("token_embedding.weight"),
            "blocks": [block(i) for i in range(cfg.num_layers)],
            "norm": f32("norm.weight")}


def init_random_t5_state_dict(cfg: T5Config, seed: int = 0, scale: float = 0.02) -> Dict[str, np.ndarray]:
    """Random state dict with the reference's keys; the same values as the
    JAX package's function of the same name for the same seed."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    pool = (rng.standard_normal(65537, dtype=np.float32) * scale)
    _off = [0]

    def randn(*shape):
        _off[0] = (_off[0] + 10007) % len(pool)
        return np.resize(np.roll(pool, -_off[0]), shape).astype(np.float32)

    sd["token_embedding.weight"] = randn(cfg.vocab_size, cfg.dim)
    if cfg.shared_pos:
        sd["pos_embedding.embedding.weight"] = randn(cfg.num_buckets, cfg.num_heads)
    for i in range(cfg.num_layers):
        p = f"blocks.{i}"
        sd[f"{p}.norm1.weight"] = np.ones(cfg.dim, np.float32)
        for m in ("q", "k", "v", "o"):
            sd[f"{p}.attn.{m}.weight"] = randn(cfg.dim_attn, cfg.dim)
        if not cfg.shared_pos:
            sd[f"{p}.pos_embedding.embedding.weight"] = randn(cfg.num_buckets, cfg.num_heads)
        sd[f"{p}.norm2.weight"] = np.ones(cfg.dim, np.float32)
        sd[f"{p}.ffn.gate.0.weight"] = randn(cfg.dim_ffn, cfg.dim)
        sd[f"{p}.ffn.fc1.weight"] = randn(cfg.dim_ffn, cfg.dim)
        sd[f"{p}.ffn.fc2.weight"] = randn(cfg.dim, cfg.dim_ffn)
    sd["norm.weight"] = np.ones(cfg.dim, np.float32)
    return sd


T5_LINEARS = ("q", "k", "v", "o", "gate", "fc1", "fc2")


def init_random_t5_params_on_device(cfg: T5Config = UMT5_XXL, seed: int = 0, scale: float = 0.02,
                                    device="cuda", scheme: str = "bf16") -> Params:
    """T5 params synthesized directly on ``device`` from a seeded
    ``torch.Generator`` (the UMT5-XXL host state dict is ~23 GB fp32).
    scheme "int8" makes the seven block linears ``{"w", "w_scale"}`` dicts:
    int8 codes in -127..127 with per-channel scales scale/127; "fp8" e4m3
    codes of normal * 100 clipped to +-448 with scales scale/100 (the JAX
    synthesizer's layout and clip). With ``shared_pos`` every block holds
    the same bias table, as a T5 v1.1 checkpoint loads (the JAX synthesizer
    draws one a layer)."""
    if scheme not in ("bf16", "int8", "fp8"):
        raise NotImplementedError(f"synthetic T5 scheme {scheme!r} is not ported yet")
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, da, df = cfg.dim, cfg.dim_attn, cfg.dim_ffn

    def nrm(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).mul_(scale).to(dtype)

    def lin(out, kin):
        if scheme == "bf16":
            return nrm((out, kin))
        if scheme == "fp8":
            w = torch.randn((out, kin), generator=g, device=dev, dtype=torch.float32).mul_(100.0)
            return {"w": w.clamp_(-448.0, 448.0).to(torch.float8_e4m3fn),
                    "w_scale": torch.full((out,), scale / 100.0, dtype=torch.float32, device=dev)}
        return {"w": torch.randint(-127, 128, (out, kin), generator=g, device=dev, dtype=torch.int8),
                "w_scale": torch.full((out,), scale / 127.0, dtype=torch.float32, device=dev)}

    ones = lambda: torch.ones((d,), dtype=torch.float32, device=dev)  # noqa: E731
    rel = lambda: nrm((cfg.num_buckets, cfg.num_heads), torch.float32)  # noqa: E731
    shared = rel() if cfg.shared_pos else None
    blocks: List[Params] = [
        {"norm1": ones(), "q": lin(da, d), "k": lin(da, d), "v": lin(da, d), "o": lin(d, da),
         "rel_emb": shared if cfg.shared_pos else rel(), "norm2": ones(),
         "gate": lin(df, d), "fc1": lin(df, d), "fc2": lin(d, df)}
        for _ in range(cfg.num_layers)
    ]
    return {"token_embedding": nrm((cfg.vocab_size, d)), "blocks": blocks, "norm": ones()}


def quantize_t5_params(params: Params, scheme: str = "int8", device=None) -> Params:
    """Quantize the seven block linears per output channel to int8 or e4m3
    codes (``tools/convert.quantize_weight``, equal to the JAX package's
    numpy quantizer): each becomes ``{"w", "w_scale"}``. Runs where the
    params lie, or with ``device`` moves every tensor there one at a time,
    quantizing on the way, so params loaded on the host reach the card
    already quantized."""
    if scheme not in ("int8", "fp8"):
        raise ValueError(f"T5 quant scheme {scheme!r}: the T5 forward runs per-channel int8 and fp8 codes only, "
                         f"as the JAX package's does (ROADMAP.md, Queue 3, difference aw)")

    def to(t):
        return t if device is None else t.to(device)

    blocks = []
    for src in params["blocks"]:
        blk = {k: to(v) for k, v in src.items() if k not in T5_LINEARS}
        for name in T5_LINEARS:
            q, s = quantize_weight(to(src[name]), scheme)
            blk[name] = {"w": q, "w_scale": s}
        blocks.append(blk)
    return dict(params, token_embedding=to(params["token_embedding"]), norm=to(params["norm"]), blocks=blocks)


def load_t5_from_path(path: str, cfg: T5Config = UMT5_XXL, device="cpu") -> Params:
    """The reference's ``models_t5_umt5-xxl-enc-bf16.pth`` (or a
    ``.safetensors`` with its keys) -> params on ``device``."""
    return load_t5_params(read_state_dict(path), cfg, device=device)


class T5EncoderModel:
    """Tokenize -> encode -> per-prompt contexts. ``tokenizer`` is
    injectable (a callable ``(texts, return_mask=True) -> (ids, mask)``);
    without one, ``tokenizer_path`` names the HF tokenizer files."""

    def __init__(self, text_len: int, cfg: T5Config = UMT5_XXL, params: Optional[Params] = None,
                 checkpoint_path: Optional[str] = None, tokenizer_path: Optional[str] = None, device="cpu"):
        if params is None:
            if checkpoint_path is None:
                raise ValueError("T5EncoderModel needs params or checkpoint_path")
            params = load_t5_from_path(checkpoint_path, cfg, device=device)
        self.text_len = text_len
        self.cfg = cfg
        self.params = params
        self.tokenizer_path = tokenizer_path
        self.tokenizer = None

    def infer(self, texts) -> torch.Tensor:
        if self.tokenizer is not None:
            ids, mask = self.tokenizer(texts, return_mask=True)
        else:
            from .tokenizer import encode_prompts

            missing = RuntimeError(f"no tokenizer: set T5EncoderModel.tokenizer, or provide transformers and the "
                                   f"tokenizer files in {self.tokenizer_path!r} (ROADMAP.md, Queue 1 item 6)")
            if not (self.tokenizer_path and os.path.isdir(self.tokenizer_path)):
                raise missing
            try:
                ids, mask = encode_prompts(self.tokenizer_path, texts, self.text_len)
            except (ImportError, OSError) as e:
                raise missing from e
        return t5_encode(self.params, torch.from_numpy(np.asarray(ids)), torch.from_numpy(np.asarray(mask)), self.cfg)
