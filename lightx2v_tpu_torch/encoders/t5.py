"""UMT5-XXL text encoder in PyTorch (counterpart of
``lightx2v_tpu.encoders.t5``): pre-norm blocks with T5 RMS norm, unscaled
attention plus a per-layer bidirectional relative-position bias, gated-GELU
FFN, final norm; rows past each prompt's length are zeroed. Linears are
bf16 with fp32 accumulation; attention is plain einsum/softmax in fp32."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.wan.weights import to_tensor

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


def _lin(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(out, in) bias-free linear, fp32 accumulation, cast to x's dtype."""
    return torch.matmul(x.float(), w.float().t()).to(x.dtype)


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


def init_random_t5_params_on_device(cfg: T5Config = UMT5_XXL, seed: int = 0, scale: float = 0.02,
                                    device="cuda") -> Params:
    """bf16 T5 params synthesized directly on ``device`` from a seeded
    ``torch.Generator`` (the UMT5-XXL host state dict is ~23 GB fp32)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, da, df = cfg.dim, cfg.dim_attn, cfg.dim_ffn

    def nrm(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).mul_(scale).to(dtype)

    ones = lambda: torch.ones((d,), dtype=torch.float32, device=dev)  # noqa: E731
    blocks: List[Params] = [
        {"norm1": ones(), "q": nrm((da, d)), "k": nrm((da, d)), "v": nrm((da, d)), "o": nrm((d, da)),
         "rel_emb": nrm((cfg.num_buckets, cfg.num_heads), torch.float32), "norm2": ones(),
         "gate": nrm((df, d)), "fc1": nrm((df, d)), "fc2": nrm((d, df))}
        for _ in range(cfg.num_layers)
    ]
    return {"token_embedding": nrm((cfg.vocab_size, d)), "blocks": blocks, "norm": ones()}


class T5EncoderModel:
    """Tokenize -> encode -> per-prompt contexts."""

    def __init__(self, text_len: int, cfg: T5Config = UMT5_XXL, params: Optional[Params] = None):
        if params is None:
            raise NotImplementedError("T5 checkpoint loading is not ported yet (ROADMAP.md, Queue 1 item 6); "
                                      "pass params (e.g. synthetic weights)")
        self.text_len = text_len
        self.cfg = cfg
        self.params = params
        self.tokenizer = None

    def infer(self, texts) -> torch.Tensor:
        if self.tokenizer is None:
            raise NotImplementedError("the HF tokenizer path is not ported yet (ROADMAP.md, Queue 1 item 6)")
        ids, mask = self.tokenizer(texts, return_mask=True)
        return t5_encode(self.params, torch.from_numpy(ids), torch.from_numpy(mask), self.cfg)
