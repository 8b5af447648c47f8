"""CLIP ViT-H/14 vision tower in PyTorch (counterpart of the vision half of
``lightx2v_tpu.encoders.clip``): the Wan i2v image conditioning; and, at the
end of the file, the CLIP-L text tower (HunyuanVideo's pooled prompt vector).

Patch conv (14x14, no bias) as a reshape and a matmul, cls token, learned
positional embedding, pre-LN, then the first ``use_blocks`` (31 of 32)
pre-norm blocks over all 257 tokens: LayerNorm -> qkv -> softmax attention
over 16 heads of 80 -> proj, LayerNorm -> fc1 -> exact (erf) GELU -> fc2.
Activations are bf16, LayerNorms and softmax statistics fp32. The attention
is plain einsum and softmax (fp32 logits, probabilities rounded to bf16), as
in the JAX package, which has no Pallas kernel there; the port's flash
kernel takes head dim 128 only. Linears are bf16 GEMMs with fp32
accumulation, or int8 / e4m3 codes with per-channel scales (``{"w",
"w_scale"}``, ``quantize_clip_params``) through the int8 or fp8 matmul
path; at the tower's widths (min(N, K) = 1280 < 4096) that path is the
per-token quantize and exact dot in torch ops, as in the JAX package.

Blocks are a per-block list, as in ``encoders/t5.py``. Images are resized
with ``utils/image.resize_bicubic`` (cv2's INTER_CUBIC without cv2)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.wan.weights import to_tensor
from ..ops.linear import nt_dot_f32, resolve_mm
from ..ops.norms import layer_norm
from ..tools.convert import quantize_weight
from ..utils.safetensors_io import read_state_dict
from ..utils.image import resize_bicubic

Params = Dict[str, Any]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

CLIP_LINEARS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


@dataclass(frozen=True)
class ClipVisionArch:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    num_heads: int = 16
    num_layers: int = 32
    use_blocks: int = 31  # Wan i2v stops one block early
    norm_eps: float = 1e-5


def _quant_mm(kind: str) -> str:
    return f"W-{kind}-channel-sym-A-{kind}-channel-sym-dynamic-Tpu"


def _lin(w, x: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(out, in) linear with an fp32 result plus the fp32 bias; an int8 or
    e4m3 ``{"w", "w_scale"}`` dict goes through that kind's matmul path
    (bf16 out, then the bias in fp32, as in the JAX package)."""
    if isinstance(w, dict):
        kind = "int8" if w["w"].dtype == torch.int8 else "fp8"
        y = resolve_mm(_quant_mm(kind))({"w": w["w"], "w_scale": w["w_scale"], "b": None}, x).float()
    else:
        y = nt_dot_f32(x, w)
    return y if b is None else y + b.float()


def clip_block(bp: Params, x: torch.Tensor, arch: ClipVisionArch) -> torch.Tensor:
    b, s, _ = x.shape
    n, hd = arch.num_heads, arch.dim // arch.num_heads
    h = layer_norm(x, bp["norm1"]["w"], bp["norm1"]["b"], eps=arch.norm_eps)
    qkv = _lin(bp["qkv_w"], h, bp["qkv_b"]).to(h.dtype)
    q, k, v = (t.reshape(b, s, n, hd) for t in qkv.split(arch.dim, dim=-1))
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / np.sqrt(hd)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    attn = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(v.dtype).reshape(b, s, arch.dim)
    x = x + _lin(bp["proj_w"], attn, bp["proj_b"]).to(h.dtype)
    h = layer_norm(x, bp["norm2"]["w"], bp["norm2"]["b"], eps=arch.norm_eps)
    h = F.gelu(_lin(bp["fc1_w"], h, bp["fc1_b"]), approximate="none").to(x.dtype)
    return x + _lin(bp["fc2_w"], h, bp["fc2_b"]).to(x.dtype)


def clip_embed(params: Params, pixels: torch.Tensor, arch: ClipVisionArch) -> torch.Tensor:
    """pixels (B, H, W, 3) CLIP-normalized -> the first block's input (B,
    1 + num_patches, dim) bf16: patches, cls, positions, pre-LN."""
    b = pixels.shape[0]
    p, g = arch.patch_size, arch.image_size // arch.patch_size
    x = pixels.to(params["patch"].device, torch.bfloat16)
    x = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, 3 * p * p)
    x = nt_dot_f32(x, params["patch"]).to(torch.bfloat16)
    cls = params["cls"].to(torch.bfloat16).expand(b, 1, arch.dim)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(torch.bfloat16)
    return layer_norm(x, params["pre_norm"]["w"], params["pre_norm"]["b"], eps=arch.norm_eps)


def clip_vision_forward(params: Params, pixels: torch.Tensor, arch: ClipVisionArch) -> torch.Tensor:
    """pixels (B, H, W, 3) CLIP-normalized -> (B, 1 + num_patches, dim) bf16."""
    x = clip_embed(params, pixels, arch)
    for bp in params["blocks"]:
        x = clip_block(bp, x, arch)
    return x


def load_clip_vision_params(sd: Dict[str, Any], arch: ClipVisionArch, dtype=torch.bfloat16,
                            device="cpu") -> Params:
    """Reference-layout state dict (``visual.*`` keys) -> params with a
    per-block list of the first ``use_blocks`` blocks; matmul weights in
    ``dtype``, everything else fp32."""

    def w(key):
        return to_tensor(sd[key], dtype, device)

    def f32(key):
        return to_tensor(sd[key], torch.float32, device)

    pe = w("visual.patch_embedding.weight")  # (D, 3, p, p)

    def block(i):
        p = f"visual.transformer.{i}"
        return {
            "norm1": {"w": f32(f"{p}.norm1.weight"), "b": f32(f"{p}.norm1.bias")},
            "qkv_w": w(f"{p}.attn.to_qkv.weight"), "qkv_b": f32(f"{p}.attn.to_qkv.bias"),
            "proj_w": w(f"{p}.attn.proj.weight"), "proj_b": f32(f"{p}.attn.proj.bias"),
            "norm2": {"w": f32(f"{p}.norm2.weight"), "b": f32(f"{p}.norm2.bias")},
            "fc1_w": w(f"{p}.mlp.0.weight"), "fc1_b": f32(f"{p}.mlp.0.bias"),
            "fc2_w": w(f"{p}.mlp.2.weight"), "fc2_b": f32(f"{p}.mlp.2.bias"),
        }

    return {
        "patch": pe.reshape(pe.shape[0], -1).contiguous(),
        "cls": f32("visual.cls_embedding").reshape(1, arch.dim),
        "pos": f32("visual.pos_embedding").reshape(-1, arch.dim),
        "pre_norm": {"w": f32("visual.pre_norm.weight"), "b": f32("visual.pre_norm.bias")},
        "blocks": [block(i) for i in range(arch.use_blocks)],
    }


def quantize_clip_params(params: Params, scheme: str = "int8") -> Params:
    """Quantize the four block linears per output channel to int8 or e4m3
    codes (the JAX package's ``quantize_clip_params``): each becomes
    ``{"w", "w_scale"}``."""
    if scheme not in ("int8", "fp8"):
        raise ValueError(f"CLIP quant scheme {scheme!r}: the CLIP forward runs per-channel int8 and fp8 codes only, "
                         f"as the JAX package's does (ROADMAP.md, Queue 3, difference aw)")
    blocks = []
    for blk in params["blocks"]:
        blk = dict(blk)
        for name in CLIP_LINEARS:
            q, s = quantize_weight(blk[name], scheme)
            blk[name] = {"w": q, "w_scale": s}
        blocks.append(blk)
    return dict(params, blocks=blocks)


def init_random_clip_state_dict(arch: ClipVisionArch, seed: int = 0, scale: float = 0.02) -> Dict[str, np.ndarray]:
    """Random state dict with the reference's keys; the same values as the
    JAX package's function of the same name for the same seed."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    d = arch.dim
    sd["visual.patch_embedding.weight"] = rng.standard_normal((d, 3, arch.patch_size, arch.patch_size),
                                                              dtype=np.float32) * scale
    sd["visual.cls_embedding"] = rng.standard_normal((1, 1, d), dtype=np.float32) * scale
    npatch = (arch.image_size // arch.patch_size) ** 2
    sd["visual.pos_embedding"] = rng.standard_normal((1, npatch + 1, d), dtype=np.float32) * scale
    sd["visual.pre_norm.weight"] = np.ones(d, np.float32)
    sd["visual.pre_norm.bias"] = np.zeros(d, np.float32)
    for i in range(arch.num_layers):
        p = f"visual.transformer.{i}"
        for nm in ("norm1", "norm2"):
            sd[f"{p}.{nm}.weight"] = np.ones(d, np.float32)
            sd[f"{p}.{nm}.bias"] = np.zeros(d, np.float32)
        sd[f"{p}.attn.to_qkv.weight"] = rng.standard_normal((3 * d, d), dtype=np.float32) * scale
        sd[f"{p}.attn.to_qkv.bias"] = np.zeros(3 * d, np.float32)
        sd[f"{p}.attn.proj.weight"] = rng.standard_normal((d, d), dtype=np.float32) * scale
        sd[f"{p}.attn.proj.bias"] = np.zeros(d, np.float32)
        sd[f"{p}.mlp.0.weight"] = rng.standard_normal((arch.mlp_ratio * d, d), dtype=np.float32) * scale
        sd[f"{p}.mlp.0.bias"] = np.zeros(arch.mlp_ratio * d, np.float32)
        sd[f"{p}.mlp.2.weight"] = rng.standard_normal((d, arch.mlp_ratio * d), dtype=np.float32) * scale
        sd[f"{p}.mlp.2.bias"] = np.zeros(d, np.float32)
    return sd


def init_random_clip_params_on_device(arch: ClipVisionArch = ClipVisionArch(), seed: int = 0,
                                      scale: float = 0.02, device="cuda") -> Params:
    """CLIP vision params synthesized directly on ``device`` from a seeded
    ``torch.Generator``, in ``load_clip_vision_params``'s layout: bf16
    matmul weights of normal * scale, fp32 cls and positions of normal *
    scale, unit norms and zero biases (as ``init_random_clip_state_dict``)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, md = arch.dim, arch.mlp_ratio * arch.dim

    def nrm(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).mul_(scale).to(dtype)

    def norm():
        return {"w": torch.ones((d,), dtype=torch.float32, device=dev),
                "b": torch.zeros((d,), dtype=torch.float32, device=dev)}

    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)  # noqa: E731
    npatch = (arch.image_size // arch.patch_size) ** 2
    blocks = [{"norm1": norm(), "qkv_w": nrm((3 * d, d)), "qkv_b": zeros(3 * d), "proj_w": nrm((d, d)),
               "proj_b": zeros(d), "norm2": norm(), "fc1_w": nrm((md, d)), "fc1_b": zeros(md),
               "fc2_w": nrm((d, md)), "fc2_b": zeros(d)}
              for _ in range(arch.use_blocks)]
    return {"patch": nrm((d, 3 * arch.patch_size ** 2)), "cls": nrm((1, d), torch.float32),
            "pos": nrm((npatch + 1, d), torch.float32), "pre_norm": norm(), "blocks": blocks}


def preprocess_image(img: np.ndarray, image_size: int = 224) -> np.ndarray:
    """(H, W, 3) float in [-1, 1] -> (1, S, S, 3) CLIP-normalized (bicubic
    resize, cv2's INTER_CUBIC)."""
    x = (img.astype(np.float32) + 1.0) / 2.0
    x = resize_bicubic(x, image_size, image_size)
    return ((x - CLIP_MEAN) / CLIP_STD)[None]


def load_clip_from_path(path: str, arch: ClipVisionArch = ClipVisionArch(), device="cpu") -> Params:
    """The reference's ``models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth``
    (or a ``.safetensors`` with its keys) -> vision params on ``device``;
    the text tower's ``textual`` keys are skipped, as the JAX loader skips
    them."""
    sd = {k: v for k, v in read_state_dict(path).items() if "textual" not in k}
    return load_clip_vision_params(sd, arch, device=device)


class CLIPVisionModel:
    """Image -> CLIP tokens (the reference ``CLIPModel.visual``), from
    ``params`` or a ``checkpoint_path``."""

    def __init__(self, arch: ClipVisionArch = ClipVisionArch(), params: Optional[Params] = None,
                 checkpoint_path: Optional[str] = None, device="cpu"):
        if params is None:
            if checkpoint_path is None:
                raise ValueError("CLIPVisionModel needs params or checkpoint_path")
            params = load_clip_from_path(checkpoint_path, arch, device=device)
        self.arch = arch
        self.params = params

    def infer(self, img: np.ndarray) -> torch.Tensor:
        """img (H, W, 3) in [-1, 1] -> (1, 257, dim) bf16 tokens on the
        params' device."""
        return clip_vision_forward(self.params, torch.from_numpy(preprocess_image(img, self.arch.image_size)),
                                   self.arch)


# ---------------------------------------------------------------------------
# CLIP-L text tower (HunyuanVideo's second text encoder: the pooled prompt
# vector). Learned positions, 12 pre-norm blocks (q scaled before the
# product, causal and padding bias, quick-GELU MLP), a final LayerNorm; the
# pooled vector is the row at the end-of-text token, the vocabulary's
# highest id, so the argmax over the ids finds it.


@dataclass(frozen=True)
class ClipTextArch:
    vocab_size: int = 49408
    dim: int = 768
    mlp_ratio: int = 4
    num_heads: int = 12
    num_layers: int = 12
    max_positions: int = 77
    norm_eps: float = 1e-5


def clip_text_forward(params: Params, ids: torch.Tensor, mask: torch.Tensor, arch: ClipTextArch):
    """ids, mask (B, L <= 77) -> (last hidden (B, L, dim) bf16, pooled
    (B, dim) fp32)."""
    dev = params["token_embedding"].device
    ids, mask = ids.to(dev).long(), mask.to(dev)
    b, L = ids.shape
    n, hd = arch.num_heads, arch.dim // arch.num_heads
    x = params["token_embedding"][ids].to(torch.bfloat16) + params["pos"][:L].to(torch.bfloat16)
    keep = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))[None, None] & (mask[:, None, None, :] > 0)
    bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min).float()
    for bp in params["blocks"]:
        h = layer_norm(x, bp["norm1"]["w"], bp["norm1"]["b"], eps=arch.norm_eps)
        q = (_lin(bp["q_w"], h, bp["q_b"]) / np.sqrt(hd)).to(h.dtype).reshape(b, L, n, hd)
        k = _lin(bp["k_w"], h, bp["k_b"]).to(h.dtype).reshape(b, L, n, hd)
        v = _lin(bp["v_w"], h, bp["v_b"]).to(h.dtype).reshape(b, L, n, hd)
        logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
        probs = torch.softmax(logits + bias, dim=-1).to(v.dtype)
        attn = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(v.dtype).reshape(b, L, arch.dim)
        x = x + _lin(bp["proj_w"], attn, bp["proj_b"]).to(h.dtype)
        h = layer_norm(x, bp["norm2"]["w"], bp["norm2"]["b"], eps=arch.norm_eps)
        h = _lin(bp["fc1_w"], h, bp["fc1_b"])
        h = h * torch.sigmoid(1.702 * h)  # quick GELU
        x = x + _lin(bp["fc2_w"], h.to(x.dtype), bp["fc2_b"]).to(x.dtype)
    x = layer_norm(x, params["final_norm"]["w"], params["final_norm"]["b"], eps=arch.norm_eps)
    pooled = x[torch.arange(b, device=dev), ids.argmax(dim=-1)].float()
    return x, pooled


def load_clip_text_params(sd: Dict[str, Any], arch: ClipTextArch, device="cpu") -> Params:
    """HF CLIPTextModel state dict (``text_model.`` keys) -> params with a
    per-block list; matmul weights and the token embedding bf16, everything
    else fp32."""

    def g(key, dt=torch.float32):
        return to_tensor(sd[f"text_model.{key}"], dt, device).contiguous()

    def block(i):
        p = f"encoder.layers.{i}"
        out = {}
        for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"), ("v", "self_attn.v_proj"),
                             ("proj", "self_attn.out_proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            out[f"{ours}_w"] = g(f"{p}.{theirs}.weight", torch.bfloat16)
            out[f"{ours}_b"] = g(f"{p}.{theirs}.bias")
        for ours, theirs in (("norm1", "layer_norm1"), ("norm2", "layer_norm2")):
            out[ours] = {"w": g(f"{p}.{theirs}.weight"), "b": g(f"{p}.{theirs}.bias")}
        return out

    return {"token_embedding": g("embeddings.token_embedding.weight", torch.bfloat16),
            "pos": g("embeddings.position_embedding.weight"),
            "blocks": [block(i) for i in range(arch.num_layers)],
            "final_norm": {"w": g("final_layer_norm.weight"), "b": g("final_layer_norm.bias")}}


def init_random_clip_text_params_on_device(arch: ClipTextArch = ClipTextArch(), seed: int = 0,
                                           scale: float = 0.02, device="cuda") -> Params:
    """CLIP text params synthesized directly on ``device`` from a seeded
    ``torch.Generator``, in ``load_clip_text_params``' layout: bf16 matmul
    weights and token embedding of normal * scale, fp32 positions of
    normal * scale, zero biases, unit norms."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, md = arch.dim, arch.mlp_ratio * arch.dim

    def nrm(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).mul_(scale).to(dtype)

    def norm():
        return {"w": torch.ones((d,), dtype=torch.float32, device=dev),
                "b": torch.zeros((d,), dtype=torch.float32, device=dev)}

    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)  # noqa: E731
    blocks = [{"norm1": norm(), "norm2": norm(), "q_w": nrm((d, d)), "q_b": zeros(d), "k_w": nrm((d, d)),
               "k_b": zeros(d), "v_w": nrm((d, d)), "v_b": zeros(d), "proj_w": nrm((d, d)), "proj_b": zeros(d),
               "fc1_w": nrm((md, d)), "fc1_b": zeros(md), "fc2_w": nrm((d, md)), "fc2_b": zeros(d)}
              for _ in range(arch.num_layers)]
    return {"token_embedding": nrm((arch.vocab_size, d)), "pos": nrm((arch.max_positions, d), torch.float32),
            "blocks": blocks, "final_norm": norm()}


class CLIPTextModel:
    """Prompt -> the pooled vector (B, dim) fp32: the tokenizer (injectable,
    ``(texts, return_mask=True) -> (ids, mask)``, padding to
    ``arch.max_positions``), then the tower."""

    def __init__(self, arch: ClipTextArch = ClipTextArch(), params: Optional[Params] = None, tokenizer=None):
        self.arch = arch
        self.params = params
        self.tokenizer = tokenizer

    def infer(self, texts) -> torch.Tensor:
        ids, mask = self.tokenizer(texts, return_mask=True)
        return clip_text_forward(self.params, torch.from_numpy(np.asarray(ids)), torch.from_numpy(np.asarray(mask)),
                                 self.arch)[1]
