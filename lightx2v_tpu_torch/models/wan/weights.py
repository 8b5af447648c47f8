"""Wan2.1 weight loading and synthesis (counterpart of
``lightx2v_tpu.models.wan.weights``).

A checkpoint is a flat ``name -> array`` dict with the reference's keys
(numpy arrays of any float dtype, int8 weights plus ``.weight_scale`` as
``tools/convert.quantize_model`` writes them, or torch tensors). The params
are a dict of tensors with ``params["blocks"]`` a list of per-block dicts
(the forward loops over it). Linear weights keep the (out, in) layout;
norm scales and modulation tables stay fp32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import WanArch

Params = Dict[str, Any]


def to_tensor(a, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """numpy (incl. bf16-typed arrays) or torch -> tensor on ``device``.
    Integer arrays keep their dtype when ``dtype`` is None."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        arr = np.asarray(a)
        if arr.dtype.kind not in "iubf":  # e.g. bfloat16-typed numpy arrays
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device=device)


def _is_quantized(w) -> bool:
    return (w.dtype == torch.int8) if isinstance(w, torch.Tensor) else (np.asarray(w).dtype == np.int8)


def _linear(wd: Dict[str, Any], prefix: str, compute_dtype=torch.bfloat16, device="cpu") -> Params:
    """torch Linear -> {"w": (out, in), "b": (out,) fp32 or None} plus
    "w_scale" (out,) fp32 for int8 weights."""
    w = wd[f"{prefix}.weight"]
    scale_key = f"{prefix}.weight_scale"
    out: Params = {}
    if _is_quantized(w) or scale_key in wd:
        out["w"] = to_tensor(w, None, device).contiguous()
        out["w_scale"] = to_tensor(wd[scale_key], torch.float32, device).reshape(-1).contiguous()
    else:
        out["w"] = to_tensor(w, compute_dtype, device).contiguous()
    bkey = f"{prefix}.bias"
    out["b"] = to_tensor(wd[bkey], torch.float32, device) if bkey in wd else None
    return out


def _f32(wd, key, device) -> Optional[torch.Tensor]:
    return to_tensor(wd[key], torch.float32, device) if key in wd else None


def build_non_block_params(wd: Dict[str, Any], arch: WanArch, compute_dtype=torch.bfloat16,
                           device="cpu") -> Params:
    """Pre/post (non-``blocks.*``) parameters."""

    def lin(prefix, dt=compute_dtype):
        return _linear(wd, prefix, dt, device)

    pe_w = to_tensor(wd["patch_embedding.weight"], compute_dtype, device)  # (dim, in, pt, ph, pw)
    params: Params = {
        "patch_embedding": {"w": pe_w.reshape(pe_w.shape[0], -1).contiguous(),
                            "b": _f32(wd, "patch_embedding.bias", device)},
        "text_embedding": {"0": lin("text_embedding.0"), "2": lin("text_embedding.2")},
        "time_embedding": {"0": lin("time_embedding.0", torch.float32),
                           "2": lin("time_embedding.2", torch.float32)},
        "time_projection": {"1": lin("time_projection.1", torch.float32)},
        "head": {**lin("head.head"),
                 "modulation": to_tensor(wd["head.modulation"], torch.float32, device).reshape(2, arch.dim)},
    }
    return params


def build_block_params(wd: Dict[str, Any], i: int, arch: WanArch, compute_dtype=torch.bfloat16,
                       device="cpu") -> Params:
    """One transformer block's parameters from the flat checkpoint dict."""

    def lin(prefix):
        return _linear(wd, prefix, compute_dtype, device)

    p = f"blocks.{i}"
    return {
        "modulation": to_tensor(wd[f"{p}.modulation"], torch.float32, device).reshape(6, arch.dim),
        "norm3": {"w": _f32(wd, f"{p}.norm3.weight", device), "b": _f32(wd, f"{p}.norm3.bias", device)},
        "self_attn": {
            **{m: lin(f"{p}.self_attn.{m}") for m in ("q", "k", "v", "o")},
            "norm_q": _f32(wd, f"{p}.self_attn.norm_q.weight", device),
            "norm_k": _f32(wd, f"{p}.self_attn.norm_k.weight", device),
        },
        "cross_attn": {
            **{m: lin(f"{p}.cross_attn.{m}") for m in ("q", "k", "v", "o")},
            "norm_q": _f32(wd, f"{p}.cross_attn.norm_q.weight", device),
            "norm_k": _f32(wd, f"{p}.cross_attn.norm_k.weight", device),
        },
        "ffn": {"0": lin(f"{p}.ffn.0"), "2": lin(f"{p}.ffn.2")},
    }


def load_wan_params(weight_dict: Dict[str, Any], arch: WanArch, compute_dtype=torch.bfloat16,
                    device="cpu") -> Params:
    """The full parameter dict; ``params["blocks"]`` is a per-block list."""
    params = build_non_block_params(weight_dict, arch, compute_dtype, device)
    params["blocks"] = [build_block_params(weight_dict, i, arch, compute_dtype, device)
                        for i in range(arch.num_layers)]
    return params


def permute_qk_half(params: Params, arch: WanArch) -> Params:
    """Permute self-attention q/k output features (and QK-norm scales) from
    interleaved rope pairs (2i, 2i+1) to half-split pairs (i, i + hd/2)
    within each head, for the fused-RoPE flash kernel. Attention output is
    unchanged: q and k share the permutation."""
    hd = arch.head_dim
    half = np.arange(hd).reshape(hd // 2, 2).T.reshape(-1)
    perm_np = np.concatenate([half + h * hd for h in range(arch.num_heads)])
    out = dict(params)
    blocks = []
    for blk in params["blocks"]:
        perm = torch.from_numpy(perm_np).to(blk["modulation"].device)
        sa = dict(blk["self_attn"])
        for name in ("q", "k"):
            lin = dict(sa[name])
            lin["w"] = lin["w"][perm].contiguous()
            if lin.get("b") is not None:
                lin["b"] = lin["b"][perm].contiguous()
            if "w_scale" in lin:
                lin["w_scale"] = lin["w_scale"][perm].contiguous()
            sa[name] = lin
        sa["norm_q"] = sa["norm_q"][perm].contiguous()
        sa["norm_k"] = sa["norm_k"][perm].contiguous()
        blocks.append(dict(blk, self_attn=sa))
    out["blocks"] = blocks
    return out


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """Round fp32 values to bfloat16 (nearest-even), kept as fp32 arrays."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def init_random_weight_dict(arch: WanArch, seed: int = 0, scale: float = 0.02) -> Dict[str, np.ndarray]:
    """Random checkpoint with the reference's key layout; the same values
    (bf16-rounded, as fp32 arrays) as the JAX package's function of the same
    name for the same seed."""
    rng = np.random.default_rng(seed)
    d, f_, td = arch.dim, arch.ffn_dim, arch.text_dim
    wd: Dict[str, np.ndarray] = {}
    pool = _bf16_round(rng.standard_normal(65537, dtype=np.float32) * scale)
    _off = [0]

    def randn(*shape):
        _off[0] = (_off[0] + 10007) % len(pool)
        return np.resize(np.roll(pool, -_off[0]), shape)

    def lin(prefix, i, o):
        wd[f"{prefix}.weight"] = randn(o, i)
        wd[f"{prefix}.bias"] = randn(o)

    wd["patch_embedding.weight"] = randn(d, arch.in_dim, *arch.patch_size)
    wd["patch_embedding.bias"] = randn(d)
    lin("text_embedding.0", td, d)
    lin("text_embedding.2", d, d)
    lin("time_embedding.0", arch.freq_dim, d)
    lin("time_embedding.2", d, d)
    lin("time_projection.1", d, 6 * d)
    for i in range(arch.num_layers):
        p = f"blocks.{i}"
        wd[f"{p}.modulation"] = (rng.standard_normal((1, 6, d)) * scale).astype(np.float32)
        wd[f"{p}.norm3.weight"] = np.ones(d, np.float32)
        wd[f"{p}.norm3.bias"] = np.zeros(d, np.float32)
        for m in ("q", "k", "v", "o"):
            lin(f"{p}.self_attn.{m}", d, d)
            lin(f"{p}.cross_attn.{m}", d, d)
        wd[f"{p}.self_attn.norm_q.weight"] = np.ones(d, np.float32)
        wd[f"{p}.self_attn.norm_k.weight"] = np.ones(d, np.float32)
        wd[f"{p}.cross_attn.norm_q.weight"] = np.ones(d, np.float32)
        wd[f"{p}.cross_attn.norm_k.weight"] = np.ones(d, np.float32)
        lin(f"{p}.ffn.0", d, f_)
        lin(f"{p}.ffn.2", f_, d)
    lin("head.head", d, arch.out_dim * int(np.prod(arch.patch_size)))
    wd["head.modulation"] = (rng.standard_normal((1, 2, d)) * scale).astype(np.float32)
    return wd


def init_random_params_on_device(arch: WanArch, scheme: str = "int8", seed: int = 0,
                                 scale: float = 0.02, device="cuda") -> Params:
    """Synthesize the params directly on ``device`` from a seeded
    ``torch.Generator`` (host numpy at 14B would be a 56 GB fp32 array).
    Layout as ``load_wan_params`` (+ ``quantize_model`` for "int8"): block
    linears carry int8 codes plus per-channel ``w_scale`` (scale/127, so
    weights span +-scale); pre/post weights stay bf16/fp32."""
    if scheme not in ("int8", "bf16"):
        raise NotImplementedError(f"synthetic scheme {scheme!r} is not ported yet")
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, f_, td, L = arch.dim, arch.ffn_dim, arch.text_dim, arch.num_layers

    def nrm(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).mul_(scale).to(dtype)

    def lin(out, kin, dtype=torch.bfloat16):
        return {"w": nrm((out, kin), dtype), "b": nrm((out,), torch.float32)}

    def qlin(out, kin):
        if scheme == "bf16":
            return lin(out, kin)
        return {"w": torch.randint(-127, 128, (out, kin), generator=g, device=dev, dtype=torch.int8),
                "w_scale": torch.full((out,), scale / 127.0, dtype=torch.float32, device=dev),
                "b": nrm((out,), torch.float32)}

    pin = arch.in_dim * int(np.prod(arch.patch_size))
    params: Params = {
        "patch_embedding": {"w": nrm((d, pin)), "b": nrm((d,), torch.float32)},
        "text_embedding": {"0": lin(d, td), "2": lin(d, d)},
        "time_embedding": {"0": lin(d, arch.freq_dim, torch.float32), "2": lin(d, d, torch.float32)},
        "time_projection": {"1": lin(6 * d, d, torch.float32)},
        "head": {**lin(arch.out_dim * int(np.prod(arch.patch_size)), d), "modulation": nrm((2, d), torch.float32)},
    }
    ones = lambda: torch.ones((d,), dtype=torch.float32, device=dev)  # noqa: E731
    params["blocks"] = [
        {
            "modulation": nrm((6, d), torch.float32),
            "norm3": {"w": ones(), "b": torch.zeros((d,), dtype=torch.float32, device=dev)},
            "self_attn": {**{m: qlin(d, d) for m in ("q", "k", "v", "o")}, "norm_q": ones(), "norm_k": ones()},
            "cross_attn": {**{m: qlin(d, d) for m in ("q", "k", "v", "o")}, "norm_q": ones(), "norm_k": ones()},
            "ffn": {"0": qlin(f_, d), "2": qlin(d, f_)},
        }
        for _ in range(L)
    ]
    return params
