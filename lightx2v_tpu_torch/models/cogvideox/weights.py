"""CogVideoX1.5 DiT weight loading and synthesis (counterpart of the loaders
in ``lightx2v_tpu.models.cogvideox.model``).

A checkpoint is a flat ``name -> array`` dict with the diffusers keys. The
params are a dict of tensors with ``params["blocks"]`` a list of per-block
dicts: linears {"w": (out, in) bf16, "b": (out,) fp32}, norms {"w", "b"}
fp32. A quantized block linear (every one of a block's, the AdaLN
projections included) carries int8 or float8_e4m3fn codes (out, in) as
``w`` and a per-channel ``w_scale`` (out,), which the loader reads from
``{key}.weight`` and ``{key}.weight_scale``."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..wan.weights import _bf16_round, _linear, to_tensor
from .config import CogArch

Params = Dict[str, Any]


def load_cog_params(sd: Dict[str, Any], arch: CogArch, device="cpu") -> Params:
    def lin(key):  # bf16, or codes with their scales
        return _linear(sd, key, device=device)

    def norm(key):
        return {"w": to_tensor(sd[f"{key}.weight"], torch.float32, device),
                "b": to_tensor(sd[f"{key}.bias"], torch.float32, device)}

    def block(i):
        pfx = f"transformer_blocks.{i}"
        return {
            "norm1_linear": lin(f"{pfx}.norm1.linear"),
            "norm1_norm": norm(f"{pfx}.norm1.norm"),
            "to_q": lin(f"{pfx}.attn1.to_q"),
            "to_k": lin(f"{pfx}.attn1.to_k"),
            "to_v": lin(f"{pfx}.attn1.to_v"),
            "norm_q": norm(f"{pfx}.attn1.norm_q"),
            "norm_k": norm(f"{pfx}.attn1.norm_k"),
            "to_out": lin(f"{pfx}.attn1.to_out.0"),
            "norm2_linear": lin(f"{pfx}.norm2.linear"),
            "norm2_norm": norm(f"{pfx}.norm2.norm"),
            "ff_0": lin(f"{pfx}.ff.net.0.proj"),
            "ff_2": lin(f"{pfx}.ff.net.2"),
        }

    return {
        "patch_proj": lin("patch_embed.proj"),
        "text_proj": lin("patch_embed.text_proj"),
        "time_embedding": {"1": lin("time_embedding.linear_1"), "2": lin("time_embedding.linear_2")},
        "blocks": [block(i) for i in range(arch.num_layers)],
        "norm_final": norm("norm_final"),
        "norm_out_linear": lin("norm_out.linear"),
        "norm_out_norm": norm("norm_out.norm"),
        "proj_out": lin("proj_out"),
    }


def init_random_cog_state_dict(arch: CogArch, seed: int = 0, scale: float = 0.02) -> Dict[str, np.ndarray]:
    """Random checkpoint with the diffusers keys; the same values
    (bf16-rounded, as fp32 arrays) as the JAX package's function of the same
    name for the same seed."""
    rng = np.random.default_rng(seed)
    pool = _bf16_round(rng.standard_normal(65537, dtype=np.float32) * scale)
    _off = [0]

    def randn(*shape):
        _off[0] = (_off[0] + 10007) % len(pool)
        return np.resize(np.roll(pool, -_off[0]), shape)

    sd: Dict[str, np.ndarray] = {}
    d = arch.dim

    def lin(key, i, o):
        sd[f"{key}.weight"] = randn(o, i)
        sd[f"{key}.bias"] = randn(o)

    def norm(key, n_):
        sd[f"{key}.weight"] = np.ones(n_, np.float32)
        sd[f"{key}.bias"] = np.zeros(n_, np.float32)

    lin("patch_embed.proj", arch.in_channels * arch.patch_size_t * arch.patch_size ** 2, d)
    lin("patch_embed.text_proj", arch.text_dim, d)
    lin("time_embedding.linear_1", d, arch.time_embed_dim)
    lin("time_embedding.linear_2", arch.time_embed_dim, arch.time_embed_dim)
    for i in range(arch.num_layers):
        pfx = f"transformer_blocks.{i}"
        lin(f"{pfx}.norm1.linear", arch.time_embed_dim, 6 * d)
        norm(f"{pfx}.norm1.norm", d)
        for m in ("to_q", "to_k", "to_v"):
            lin(f"{pfx}.attn1.{m}", d, d)
        norm(f"{pfx}.attn1.norm_q", arch.head_dim)
        norm(f"{pfx}.attn1.norm_k", arch.head_dim)
        lin(f"{pfx}.attn1.to_out.0", d, d)
        lin(f"{pfx}.norm2.linear", arch.time_embed_dim, 6 * d)
        norm(f"{pfx}.norm2.norm", d)
        lin(f"{pfx}.ff.net.0.proj", d, arch.ffn_dim)
        lin(f"{pfx}.ff.net.2", arch.ffn_dim, d)
    norm("norm_final", d)
    lin("norm_out.linear", arch.time_embed_dim, 2 * d)
    norm("norm_out.norm", d)
    lin("proj_out", d, arch.patch_size_t * arch.out_channels * arch.patch_size ** 2)
    return sd


def init_random_cog_params_on_device(arch: CogArch, scheme: str = "bf16", seed: int = 0, scale: float = 0.02,
                                     device="cuda") -> Params:
    """Params synthesized directly on ``device`` from a seeded
    ``torch.Generator`` (the 5B DiT is ~11 GB in bf16), in the layout of
    ``load_cog_params``: bf16 linears with fp32 biases, ones / zeros norms.
    ``scheme`` "int8" or "fp8" quantizes every block linear as the JAX
    synthesizer does: int8 codes uniform in -127..127 with ``w_scale`` scale
    / 127, or e4m3 codes of normal * 100 (clipped to +-448) with scale /
    100."""
    if scheme not in ("bf16", "int8", "fp8"):
        raise ValueError(f"scheme must be bf16, int8 or fp8, got {scheme!r}")
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, ted, p, pt = arch.dim, arch.time_embed_dim, arch.patch_size, arch.patch_size_t

    def nrm(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).mul_(scale).to(dtype)

    def lin(out, kin):
        return {"w": nrm((out, kin)), "b": nrm((out,), torch.float32)}

    def qlin(out, kin):  # a block linear in the scheme
        if scheme == "bf16":
            return lin(out, kin)
        if scheme == "fp8":
            w = torch.randn((out, kin), generator=g, device=dev, dtype=torch.float32).mul_(100.0)
            w, ws = w.clamp_(-448.0, 448.0).to(torch.float8_e4m3fn), scale / 100.0
        else:
            w, ws = torch.randint(-127, 128, (out, kin), generator=g, device=dev, dtype=torch.int8), scale / 127.0
        return {"w": w, "w_scale": torch.full((out,), ws, dtype=torch.float32, device=dev),
                "b": nrm((out,), torch.float32)}

    def norm(n_):
        return {"w": torch.ones((n_,), dtype=torch.float32, device=dev),
                "b": torch.zeros((n_,), dtype=torch.float32, device=dev)}

    blocks = [
        {"norm1_linear": qlin(6 * d, ted), "norm1_norm": norm(d),
         "to_q": qlin(d, d), "to_k": qlin(d, d), "to_v": qlin(d, d),
         "norm_q": norm(arch.head_dim), "norm_k": norm(arch.head_dim), "to_out": qlin(d, d),
         "norm2_linear": qlin(6 * d, ted), "norm2_norm": norm(d),
         "ff_0": qlin(arch.ffn_dim, d), "ff_2": qlin(d, arch.ffn_dim)}
        for _ in range(arch.num_layers)
    ]
    return {
        "patch_proj": lin(d, arch.in_channels * pt * p * p),
        "text_proj": lin(d, arch.text_dim),
        "time_embedding": {"1": lin(ted, d), "2": lin(ted, ted)},
        "blocks": blocks,
        "norm_final": norm(d),
        "norm_out_linear": lin(2 * d, ted),
        "norm_out_norm": norm(d),
        "proj_out": lin(pt * arch.out_channels * p * p, d),
    }
