"""Wan2.1 weight loading and synthesis (counterpart of
``lightx2v_tpu.models.wan.weights``).

A checkpoint is a flat ``name -> array`` dict with the reference's keys
(numpy arrays of any float dtype, int8, float8_e4m3fn or nibble-packed
uint8 (int4) weights plus ``.weight_scale`` as ``tools/convert.quantize_model``
writes them, or torch tensors). The params
are a dict of tensors with ``params["blocks"]`` a list of per-block dicts
(the forward loops over it). Linear weights keep the (out, in) layout;
norm scales and modulation tables stay fp32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...tools.convert import _pick_bk, quantize_weight
from ...utils.safetensors_io import as_tensor
from .config import WanArch

Params = Dict[str, Any]


def to_tensor(a, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """numpy (incl. the JAX package's bf16 and float8_e4m3fn arrays, carried
    as their bytes) or torch -> tensor on ``device``; integer and
    float8_e4m3fn weights keep their dtype when ``dtype`` is None."""
    t = as_tensor(a)
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device=device)


def _is_packed_int4(w) -> bool:
    return as_tensor(w).dtype == torch.uint8


def _is_quantized(w) -> bool:
    """int8 or e4m3 codes (per-channel scales beside them)."""
    return as_tensor(w).dtype in (torch.int8, torch.float8_e4m3fn)


def _linear(wd: Dict[str, Any], prefix: str, compute_dtype=torch.bfloat16, device="cpu") -> Params:
    """torch Linear -> {"w": (out, in), "b": (out,) fp32 or None} plus
    "w_scale": (out,) fp32 for per-channel int8 or float8_e4m3fn weights,
    the 2-D grid for block-128 (out/128, in/128) and mxfp8 (out, in/32)
    e4m3 weights, (out, groups) fp32 for packed uint8 weights (int4 (out,
    in/2), mxfp6 (out, 3 in/4))."""
    w = wd[f"{prefix}.weight"]
    scale_key = f"{prefix}.weight_scale"
    out: Params = {}
    if _is_packed_int4(w) and scale_key in wd:
        out["w"] = to_tensor(w, None, device).contiguous()
        out["w_scale"] = to_tensor(wd[scale_key], torch.float32, device).contiguous()
    elif _is_quantized(w) or scale_key in wd:
        out["w"] = to_tensor(w, None, device).contiguous()
        ws = to_tensor(wd[scale_key], torch.float32, device)
        # per-channel scales flatten to (out,); block-128 and mx scales keep their 2-D grid
        out["w_scale"] = (ws.reshape(-1) if ws.numel() == out["w"].shape[0] else ws).contiguous()
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
    if "img_emb.proj.1.weight" in wd:  # i2v: CLIP tokens -> the image context
        params["img_emb"] = {
            "norm0": {"w": _f32(wd, "img_emb.proj.0.weight", device), "b": _f32(wd, "img_emb.proj.0.bias", device)},
            "1": lin("img_emb.proj.1"),
            "3": lin("img_emb.proj.3"),
            "norm4": {"w": _f32(wd, "img_emb.proj.4.weight", device), "b": _f32(wd, "img_emb.proj.4.bias", device)},
        }
    if "cfg_cond_proj.weight" in wd:  # dynamic-CFG distilled models: the guidance-scale embedding's projection
        params["cfg_cond_proj"] = lin("cfg_cond_proj", torch.float32)
    return params


def build_block_params(wd: Dict[str, Any], i: int, arch: WanArch, compute_dtype=torch.bfloat16,
                       device="cpu") -> Params:
    """One transformer block's parameters from the flat checkpoint dict."""

    def lin(prefix):
        return _linear(wd, prefix, compute_dtype, device)

    p = f"blocks.{i}"
    block = {
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
    if f"{p}.cross_attn.k_img.weight" in wd:  # i2v: the image cross-attention's keys and values
        ca = block["cross_attn"]
        ca["k_img"], ca["v_img"] = lin(f"{p}.cross_attn.k_img"), lin(f"{p}.cross_attn.v_img")
        ca["norm_k_img"] = _f32(wd, f"{p}.cross_attn.norm_k_img.weight", device)
    # advanced_ptq (smooth-quant) checkpoints: the affine norms the forward applies in place of the
    # modulated LayerNorm before the self-attention (affine_norm1) and the FFN (affine_norm3)
    for key, name in (("affine_norm1", "smooth_norm1"), ("affine_norm3", "smooth_norm2")):
        if f"{p}.{key}.weight" in wd:
            block[name] = {"w": _f32(wd, f"{p}.{key}.weight", device), "b": _f32(wd, f"{p}.{key}.bias", device)}
    return block


def load_wan_params(weight_dict: Dict[str, Any], arch: WanArch, compute_dtype=torch.bfloat16,
                    device="cpu", iter_blocks: bool = False) -> Params:
    """The full parameter dict; ``params["blocks"]`` is a per-block list, or
    with ``iter_blocks`` a generator that builds each block as it is asked
    for (the host-RAM tier packs them one at a time)."""
    params = build_non_block_params(weight_dict, arch, compute_dtype, device)
    blocks = (build_block_params(weight_dict, i, arch, compute_dtype, device) for i in range(arch.num_layers))
    params["blocks"] = blocks if iter_blocks else list(blocks)
    return params


def permute_block_qk_half(blk: Params, arch: WanArch) -> Params:
    """Permute one block's self-attention q/k output features (and QK-norm
    scales) from interleaved rope pairs (2i, 2i+1) to half-split pairs (i, i
    + hd/2) within each head, for the fused-RoPE flash kernel. Attention
    output is unchanged: q and k share the permutation."""
    hd = arch.head_dim
    half = np.arange(hd).reshape(hd // 2, 2).T.reshape(-1)
    perm = torch.from_numpy(np.concatenate([half + h * hd for h in range(arch.num_heads)]))
    perm = perm.to(blk["modulation"].device)
    sa = dict(blk["self_attn"])
    for name in ("q", "k"):
        lin = dict(sa[name])
        w = lin["w"]
        # e4m3 rows move as their bytes (a gather needs no float8 kernel)
        lin["w"] = (w.view(torch.uint8)[perm].view(w.dtype) if w.dtype == torch.float8_e4m3fn
                    else w[perm]).contiguous()
        if lin.get("b") is not None:
            lin["b"] = lin["b"][perm].contiguous()
        ws = lin.get("w_scale")
        if ws is not None and ws.shape[0] == w.shape[0]:  # per-row scales move with their rows
            lin["w_scale"] = ws[perm].contiguous()
        elif ws is not None and 128 % hd:
            raise ValueError(f"block-128 scales under a permutation within {hd}-row heads")
        # a block-128 grid stays: each head's rows permute inside one 128-row block
        sa[name] = lin
    sa["norm_q"] = sa["norm_q"][perm].contiguous()
    sa["norm_k"] = sa["norm_k"][perm].contiguous()
    return dict(blk, self_attn=sa)


def permute_qk_half(params: Params, arch: WanArch) -> Params:
    """``permute_block_qk_half`` on every block of ``params``."""
    return dict(params, blocks=[permute_block_qk_half(blk, arch) for blk in params["blocks"]])


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
    if arch.task == "i2v":
        wd["img_emb.proj.0.weight"] = np.ones(arch.clip_dim, np.float32)
        wd["img_emb.proj.0.bias"] = np.zeros(arch.clip_dim, np.float32)
        lin("img_emb.proj.1", arch.clip_dim, d)
        lin("img_emb.proj.3", d, d)
        wd["img_emb.proj.4.weight"] = np.ones(d, np.float32)
        wd["img_emb.proj.4.bias"] = np.zeros(d, np.float32)
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
        if arch.task == "i2v":
            lin(f"{p}.cross_attn.k_img", d, d)
            lin(f"{p}.cross_attn.v_img", d, d)
            wd[f"{p}.cross_attn.norm_k_img.weight"] = np.ones(d, np.float32)
        lin(f"{p}.ffn.0", d, f_)
        lin(f"{p}.ffn.2", f_, d)
    lin("head.head", d, arch.out_dim * int(np.prod(arch.patch_size)))
    wd["head.modulation"] = (rng.standard_normal((1, 2, d)) * scale).astype(np.float32)
    return wd


def init_random_weight_dict_on_device(arch: WanArch, seed: int = 0, scale: float = 0.02, device="cuda",
                                     dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """A random checkpoint with the reference's keys (``init_random_weight_dict``'s
    layout, i2v keys included for an i2v arch), made on ``device`` from a
    seeded ``torch.Generator``: every linear and the patch embedding
    normal * ``scale`` in ``dtype``, their biases and the modulation tables
    normal * ``scale`` in fp32, unit norms and zero norm biases. At 14B it is
    the bf16 dict that the converter (``tools/convert.py``) takes; the host
    numpy function would build a 56 GB fp32 dict."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, f_, td = arch.dim, arch.ffn_dim, arch.text_dim
    wd: Dict[str, torch.Tensor] = {}

    def randn(shape, dt=torch.float32):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).mul_(scale).to(dt)

    def lin(prefix, kin, out):
        wd[f"{prefix}.weight"] = randn((out, kin), dtype)
        wd[f"{prefix}.bias"] = randn((out,))

    def norm(key, n, bias=True):
        wd[f"{key}.weight"] = torch.ones((n,), dtype=torch.float32, device=dev)
        if bias:
            wd[f"{key}.bias"] = torch.zeros((n,), dtype=torch.float32, device=dev)

    wd["patch_embedding.weight"] = randn((d, arch.in_dim, *arch.patch_size), dtype)
    wd["patch_embedding.bias"] = randn((d,))
    lin("text_embedding.0", td, d)
    lin("text_embedding.2", d, d)
    lin("time_embedding.0", arch.freq_dim, d)
    lin("time_embedding.2", d, d)
    lin("time_projection.1", d, 6 * d)
    if arch.task == "i2v":
        norm("img_emb.proj.0", arch.clip_dim)
        lin("img_emb.proj.1", arch.clip_dim, d)
        lin("img_emb.proj.3", d, d)
        norm("img_emb.proj.4", d)
    for i in range(arch.num_layers):
        p = f"blocks.{i}"
        wd[f"{p}.modulation"] = randn((1, 6, d))
        norm(f"{p}.norm3", d)
        for a in ("self_attn", "cross_attn"):
            for m in ("q", "k", "v", "o"):
                lin(f"{p}.{a}.{m}", d, d)
            norm(f"{p}.{a}.norm_q", d, bias=False)
            norm(f"{p}.{a}.norm_k", d, bias=False)
        if arch.task == "i2v":
            lin(f"{p}.cross_attn.k_img", d, d)
            lin(f"{p}.cross_attn.v_img", d, d)
            norm(f"{p}.cross_attn.norm_k_img", d, bias=False)
        lin(f"{p}.ffn.0", d, f_)
        lin(f"{p}.ffn.2", f_, d)
    lin("head.head", d, arch.out_dim * int(np.prod(arch.patch_size)))
    wd["head.modulation"] = randn((1, 2, d))
    return wd


def init_random_params_on_device(arch: WanArch, scheme: str = "int8", seed: int = 0,
                                 scale: float = 0.02, device="cuda", iter_blocks: bool = False) -> Params:
    """Synthesize the params directly on ``device`` from a seeded
    ``torch.Generator`` (host numpy at 14B would be a 56 GB fp32 array).
    Layout as ``load_wan_params`` (+ ``quantize_model`` for the quantized
    schemes): block linears carry int8 codes plus per-channel
    ``w_scale`` (scale/127, so weights span +-scale), e4m3 codes of
    normal * 100 clipped to +-448 plus ``w_scale`` scale/100 (the JAX
    synthesizer's layout; it does not clip, and its cast turns the tail past
    464 into NaN), or int4 nibbles packed (out, in/2) as uint8 bytes in
    0..255 plus per-(channel, group) ``w_scale`` (scale/7, group from
    ``_pick_bk``); "fp8_block128" and "mxfp8" the fp8 codes with (out/128,
    in/128) scales scale/100 or (out, in/32) power-of-two scales near it,
    "mxfp6" random packed e2m3 bytes (out, 3 in/4) with (out, in/32)
    power-of-two scales near scale/4; pre/post weights stay bf16/fp32. An i2v arch adds the
    image embedding (bf16, like the other pre/post layers) and each block's
    ``k_img`` / ``v_img`` in the block linears' scheme. ``iter_blocks`` as
    in ``load_wan_params`` (the same values: the blocks draw from the
    generator in order either way)."""
    if scheme not in ("int8", "fp8", "int4", "bf16", "fp8_block128", "mxfp8", "mxfp6"):
        raise ValueError(f"unknown synthetic scheme {scheme!r}")
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
        if scheme == "int4":
            groups = kin // _pick_bk(kin)
            return {"w": torch.randint(0, 256, (out, kin // 2), generator=g, device=dev, dtype=torch.uint8),
                    "w_scale": torch.full((out, groups), scale / 7.0, dtype=torch.float32, device=dev),
                    "b": nrm((out,), torch.float32)}
        if scheme == "mxfp6":  # random e2m3 codes (|value| <= 7.5), power-of-two scales per 32 columns
            return {"w": torch.randint(0, 256, (out, 3 * kin // 4), generator=g, device=dev, dtype=torch.uint8),
                    "w_scale": torch.full((out, kin // 32), 2.0 ** round(math.log2(scale / 4.0)),
                                          dtype=torch.float32, device=dev),
                    "b": nrm((out,), torch.float32)}
        if scheme in ("fp8", "fp8_block128", "mxfp8"):
            w = torch.randn((out, kin), generator=g, device=dev, dtype=torch.float32).mul_(100.0)
            grid = {"fp8": (out,), "fp8_block128": (-(-out // 128), -(-kin // 128)), "mxfp8": (out, kin // 32)}
            ws = scale / 100.0 if scheme != "mxfp8" else 2.0 ** round(math.log2(scale / 100.0))
            return {"w": w.clamp_(-448.0, 448.0).to(torch.float8_e4m3fn),
                    "w_scale": torch.full(grid[scheme], ws, dtype=torch.float32, device=dev),
                    "b": nrm((out,), torch.float32)}
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
    ones = lambda n=d: torch.ones((n,), dtype=torch.float32, device=dev)  # noqa: E731
    zeros = lambda n=d: torch.zeros((n,), dtype=torch.float32, device=dev)  # noqa: E731
    i2v = arch.task == "i2v"
    if i2v:  # the image embedding runs Default (bf16), as the other pre/post layers
        params["img_emb"] = {"norm0": {"w": ones(arch.clip_dim), "b": zeros(arch.clip_dim)},
                             "1": lin(d, arch.clip_dim), "3": lin(d, d), "norm4": {"w": ones(), "b": zeros()}}

    def cross_attn():
        ca = {**{m: qlin(d, d) for m in ("q", "k", "v", "o")}, "norm_q": ones(), "norm_k": ones()}
        if i2v:
            ca.update(k_img=qlin(d, d), v_img=qlin(d, d), norm_k_img=ones())
        return ca

    blocks = (
        {
            "modulation": nrm((6, d), torch.float32),
            "norm3": {"w": ones(), "b": zeros()},
            "self_attn": {**{m: qlin(d, d) for m in ("q", "k", "v", "o")}, "norm_q": ones(), "norm_k": ones()},
            "cross_attn": cross_attn(),
            "ffn": {"0": qlin(f_, d), "2": qlin(d, f_)},
        }
        for _ in range(L)
    )
    params["blocks"] = blocks if iter_blocks else list(blocks)
    return params



def structure_block(blk: Params, seed: int = 1, outlier_sigma: float = 0.8, rank: int = 8,
                    spike: float = 3.0) -> Params:
    """Trained-checkpoint-like structure on one synthetic bf16 block, in
    place of flat gaussian block importance (the transform of the JAX
    package's ``structure_params_on_device``, block by block, drawn from a
    ``torch.Generator`` seeded ``seed`` on the block's device):

    * every block linear's output channels get lognormal scales exp(sigma g);
    * the self-attention's q and k share ``rank`` right-singular spike
      directions (q += U_q S V^T amp, k += U_k S V^T amp, S = 2^-r, amp =
      spike * std(q) * sqrt(in)), so the q.k logits carry a dominant
      low-rank part and Sparge's block importance is not flat.

    Returns a new block dict (bf16 weights)."""
    dev = blk["modulation"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    blk = dict(blk)
    for mod_name in ("self_attn", "cross_attn", "ffn"):
        mod = dict(blk[mod_name])
        for k, v in mod.items():
            if isinstance(v, dict) and "w" in v:
                w = v["w"]
                sc = torch.exp(outlier_sigma * torch.randn(w.shape[0], generator=g, device=dev))
                mod[k] = dict(v, w=(w.float() * sc[:, None]).to(w.dtype))
        blk[mod_name] = mod
    sa = dict(blk["self_attn"])
    qw, kw = sa["q"]["w"], sa["k"]["w"]
    d_out, d_in = qw.shape
    amp = spike * float(qw.float().std()) * math.sqrt(d_in)
    v_shared = torch.randn((rank, d_in), generator=g, device=dev) / math.sqrt(d_in)
    s_decay = torch.exp2(-torch.arange(rank, dtype=torch.float32, device=dev))
    for name, w in (("q", qw), ("k", kw)):
        u = torch.randn((d_out, rank), generator=g, device=dev) / math.sqrt(d_out)
        sa[name] = dict(sa[name], w=(w.float() + (u * s_decay) @ v_shared * amp).to(w.dtype))
    blk["self_attn"] = sa
    return blk


def quantize_block(blk: Params, scheme: str) -> Params:
    """A bf16 block's linears quantized where they lie
    (``tools/convert.quantize_weight``, the loader's layout), norms and
    biases as they are."""
    out = dict(blk)
    for mod_name in ("self_attn", "cross_attn", "ffn"):
        mod = dict(blk[mod_name])
        for k, v in mod.items():
            if isinstance(v, dict) and "w" in v:
                q, sc = quantize_weight(v["w"], scheme)
                mod[k] = dict(v, w=q, w_scale=sc)
        out[mod_name] = mod
    return out
