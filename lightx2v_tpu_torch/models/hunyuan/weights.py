"""HunyuanVideo DiT weight loading and synthesis (counterpart of
``lightx2v_tpu.models.hunyuan.weights``).

A checkpoint is the reference's flat state dict (``img_in.proj``,
``txt_in.*``, ``time_in.mlp.{0,2}``, ``vector_in.{in,out}_layer``,
``guidance_in.mlp.{0,2}``, ``double_blocks.{i}.*``, ``single_blocks.{i}.*``,
``final_layer.*``), read from the reference's ``.pt`` file. The params are
a dict of tensors with ``params["double_blocks"]`` and
``params["single_blocks"]`` lists of per-block dicts: linears {"w": (out, in)
bf16, "b": (out,) fp32}, norms fp32, the head's linear fp32 (it runs
``Default-Force-FP32``). A quantized block linear (every double and single
block linear, the modulation projections included) carries its codes as
``w`` -- int8 or float8_e4m3fn (out, in) with a per-channel ``w_scale``
(out,), or nibble-packed int4 (out, in/2) uint8 with per-(channel, group)
``w_scale`` (out, in/group) -- and the loader reads them from
``{key}.weight`` and ``{key}.weight_scale``."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ...tools.convert import _pick_bk
from ..wan.weights import _bf16_round, _linear, to_tensor
from .config import HunyuanArch

Params = Dict[str, Any]

STREAMS = ("img", "txt")


def load_hunyuan_params(sd: Dict[str, Any], arch: HunyuanArch, device="cpu") -> Params:
    def lin(key, dtype=torch.bfloat16):  # in dtype, or codes with their scales
        return _linear(sd, key, dtype, device)

    def norm(key):
        b = sd.get(f"{key}.bias")
        return {"w": to_tensor(sd[f"{key}.weight"], torch.float32, device),
                "b": None if b is None else to_tensor(b, torch.float32, device)}

    def f32(key):
        return to_tensor(sd[key], torch.float32, device)

    def mlp2(p0, p2):
        return {"0": lin(p0), "2": lin(p2)}

    def refiner(i):
        p = f"txt_in.individual_token_refiner.blocks.{i}"
        return {"norm1": norm(f"{p}.norm1"), "qkv": lin(f"{p}.self_attn_qkv"), "proj": lin(f"{p}.self_attn_proj"),
                "norm2": norm(f"{p}.norm2"), "mlp_fc1": lin(f"{p}.mlp.fc1"), "mlp_fc2": lin(f"{p}.mlp.fc2"),
                "adaLN": lin(f"{p}.adaLN_modulation.1")}

    def dblock(i):
        p = f"double_blocks.{i}"
        out = {}
        for s in STREAMS:
            out.update({f"{s}_mod": lin(f"{p}.{s}_mod.linear"), f"{s}_attn_qkv": lin(f"{p}.{s}_attn_qkv"),
                        f"{s}_attn_q_norm": f32(f"{p}.{s}_attn_q_norm.weight"),
                        f"{s}_attn_k_norm": f32(f"{p}.{s}_attn_k_norm.weight"),
                        f"{s}_attn_proj": lin(f"{p}.{s}_attn_proj"), f"{s}_mlp_fc1": lin(f"{p}.{s}_mlp.fc1"),
                        f"{s}_mlp_fc2": lin(f"{p}.{s}_mlp.fc2")})
        return out

    def sblock(i):
        p = f"single_blocks.{i}"
        return {"linear1": lin(f"{p}.linear1"), "linear2": lin(f"{p}.linear2"),
                "q_norm": f32(f"{p}.q_norm.weight"), "k_norm": f32(f"{p}.k_norm.weight"),
                "modulation": lin(f"{p}.modulation.linear")}

    pe = to_tensor(sd["img_in.proj.weight"], torch.bfloat16, device)  # (D, C, pt, ph, pw)
    params: Params = {
        "img_in": {"w": pe.reshape(pe.shape[0], -1).contiguous(), "b": f32("img_in.proj.bias")},
        "time_in": mlp2("time_in.mlp.0", "time_in.mlp.2"),
        "vector_in": mlp2("vector_in.in_layer", "vector_in.out_layer"),
        "txt_in": {
            "input_embedder": lin("txt_in.input_embedder"),
            "t_embedder": mlp2("txt_in.t_embedder.mlp.0", "txt_in.t_embedder.mlp.2"),
            "c_embedder_1": lin("txt_in.c_embedder.linear_1"),
            "c_embedder_2": lin("txt_in.c_embedder.linear_2"),
            "refiner": [refiner(0), refiner(1)],
        },
        "double_blocks": [dblock(i) for i in range(arch.double_blocks)],
        "single_blocks": [sblock(i) for i in range(arch.single_blocks)],
        "final_layer": {"linear": lin("final_layer.linear", torch.float32),
                        "adaLN": lin("final_layer.adaLN_modulation.1")},
    }
    if "guidance_in.mlp.0.weight" in sd:
        params["guidance_in"] = mlp2("guidance_in.mlp.0", "guidance_in.mlp.2")
    return params


def load_hunyuan_from_path(path: str, arch: HunyuanArch, device="cpu") -> Params:
    """The reference's ``mp_rank_00_model_states.pt`` (a state dict, or one
    under a ``"module"`` key) -> params on ``device``. The file is
    ``mmap``ed: each tensor goes from its pages to the device as
    ``load_hunyuan_params`` reaches it (a dtype cast made on the host first
    takes that one tensor's size), so the host never holds a second copy of
    the 25.4 GB DiT."""
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if "module" in sd:
        sd = sd["module"]
    return load_hunyuan_params(sd, arch, device=device)


def hunyuan_params_to_state_dict(params: Params, arch: HunyuanArch) -> Dict[str, torch.Tensor]:
    """The inverse of ``load_hunyuan_params`` for bf16 params: the
    reference's flat keys, each value a view of the params on their device
    (``img_in.proj.weight`` back in its conv shape (D, C, pt, ph, pw))."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, p):
        sd[f"{key}.weight"] = p["w"]
        if p.get("b") is not None:
            sd[f"{key}.bias"] = p["b"]

    w = params["img_in"]["w"]
    sd["img_in.proj.weight"] = w.reshape(w.shape[0], arch.in_channels, *arch.patch_size)
    sd["img_in.proj.bias"] = params["img_in"]["b"]
    for name, (a, b) in (("time_in", ("time_in.mlp.0", "time_in.mlp.2")),
                         ("vector_in", ("vector_in.in_layer", "vector_in.out_layer")),
                         ("guidance_in", ("guidance_in.mlp.0", "guidance_in.mlp.2"))):
        if name in params:
            put(a, params[name]["0"])
            put(b, params[name]["2"])
    t = params["txt_in"]
    put("txt_in.input_embedder", t["input_embedder"])
    put("txt_in.t_embedder.mlp.0", t["t_embedder"]["0"])
    put("txt_in.t_embedder.mlp.2", t["t_embedder"]["2"])
    put("txt_in.c_embedder.linear_1", t["c_embedder_1"])
    put("txt_in.c_embedder.linear_2", t["c_embedder_2"])
    for i, r in enumerate(t["refiner"]):
        p = f"txt_in.individual_token_refiner.blocks.{i}"
        for ours, theirs in (("norm1", "norm1"), ("qkv", "self_attn_qkv"), ("proj", "self_attn_proj"),
                             ("norm2", "norm2"), ("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2"),
                             ("adaLN", "adaLN_modulation.1")):
            put(f"{p}.{theirs}", r[ours])
    for i, blk in enumerate(params["double_blocks"]):
        p = f"double_blocks.{i}"
        for s in STREAMS:
            put(f"{p}.{s}_mod.linear", blk[f"{s}_mod"])
            put(f"{p}.{s}_attn_qkv", blk[f"{s}_attn_qkv"])
            sd[f"{p}.{s}_attn_q_norm.weight"] = blk[f"{s}_attn_q_norm"]
            sd[f"{p}.{s}_attn_k_norm.weight"] = blk[f"{s}_attn_k_norm"]
            put(f"{p}.{s}_attn_proj", blk[f"{s}_attn_proj"])
            put(f"{p}.{s}_mlp.fc1", blk[f"{s}_mlp_fc1"])
            put(f"{p}.{s}_mlp.fc2", blk[f"{s}_mlp_fc2"])
    for i, blk in enumerate(params["single_blocks"]):
        p = f"single_blocks.{i}"
        put(f"{p}.linear1", blk["linear1"])
        put(f"{p}.linear2", blk["linear2"])
        sd[f"{p}.q_norm.weight"] = blk["q_norm"]
        sd[f"{p}.k_norm.weight"] = blk["k_norm"]
        put(f"{p}.modulation.linear", blk["modulation"])
    put("final_layer.linear", params["final_layer"]["linear"])
    put("final_layer.adaLN_modulation.1", params["final_layer"]["adaLN"])
    return sd


def init_random_hunyuan_state_dict(arch: HunyuanArch, seed: int = 0, scale: float = 0.02) -> Dict[str, np.ndarray]:
    """Random checkpoint with the reference's keys; the same values
    (bf16-rounded, as fp32 arrays) as the JAX package's function of the same
    name for the same seed."""
    rng = np.random.default_rng(seed)
    pool = _bf16_round(rng.standard_normal(65537, dtype=np.float32) * scale)
    _off = [0]

    def randn(*shape):
        _off[0] = (_off[0] + 10007) % len(pool)
        return np.resize(np.roll(pool, -_off[0]), shape)

    sd: Dict[str, np.ndarray] = {}

    def lin(key, i, o):
        sd[f"{key}.weight"] = randn(o, i)
        sd[f"{key}.bias"] = randn(o)

    def norm(key, d_):
        sd[f"{key}.weight"] = np.ones(d_, np.float32)
        sd[f"{key}.bias"] = np.zeros(d_, np.float32)

    d, hd, mlp = arch.hidden_size, arch.head_dim, arch.mlp_hidden_dim
    sd["img_in.proj.weight"] = randn(d, arch.in_channels, *arch.patch_size)
    sd["img_in.proj.bias"] = randn(d)
    lin("time_in.mlp.0", 256, d)
    lin("time_in.mlp.2", d, d)
    lin("vector_in.in_layer", arch.text_states_dim_2, d)
    lin("vector_in.out_layer", d, d)
    if arch.guidance_embed:
        lin("guidance_in.mlp.0", 256, d)
        lin("guidance_in.mlp.2", d, d)
    lin("txt_in.input_embedder", arch.text_states_dim, d)
    lin("txt_in.t_embedder.mlp.0", 256, d)
    lin("txt_in.t_embedder.mlp.2", d, d)
    lin("txt_in.c_embedder.linear_1", arch.text_states_dim, d)
    lin("txt_in.c_embedder.linear_2", d, d)
    for i in range(2):
        p = f"txt_in.individual_token_refiner.blocks.{i}"
        norm(f"{p}.norm1", d)
        lin(f"{p}.self_attn_qkv", d, 3 * d)
        lin(f"{p}.self_attn_proj", d, d)
        norm(f"{p}.norm2", d)
        lin(f"{p}.mlp.fc1", d, 4 * d)
        lin(f"{p}.mlp.fc2", 4 * d, d)
        lin(f"{p}.adaLN_modulation.1", d, 2 * d)
    for i in range(arch.double_blocks):
        p = f"double_blocks.{i}"
        for s in STREAMS:
            lin(f"{p}.{s}_mod.linear", d, 6 * d)
            lin(f"{p}.{s}_attn_qkv", d, 3 * d)
            sd[f"{p}.{s}_attn_q_norm.weight"] = np.ones(hd, np.float32)
            sd[f"{p}.{s}_attn_k_norm.weight"] = np.ones(hd, np.float32)
            lin(f"{p}.{s}_attn_proj", d, d)
            lin(f"{p}.{s}_mlp.fc1", d, mlp)
            lin(f"{p}.{s}_mlp.fc2", mlp, d)
    for i in range(arch.single_blocks):
        p = f"single_blocks.{i}"
        lin(f"{p}.linear1", d, 3 * d + mlp)
        lin(f"{p}.linear2", d + mlp, d)
        sd[f"{p}.q_norm.weight"] = np.ones(hd, np.float32)
        sd[f"{p}.k_norm.weight"] = np.ones(hd, np.float32)
        lin(f"{p}.modulation.linear", d, 3 * d)
    lin("final_layer.linear", d, arch.out_channels * int(np.prod(arch.patch_size)))
    lin("final_layer.adaLN_modulation.1", d, 2 * d)
    return sd


SCHEMES = ("bf16", "int8", "fp8", "int4")


def init_random_hunyuan_params_on_device(arch: HunyuanArch, seed: int = 0, scale: float = 0.02,
                                         device="cuda", scheme: str = "bf16") -> Params:
    """Params synthesized directly on ``device`` from a seeded
    ``torch.Generator`` (the 12.7B DiT is 25.4 GB in bf16), in the layout of
    ``load_hunyuan_params``: bf16 linears of normal * scale with fp32 biases
    of normal * scale, the head's linear fp32, unit and zero norms.
    ``scheme`` quantizes every double and single block linear as the JAX
    synthesizer does: "int8" codes uniform in -127..127 with ``w_scale``
    scale / 127; "fp8" e4m3 codes of normal * 100 (clipped to +-448) with
    scale / 100; "int4" nibble-packed bytes uniform in 0..255 with
    per-(channel, group) scale / 7, the group from ``_pick_bk`` (512 at
    every Hunyuan width). The embeddings, the refiner and the head stay
    bf16 (the head's linear fp32)."""
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, hd, mlp = arch.hidden_size, arch.head_dim, arch.mlp_hidden_dim

    def nrm(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).mul_(scale).to(dtype)

    def lin(out, kin, dtype=torch.bfloat16):
        return {"w": nrm((out, kin), dtype), "b": nrm((out,), torch.float32)}

    def qlin(out, kin):  # a block linear in the scheme
        if scheme == "bf16":
            return lin(out, kin)
        if scheme == "int4":
            w = torch.randint(0, 256, (out, kin // 2), generator=g, device=dev, dtype=torch.uint8)
            ws = torch.full((out, kin // _pick_bk(kin)), scale / 7.0, dtype=torch.float32, device=dev)
        elif scheme == "fp8":
            w = torch.randn((out, kin), generator=g, device=dev, dtype=torch.float32).mul_(100.0)
            w = w.clamp_(-448.0, 448.0).to(torch.float8_e4m3fn)
            ws = torch.full((out,), scale / 100.0, dtype=torch.float32, device=dev)
        else:
            w = torch.randint(-127, 128, (out, kin), generator=g, device=dev, dtype=torch.int8)
            ws = torch.full((out,), scale / 127.0, dtype=torch.float32, device=dev)
        return {"w": w, "w_scale": ws, "b": nrm((out,), torch.float32)}

    def mlp2(kin):
        return {"0": lin(d, kin), "2": lin(d, d)}

    def norm():
        return {"w": torch.ones((d,), dtype=torch.float32, device=dev),
                "b": torch.zeros((d,), dtype=torch.float32, device=dev)}

    ones_hd = lambda: torch.ones((hd,), dtype=torch.float32, device=dev)  # noqa: E731

    def dblock():
        out = {}
        for s in STREAMS:
            out.update({f"{s}_mod": qlin(6 * d, d), f"{s}_attn_qkv": qlin(3 * d, d), f"{s}_attn_q_norm": ones_hd(),
                        f"{s}_attn_k_norm": ones_hd(), f"{s}_attn_proj": qlin(d, d), f"{s}_mlp_fc1": qlin(mlp, d),
                        f"{s}_mlp_fc2": qlin(d, mlp)})
        return out

    refiner = lambda: {"norm1": norm(), "qkv": lin(3 * d, d), "proj": lin(d, d), "norm2": norm(),  # noqa: E731
                       "mlp_fc1": lin(4 * d, d), "mlp_fc2": lin(d, 4 * d), "adaLN": lin(2 * d, d)}
    params: Params = {
        "img_in": lin(d, arch.in_channels * int(np.prod(arch.patch_size))),
        "time_in": mlp2(256),
        "vector_in": mlp2(arch.text_states_dim_2),
        "txt_in": {"input_embedder": lin(d, arch.text_states_dim), "t_embedder": mlp2(256),
                   "c_embedder_1": lin(d, arch.text_states_dim), "c_embedder_2": lin(d, d),
                   "refiner": [refiner(), refiner()]},
        "double_blocks": [dblock() for _ in range(arch.double_blocks)],
        "single_blocks": [{"linear1": qlin(3 * d + mlp, d), "linear2": qlin(d, d + mlp), "q_norm": ones_hd(),
                           "k_norm": ones_hd(), "modulation": qlin(3 * d, d)} for _ in range(arch.single_blocks)],
        "final_layer": {"linear": lin(arch.out_channels * int(np.prod(arch.patch_size)), d, torch.float32),
                        "adaLN": lin(2 * d, d)},
    }
    if arch.guidance_embed:
        params["guidance_in"] = mlp2(256)
    return params
