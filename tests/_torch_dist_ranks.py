"""Rank-side code of the port's multi-process CPU tests
(``tests/test_torch_parallel*.py``): numpy, torch and the port only, never
JAX, so that the spawned ranks stay light. ``spawn`` starts a gloo world
with ``torch.multiprocessing.spawn`` and a ``file://`` rendezvous under the
test's ``tmp_path`` (no port to clash on between xdist workers); each rank
pins torch to one thread, runs one of the functions below and writes what it
returns to ``rank<r>.npz`` there. The inputs come from numpy seeds, made
here so that the parent's JAX side reads the same arrays."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp

# the arches of tests/test_parallel.py
WAN = dict(dim=64, ffn_dim=96, num_heads=4, num_layers=2, in_dim=4, out_dim=4, freq_dim=32, text_len=8, text_dim=16)
HY = dict(hidden_size=64, heads_num=4, double_blocks=2, single_blocks=2, mlp_hidden_dim=128, in_channels=4,
          out_channels=4, text_states_dim=16, text_states_dim_2=8, rope_dim_list=(4, 6, 6))
COG = dict(num_layers=2, num_heads=4, head_dim=16, text_len=6, text_dim=24, time_embed_dim=64)
VAE = dict(dim=16, z_dim=16, dim_mult=(1, 2, 2, 2), num_res_blocks=1)
INT8 = "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"


def spawn(fn, world: int, tmp, *args, init: bool = True, timeout: float = 120.0):
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks; -> each rank's arrays.
    A world still running after ``timeout`` seconds (a collective that some
    rank never joined) is killed and raises ``TimeoutError``."""
    tmp = str(tmp)
    ctx = mp.spawn(_entry, args=(world, tmp, fn.__name__, args, init), nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__}: the {world}-rank world ran past {timeout} s")
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(world)]


def _entry(rank, world, tmp, name, args, init):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from lightx2v_tpu_torch.parallel.mesh import destroy_distributed, init_distributed

    if init:
        init_distributed("cpu", init_method=f"file://{tmp}/store")
    try:
        out = globals()[name](rank, *args)
    finally:
        destroy_distributed()
    arrays = {k: (v.float() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in (out or {}).items()}
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **{k: np.asarray(v) for k, v in arrays.items()})


# ----------------------------------------------------------------- inputs
def wan_inputs(f=2, h=4, w=8, seed=1):
    """(latents (2, 4, f, h, w), t (2,), context (2, 8, 16)), fp32."""
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((2, 4, f, h, w)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 16)).astype(np.float32)
    return lat, np.array([500.0, 500.0], np.float32), ctx


def qkv(b=2, s=32, n=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, s, n, d)) * 0.5).astype(np.float32) for _ in range(3)]


def block_inputs(s=16, seed=0):
    """x (1, s, 64), embed0 (1, 6, 64), context (1, 8, 64), fp32 (x and the
    context are rounded to bf16 by the callers)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, s, 64)).astype(np.float32),
            (rng.standard_normal((1, 6, 64)) * 0.1).astype(np.float32),
            (rng.standard_normal((1, 8, 64)) * 0.1).astype(np.float32))


def hunyuan_inputs():
    rng = np.random.default_rng(0)
    lat = (rng.standard_normal((1, 4, 2, 4, 8)) * 0.5).astype(np.float32)
    ts = (rng.standard_normal((1, 12, 16)) * 0.2).astype(np.float32)
    mask = np.zeros((1, 12), np.int32)
    mask[0, :7] = 1
    ts2 = (rng.standard_normal((1, 8)) * 0.2).astype(np.float32)
    return lat, np.array([500.0], np.float32), ts, mask, ts2


def cog_inputs():
    rng = np.random.default_rng(1)
    lat = (rng.standard_normal((2, 16, 2, 4, 8)) * 0.5).astype(np.float32)
    ctx = (rng.standard_normal((2, 6, 24)) * 0.2).astype(np.float32)
    return lat, np.array([500.0, 500.0], np.float32), ctx


def vae_latents():
    return (np.random.default_rng(0).standard_normal((1, 3, 8, 8, 16)) * 0.4).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def wan_params(quant: bool = False):
    from lightx2v_tpu_torch.models.wan import config as tcfg
    from lightx2v_tpu_torch.models.wan import weights as tweights
    from lightx2v_tpu_torch.tools.convert import quantize_model

    arch = tcfg.WanArch(**WAN)
    wd = tweights.init_random_weight_dict(arch, seed=0, scale=0.05)
    return arch, tweights.load_wan_params(quantize_model(wd, "int8") if quant else wd, arch)


# ----------------------------------------------------------------- worlds
def world_dp2_sp2(rank):
    """The Ulysses swaps, ulysses_attention and the sharded Wan forward on
    {"dp": 2, "sp": 2}."""
    from lightx2v_tpu_torch.models.wan.sharded import wan_forward_sharded
    from lightx2v_tpu_torch.ops.attention import attn_plain
    from lightx2v_tpu_torch.ops.rope import build_wan_rope_grid
    from lightx2v_tpu_torch.parallel.mesh import all_gather_cat, build_mesh, shard
    from lightx2v_tpu_torch.parallel.ulysses import head2seq, seq2head, ulysses_attention

    mesh = build_mesh({"dp": 2, "sp": 2})
    out = {"coords": [mesh.index(a) for a in ("dp", "sp", "tp")], "sp_ranks": mesh.group_ranks["sp"],
           "sub_member": build_mesh({"sp": 2}, ranks=[2, 3]).member}
    x = torch.arange(2 * 16 * 8 * 4, dtype=torch.float32).reshape(2, 16, 8, 4)
    xl = shard(shard(x, mesh, "dp", 0), mesh, "sp", 1)
    heads = seq2head(xl, mesh)
    out["roundtrip_equal"] = torch.equal(head2seq(heads, mesh), xl)
    out["heads_equal"] = torch.equal(heads, shard(shard(x, mesh, "dp", 0), mesh, "sp", 2))

    def gathered(t):
        return all_gather_cat(all_gather_cat(t, mesh, "sp", 1), mesh, "dp", 0)

    q, k, v = (shard(shard(_t(a), mesh, "dp", 0), mesh, "sp", 1) for a in qkv())
    out["ulysses"] = gathered(ulysses_attention(attn_plain, q, k, v, mesh))

    arch, params = wan_params()
    lat, t, ctx = wan_inputs()
    cos, sin = (_t(a) for a in build_wan_rope_grid(arch.head_dim, 2, 2, 4))
    out["forward"] = wan_forward_sharded(params, _t(lat), _t(t), _t(ctx), cos, sin, arch, mesh,
                                         self_attn_type="xla", cross_attn_type="xla")
    return out


def world_sp4(rank):
    """Ring (and Ulysses) with a pad tail on {"sp": 4}: 18 tokens padded
    to 20; the ring primitive on q/k/v whose last 2 keys are pad rows."""
    from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape
    from lightx2v_tpu_torch.models.wan.sharded import wan_forward_sharded
    from lightx2v_tpu_torch.parallel.mesh import all_gather_cat, build_mesh, shard
    from lightx2v_tpu_torch.parallel.ring import ring_attention

    mesh = build_mesh({"sp": 4})
    q, k, v = (_t(a).to(torch.bfloat16) for a in qkv(s=20, seed=2))
    v[:, 18:] = 1e4  # the pad rows: any value that leaks shows
    o = ring_attention(*(shard(a, mesh, "sp", 1) for a in (q, k, v)), mesh, pad_tail=2)
    out = {"ring": all_gather_cat(o, mesh, "sp", 1)}
    arch, params = wan_params()
    lat, t, ctx = wan_inputs(f=2, h=6, w=6, seed=3)
    cos, sin, seq_len = rope_for_shape(arch, (4, 2, 6, 6), sp_pad=4)
    for algo in ("ring", "ulysses"):
        out[f"forward_{algo}"] = wan_forward_sharded(params, _t(lat), _t(t), _t(ctx), cos, sin, arch, mesh,
                                                     self_attn_type="xla", cross_attn_type="xla", seq_len=seq_len,
                                                     parallel_attn_type=algo)
    out["seq_len"] = seq_len
    return out


def world_sp2_tp2(rank):
    """wan_block_tp in bf16 and under the int8 mm_type, with x replicated
    and dense local attention (the JAX test's layout), and the sharded
    forward on {"sp": 2, "tp": 2}."""
    from functools import partial

    from lightx2v_tpu_torch.models.wan.sharded import wan_forward_sharded
    from lightx2v_tpu_torch.ops.attention import attention
    from lightx2v_tpu_torch.ops.linear import resolve_mm
    from lightx2v_tpu_torch.ops.rope import build_wan_rope_grid
    from lightx2v_tpu_torch.parallel.mesh import build_mesh
    from lightx2v_tpu_torch.parallel.tensor_parallel import tp_shard_block, wan_block_tp

    mesh = build_mesh({"sp": 2, "tp": 2})
    x, e0, ctx = block_inputs()
    x, ctx = _t(x).to(torch.bfloat16), _t(ctx).to(torch.bfloat16)
    out = {}
    dense = partial(attention, "xla")
    cos, sin = (_t(a) for a in build_wan_rope_grid(16, 2, 2, 4))
    for name, quant, mm_type in (("block_bf16", False, "Default"), ("block_int8", True, INT8)):
        arch, params = wan_params(quant)
        blk = tp_shard_block(params["blocks"][0], 2, mesh.index("tp"))
        y = wan_block_tp(blk, x, _t(e0), ctx, None, cos, sin, arch, resolve_mm(mm_type), dense, dense, mesh)
        out[name] = y.float()
    arch, params = wan_params()
    lat, t, c = wan_inputs()
    out["forward"] = wan_forward_sharded(params, _t(lat), _t(t), _t(c), cos, sin, arch, mesh, self_attn_type="xla",
                                         cross_attn_type="xla")
    return out


def world_joint_streams(rank):
    """The CogVideoX and HunyuanVideo Ulysses forwards and the 1-D parallel
    VAE on {"sp": 2}."""
    from lightx2v_tpu_torch.models.cogvideox import config as cc
    from lightx2v_tpu_torch.models.cogvideox import weights as cw
    from lightx2v_tpu_torch.models.cogvideox.sharded import cog_forward_sharded
    from lightx2v_tpu_torch.models.hunyuan import config as hc
    from lightx2v_tpu_torch.models.hunyuan import model as hm
    from lightx2v_tpu_torch.models.hunyuan import weights as hw
    from lightx2v_tpu_torch.models.hunyuan.sharded import hunyuan_forward_sharded
    from lightx2v_tpu_torch.parallel.mesh import build_mesh
    from lightx2v_tpu_torch.parallel.vae_parallel import parallel_vae_decode
    from lightx2v_tpu_torch.vae import wan_vae as wv

    mesh = build_mesh({"sp": 2})
    out = {}
    arch = cc.CogArch(**COG)
    params = cw.load_cog_params(cw.init_random_cog_state_dict(arch, seed=0, scale=0.05), arch)
    lat, t, ctx = cog_inputs()
    cos, sin = (_t(a) for a in cc.build_cog_rope(arch, 1, 2, 4))
    out["cog"] = cog_forward_sharded(params, _t(lat).to(torch.bfloat16), _t(t), _t(ctx), cos, sin, arch, mesh,
                                     attn_type="xla")
    arch = hc.HunyuanArch(**HY)
    params = hw.load_hunyuan_params(hw.init_random_hunyuan_state_dict(arch, seed=0, scale=0.05), arch)
    lat, t, ts, mask, ts2 = hunyuan_inputs()
    cos, sin = (_t(a) for a in hm.build_hunyuan_rope(arch, 2, 2, 4))
    out["hunyuan"] = hunyuan_forward_sharded(params, _t(lat), _t(t), _t(ts), _t(mask), _t(ts2), cos, sin,
                                             hm.text_kv_len(16, mask), arch, mesh, guidance=torch.tensor([6000.0]),
                                             attn_type="xla")
    cfg = wv.WanVAEConfig(**VAE)
    vae = wv.load_wan_vae_params(wv.init_random_vae_state_dict(cfg, seed=2), cfg)
    out["vae_1d"] = parallel_vae_decode(vae, _t(vae_latents()), cfg, mesh)
    return out


def world_four_ranks(rank):
    """The 2-D parallel VAE on {"sp": 2, "tp": 2}, and cached denoises
    (UniPC, CFG at 5 over dp) on {"dp": 2, "sp": 2}, in one world."""
    from lightx2v_tpu_torch.parallel.mesh import build_mesh
    from lightx2v_tpu_torch.parallel.vae_parallel import parallel_vae_decode
    from lightx2v_tpu_torch.vae import wan_vae as wv

    cfg = wv.WanVAEConfig(**VAE)
    vae = wv.load_wan_vae_params(wv.init_random_vae_state_dict(cfg, seed=2), cfg)
    out = {"vae_2d": parallel_vae_decode(vae, _t(vae_latents()), cfg, build_mesh({"sp": 2, "tp": 2}))}
    mesh = build_mesh({"dp": 2, "sp": 2})
    for mode in ("TaylorSeer", "Ada", "Tea"):
        out[mode] = cached_denoise(mode, mesh)
    return out


def cached_denoise(mode: str, mesh=None):
    """5 UniPC steps of a caching mode with CFG at 5 (the JAX TaylorSeer
    test's run) -> the final latents, over ``mesh`` or on one process."""
    from lightx2v_tpu_torch.models.wan.pipeline import make_denoise_fn
    from lightx2v_tpu_torch.parallel.mesh import mesh_axis_size
    from lightx2v_tpu_torch.schedulers.unipc import WanUniPCScheduler
    from lightx2v_tpu_torch.utils.config import ConfigDict

    arch, params = wan_params()
    target = (4, 2, 4, 8)
    ctx = _t(np.random.default_rng(0).standard_normal((1, 8, 16)).astype(np.float32))
    # Tea: poly(rel) = rel at a threshold that skips steps 1 and 3 of the five
    cfg = ConfigDict({"infer_steps": 5, "sample_shift": 5.0, "teacache_thresh": 1.5,
                      "coefficients": [[1.0, 0.0], [1.0, 0.0]]})
    sched = WanUniPCScheduler(cfg)
    state = sched.prepare(target, torch.Generator().manual_seed(0))
    d = make_denoise_fn(arch, sched, target, enable_cfg=True, guide_scale=5.0, self_attn_type="xla",
                        cross_attn_type="xla", feature_caching=mode, caching_config=cfg, mesh=mesh,
                        sp_size=mesh_axis_size(mesh, "sp"))
    return d(params, state, ctx, context_null=ctx * 0.5)["latents"]


def infer_rank(rank, argv, tmp):
    """``lightx2v_tpu_torch.infer.main`` as torchrun would run it; the video
    writer is replaced by one that saves the frames beside the path as
    ``.npy`` and counts its calls (``saves``)."""
    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.runners.base_runner import DefaultRunner

    saves = []

    def save_video(self, frames, path):
        saves.append(path)
        np.save(path + ".npy", frames)

    DefaultRunner.save_video = save_video
    infer.main(list(argv), init_method=f"file://{tmp}/infer_store")
    return {"saves": len(saves)}


def write_config(path, src, **overrides) -> str:
    with open(src) as f:
        cfg = json.load(f)
    cfg.update(overrides)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)
