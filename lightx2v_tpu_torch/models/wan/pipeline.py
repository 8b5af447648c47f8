"""Denoise loop (counterpart of ``lightx2v_tpu.models.wan.pipeline``): a
Python loop over the scheduler's steps. Each step is step_pre ->
``wan_pre_process`` -> the block stack, or its feature-caching branch ->
``wan_post_process`` -> classifier-free guidance -> step_post. With
``enable_cfg`` the stack runs once at batch 2 (cond, uncond).

Feature caching (``feature_caching``):

- ``Tea``: skip the stack while the timestep-embedding accumulator stays
  under the threshold and re-apply the cached residual. Under CFG each side
  decides alone (a one-sided step runs its forward at batch 1); without CFG
  one decision. ``Custom``: Tea's shared decision, with TaylorSeer's
  per-module extrapolation on skipped steps.
- ``TaylorSeer`` (per-module, per-block caches) and ``TaylorWS`` (one
  whole-stack pair): calc one step in four, extrapolate the others.
- ``Ada``: the codebook's skip lengths from the middle block's gated
  self-attention output.

Under offload (``streamed``) the caching follows the JAX streamed forward
(``streaming.StreamedCache``): Tea, Custom, TaylorSeer and Ada on the
whole stack's residual staged in host memory, Tea's decision shared by the
CFG batch, TaylorSeer's pattern ``taylor_pattern``; a skipped step does not
iterate the streamed blocks. TaylorWS has no streamed form.

Every decision is made on the host. Tea's and Custom's depend only on the
timestep embeddings, so the run's series is replayed before the first step
(``tea_decision_series``); TaylorSeer's pattern is fixed; Ada reads one
metric per compute step. ``denoise.calc_steps`` records, per step, whether
the stack ran (a (cond, uncond) pair for per-side Tea). Schedules and
moreg windows read ``scheduler.num_steps()``, Tea's cutoff ``infer_steps``;
``num_steps`` only cuts how many steps a call runs, from the state's
``step_index``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from ...caching.adacache import ada_skip_length, init_ada_state
from ...caching.taylorseer import (init_taylor_cache, init_taylor_ws_cache, taylor_cache_bytes, taylor_calc_step,
                                   taylor_schedule, taylor_skip_step, taylor_ws_calc, taylor_ws_skip)
from ...caching.teacache import (TeaCacheConfig, init_tea_state, tea_decision_series, tea_transform,
                                 tea_transform_per_side)
from ...ops.attention import attention
from ...ops.linear import resolve_mm
from ...ops.rope import build_wan_rope_grid
from .config import WanArch
from .model import _split_modulation, time_embeddings, wan_block_parts, wan_post_process, wan_pre_process, \
    wan_transformer
from .streaming import StreamedCache

CACHING_MODES = ("NoCaching", "Tea", "Custom", "TaylorSeer", "TaylorWS", "Ada")
STREAMED_CACHING_MODES = ("NoCaching", "Tea", "Custom", "TaylorSeer", "Ada")
CACHE_DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn, "fp32": torch.float32}


def rope_for_shape(arch: WanArch, target_shape, sp_pad: int = 1, device="cpu"):
    """RoPE cos/sin grids (fp32 tensors on ``device``) for a latent shape
    (C, F, H, W), the token count padded to a multiple of ``sp_pad``."""
    _, f, h, w = target_shape
    pt, ph, pw = arch.patch_size
    cos, sin = build_wan_rope_grid(arch.head_dim, f // pt, h // ph, w // pw)
    s = cos.shape[0]
    pad = (-s) % sp_pad
    if pad:
        cos = np.concatenate([cos, np.ones((pad, cos.shape[1]), cos.dtype)])
        sin = np.concatenate([sin, np.zeros((pad, sin.shape[1]), sin.dtype)])
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    return to(cos), to(sin), s + pad


def tea_mod_series(params, arch: WanArch, scheduler, tea_cfg: TeaCacheConfig, batch: int, n: int,
                   device="cpu", cfg_scale: Optional[torch.Tensor] = None) -> np.ndarray:
    """(n, batch, ...) fp32 host array: what Tea decides on (``embed``, or
    ``embed0`` under ``use_ret_steps``) at steps 0..n-1 of the prepared
    scheduler, computed as each step computes it (batch rows of one
    timestep) and read to the host once."""
    mods = []
    for i in range(n):
        t = torch.full((batch,), float(scheduler.timesteps[i]), dtype=torch.float32, device=device)
        embed, embed0 = time_embeddings(params, t, arch, cfg_scale)
        mods.append(embed0 if tea_cfg.use_ret_steps else embed)
    return torch.stack(mods).cpu().numpy()


def make_denoise_fn(arch: WanArch, scheduler, target_shape, enable_cfg: bool = False,
                    guide_scale: float = 5.0, mm_type: str = "Default", self_attn_type: str = "flash_attn3",
                    cross_attn_type: str = "flash_attn3", feature_caching: str = "NoCaching",
                    caching_config=None, num_steps: Optional[int] = None,
                    self_attn_kwargs: Optional[dict] = None, device="cpu",
                    cfg_scale_embed: Optional[float] = None, streamed: bool = False):
    """Build ``denoise(params, state, context, generator, noises=None,
    on_step=None, context_null=None, y=None, clip_fea=None) -> final state``
    running ``num_steps`` steps (default: the rest of the schedule) from the
    state's ``step_index``. ``noises`` (one tensor per step run) replaces
    the generator's re-noise draws; ``on_step(i)`` is called after each
    step. With ``enable_cfg`` each step's stack runs at batch 2 (cond,
    uncond) on ``context`` and ``context_null``, ``y`` and ``clip_fea`` (the
    i2v conditioning) doubled with the batch. ``caching_config`` holds the
    caching keys (``teacache_thresh``, ``coefficients``, ``use_ret_steps``,
    ``tea_cache_dtype``, ``taylor_cache_dtype``, ``ada_metric_scale``).
    ``cfg_scale_embed`` (``enable_dynamic_cfg``) feeds that guidance scale
    to every forward's time embedding (a checkpoint's ``cfg_cond_proj``).
    ``params["blocks"]`` may be any iterable of blocks with a length: a
    list, or an offload tier's streamer (``models/wan/streaming.py``), and
    then ``streamed`` selects the streamed caching; ``denoise.stream_cache``
    is its ``StreamedCache`` during a run."""
    if feature_caching not in CACHING_MODES:
        raise ValueError(f"feature_caching {feature_caching!r} is not one of {CACHING_MODES}")
    if streamed and feature_caching not in STREAMED_CACHING_MODES:
        raise ValueError(f"feature_caching {feature_caching!r} has no streamed form ({STREAMED_CACHING_MODES})")
    rope_cos, rope_sin, seq_len = rope_for_shape(arch, target_shape, device=device)
    batch = 2 if enable_cfg else 1
    cfg_vec = None
    if cfg_scale_embed is not None:
        cfg_vec = torch.full((batch,), float(cfg_scale_embed), dtype=torch.float32, device=device)
    cc = caching_config if caching_config is not None else {}
    tea_cfg = None
    if feature_caching in ("Tea", "Custom"):
        tea_cfg = TeaCacheConfig.from_config(caching_config) if caching_config is not None else TeaCacheConfig()
    per_side = feature_caching == "Tea" and enable_cfg and not streamed
    taylor_dtype = CACHE_DTYPES[str(cc.get("taylor_cache_dtype", "bf16"))]
    tea_dtype = CACHE_DTYPES[str(cc.get("tea_cache_dtype", "bf16"))]
    n_sched = scheduler.num_steps()
    taylor_is_calc = taylor_step_diff = None
    if feature_caching in ("TaylorSeer", "TaylorWS"):
        taylor_is_calc, taylor_step_diff = taylor_schedule(n_sched, int(cc.get("taylor_pattern", 4)) if streamed
                                                           else 4)
    mm_fn = resolve_mm(mm_type)
    self_fn, cross_fn = partial(attention, self_attn_type), partial(attention, cross_attn_type)
    mid = arch.num_layers // 2
    tokens_per_frame = seq_len // max(target_shape[1] // arch.patch_size[0], 1)

    def transformer(params, x, embed0, ctx, ctx_img):
        return wan_transformer(params["blocks"], x, embed0, ctx, ctx_img, rope_cos, rope_sin, arch, mm_type,
                               self_attn_type, cross_attn_type, self_attn_kwargs)

    def ada_compute(params, x, embed0, ctx, ctx_img):
        """The stack, recording the middle block's gated self-attention
        output in fp32."""
        tiny = None
        for li, block in enumerate(params["blocks"]):
            x, y_self, _, _ = wan_block_parts(block, x, embed0, ctx, ctx_img, rope_cos, rope_sin, arch, mm_fn,
                                              self_fn, cross_fn)
            if li == mid:
                tiny = y_self.float() * _split_modulation(block, embed0)[2]
        return x, tiny

    def init_cache():
        d = arch.dim
        if streamed:
            if feature_caching == "NoCaching":
                return {}
            cache = {"stream": StreamedCache(feature_caching, taylor_dtype, device)}
            if feature_caching == "Ada":
                cache["ada"] = init_ada_state((batch, seq_len, d), dtype=torch.bfloat16,
                                              metric_scale=float(cc.get("ada_metric_scale", 1.0)), device=device)
                del cache["ada"]["prev_residual"]  # the residual lives in host memory
            return cache
        if feature_caching == "Tea":
            mod_shape = (batch, 6, d) if tea_cfg.use_ret_steps else (batch, d)
            return init_tea_state((batch, seq_len, d), mod_shape, dtype=tea_dtype, device=device)
        if feature_caching in ("TaylorSeer", "Custom"):
            need = taylor_cache_bytes(arch, batch, seq_len, taylor_dtype)
            dev = torch.device(device)
            if dev.type == "cuda" and need > torch.cuda.mem_get_info(dev)[0]:
                raise MemoryError(f"the per-module Taylor cache needs {need / 1e9:.1f} GB, more than the "
                                  f"{torch.cuda.mem_get_info(dev)[0] / 1e9:.1f} GB free on {dev}")
            return {"taylor": init_taylor_cache(arch, batch, seq_len, dtype=taylor_dtype, device=device),
                    "last_calc": 0}
        if feature_caching == "TaylorWS":
            return init_taylor_ws_cache(batch, seq_len, d, dtype=taylor_dtype, device=device)
        if feature_caching == "Ada":
            return init_ada_state((batch, seq_len, d), metric_scale=float(cc.get("ada_metric_scale", 1.0)),
                                  device=device)
        return {}

    def denoise(params, state, context: torch.Tensor, generator: Optional[torch.Generator] = None,
                noises=None, on_step: Optional[Callable[[int], None]] = None,
                context_null: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                clip_fea: Optional[torch.Tensor] = None):
        if enable_cfg and context_null is None:
            raise ValueError("enable_cfg needs context_null (the negative prompt's encoding)")
        first = int(state["step_index"])
        n = num_steps if num_steps is not None else n_sched - first
        ctx2, y2, c2 = context, y, clip_fea
        if enable_cfg:
            ctx2 = torch.cat([context, context_null])
            y2 = None if y is None else torch.cat([y, y])
            c2 = None if clip_fea is None else torch.cat([clip_fea, clip_fea])
        tea_plan = None
        if tea_cfg is not None:
            mods = tea_mod_series(params, arch, scheduler, tea_cfg, batch, first + n, device=device,
                                  cfg_scale=cfg_vec)
            tea_plan = tea_decision_series(mods, tea_cfg, per_side=per_side)[first:]
        if first > 0 and n > 0:
            starts = tea_plan[0] if tea_plan is not None else True
            if taylor_is_calc is not None:
                starts = taylor_is_calc[first]
            if not np.all(starts):
                raise ValueError(f"{feature_caching}: a run that starts at step {first} must start at a calc step")
        cache = init_cache()
        denoise.stream_cache = cache.get("stream") if streamed else None
        calc_steps = denoise.calc_steps = []

        def branch(j, i, x, embed0, ctx_e, ctx_img):
            nonlocal cache
            tf = partial(transformer, params, embed0=embed0, ctx=ctx_e, ctx_img=ctx_img)
            if feature_caching == "NoCaching":
                return tf(x), True
            if streamed:
                return streamed_branch(j, i, x, embed0, ctx_e, ctx_img)
            if per_side:
                def single(xx, side):
                    return transformer(params, xx, embed0[side:side + 1], ctx_e[side:side + 1],
                                       None if ctx_img is None else ctx_img[side:side + 1])

                x, cache = tea_transform_per_side(cache, tea_plan[j], x, tf, single)
                return x, tuple(bool(s) for s in tea_plan[j])
            if feature_caching == "Tea":
                x, cache = tea_transform(cache, bool(tea_plan[j]), x, tf)
                return x, bool(tea_plan[j])
            if feature_caching in ("Custom", "TaylorSeer"):
                if feature_caching == "Custom":
                    calc, diff = bool(tea_plan[j]), float(max(i - cache["last_calc"], 1))
                else:
                    calc, diff = bool(taylor_is_calc[i]), float(taylor_step_diff[i])
                if not calc:
                    return taylor_skip_step(params, x, embed0, arch, cache["taylor"], diff), False
                x, _ = taylor_calc_step(params, x, embed0, ctx_e, ctx_img, rope_cos, rope_sin, arch, cache["taylor"],
                                        diff, mm_type, self_fn, cross_fn, primed=i > 0)
                cache["last_calc"] = i
                return x, True
            if feature_caching == "TaylorWS":
                if not taylor_is_calc[i]:
                    return taylor_ws_skip(x, cache, i), False
                x, cache = taylor_ws_calc(tf, x, cache, i)
                return x, True
            # Ada
            if i < cache["skip_until"]:
                return x + cache["prev_residual"].to(x.dtype), False
            x_out, tiny = ada_compute(params, x, embed0, ctx_e, ctx_img)
            cache["prev_residual"] = (x_out - x).to(cache["prev_residual"].dtype)
            _, cache = ada_skip_length(cache, tiny, i, n_sched, tokens_per_frame)
            cache["calc_count"] += 1
            return x_out, True

        def streamed_branch(j, i, x, embed0, ctx_e, ctx_img):
            """A skip step replays the host-staged state without touching
            the blocks; a calc step runs the stack and stages its residual
            (x is not written in place, so it is the stack's input)."""
            sc = cache["stream"]
            if feature_caching in ("Tea", "Custom"):
                calc = bool(tea_plan[j])
            elif feature_caching == "TaylorSeer":
                calc = bool(taylor_is_calc[i])
            else:
                calc = i >= cache["ada"]["skip_until"]
            if not calc and sc.ready:
                return sc.replay(x, i), False
            if feature_caching == "Ada":
                x_out, tiny = ada_compute(params, x, embed0, ctx_e, ctx_img)
                _, cache["ada"] = ada_skip_length(cache["ada"], tiny, i, n_sched, tokens_per_frame)
                del tiny
            else:
                x_out = transformer(params, x, embed0, ctx_e, ctx_img)
            sc.stage(x, x_out, i)
            return x_out, True

        for j in range(n):
            i = first + j
            lat, t = scheduler.step_pre(state)
            lat, tb = lat[None], t
            if enable_cfg:
                lat, tb = torch.cat([lat, lat]), torch.cat([t, t])
            x, embed, embed0, ctx_e, ctx_img, grid, s_tokens = wan_pre_process(params, lat, tb, ctx2, arch, y=y2,
                                                                                clip_fea=c2, seq_len=seq_len,
                                                                                cfg_scale=cfg_vec)
            x, calc = branch(j, i, x, embed0, ctx_e, ctx_img)
            calc_steps.append(calc)
            out = wan_post_process(params, x, embed, grid, s_tokens, arch)
            pred = out[1] + guide_scale * (out[0] - out[1]) if enable_cfg else out[0]
            state = scheduler.step_post(state, pred, generator, noise=None if noises is None else noises[j])
            if on_step is not None:
                on_step(j)
        return state

    denoise.calc_steps = []
    denoise.stream_cache = None
    return denoise
