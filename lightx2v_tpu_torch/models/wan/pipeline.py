"""Denoise loop (counterpart of ``lightx2v_tpu.models.wan.pipeline``): a
Python loop over the scheduler's steps, each step_pre -> wan_forward ->
step_post, with classifier-free guidance as one batched forward when
``enable_cfg``. Feature caching modes other than ``NoCaching`` are not ported
yet."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ...ops.rope import build_wan_rope_grid
from .config import WanArch
from .model import wan_forward, wan_forward_cfg


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


def make_denoise_fn(arch: WanArch, scheduler, target_shape, enable_cfg: bool = False,
                    guide_scale: float = 5.0, mm_type: str = "Default", self_attn_type: str = "flash_attn3",
                    cross_attn_type: str = "flash_attn3", feature_caching: str = "NoCaching",
                    self_attn_kwargs: Optional[dict] = None, device="cpu"):
    """Build ``denoise(params, state, context, generator, noises=None,
    on_step=None, context_null=None, y=None, clip_fea=None) -> final state``
    running every scheduler step. ``noises`` (one tensor per step) replaces
    the generator's re-noise draws; ``on_step(i)`` is called after each
    step. With ``enable_cfg`` each step is one forward at batch 2 (cond,
    uncond) on ``context`` and ``context_null``, ``y`` and ``clip_fea`` (the
    i2v conditioning) doubled with the batch."""
    if feature_caching != "NoCaching":
        raise NotImplementedError(f"feature caching {feature_caching!r} is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 11)")
    rope_cos, rope_sin, seq_len = rope_for_shape(arch, target_shape, device=device)

    def denoise(params, state, context: torch.Tensor, generator: Optional[torch.Generator] = None,
                noises=None, on_step: Optional[Callable[[int], None]] = None,
                context_null: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                clip_fea: Optional[torch.Tensor] = None):
        if enable_cfg and context_null is None:
            raise ValueError("enable_cfg needs context_null (the negative prompt's encoding)")
        kw = dict(mm_type=mm_type, self_attn_type=self_attn_type, cross_attn_type=cross_attn_type,
                  seq_len=seq_len, self_attn_kwargs=self_attn_kwargs, y=y, clip_fea=clip_fea)
        for i in range(scheduler.num_steps()):
            lat, t = scheduler.step_pre(state)
            if enable_cfg:
                pred = wan_forward_cfg(params, lat[None], t, context, context_null, guide_scale, rope_cos,
                                       rope_sin, arch, **kw)[0]
            else:
                pred = wan_forward(params, lat[None], t, context, rope_cos, rope_sin, arch, **kw)[0]
            state = scheduler.step_post(state, pred, generator,
                                        noise=None if noises is None else noises[i])
            if on_step is not None:
                on_step(i)
        return state

    return denoise
