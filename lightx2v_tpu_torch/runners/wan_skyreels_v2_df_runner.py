"""SkyReels-V2 diffusion-forcing runner (counterpart of
``lightx2v_tpu.runners.wan_skyreels_v2_df_runner``).

A long video is segments of ``base_num_frames``. Each segment denoises its
latents row by row of the per-frame timestep matrix (``schedulers/df.py``):
every row is one DiT forward with one timestep per latent frame (the time
embedding computed once per frame and broadcast over its tokens,
``models/wan/model.py``), CFG as one forward at batch 2, and the masked
per-frame UniPC update. After a segment, its last ``overlap_history`` frames
are decoded by the VAE and encoded again as the next segment's prefix, which
is re-noised lightly every row (``addnoise_condition``).

Noise: segment s draws its latents from a generator seeded seed + s and its
prefix re-noise from one seeded seed + s + 17, as the JAX scheduler's
``PRNGKey(seed + s)`` and ``PRNGKey(seed + s + 17)``; ``run_dit(...,
latents=, renoise=)`` replaces them (one entry per segment; ``renoise``
one draw per row). ``timings["step_s"]`` holds every row's seconds and
``timings["segment_rows"]`` the rows of each segment.

The JAX runner passes no ``mm_type`` to ``wan_forward``, so its DiT runs
``Default`` whatever the config says; the port raises ``ValueError`` for
any other. Refused as the JAX runner does not run them: the offload keys,
``feature_caching``, ``changing_resolution`` and ``mesh_shape``."""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.wan.model import wan_forward
from ..models.wan.pipeline import rope_for_shape
from ..schedulers.df import WanSkyreelsV2DFScheduler
from ..utils.logging_utils import logger
from ..utils.registry import RUNNER_REGISTER
from ..vae.wan_vae import vae_encode
from .wan_runner import WanRunner, refuse_unrun_keys


@RUNNER_REGISTER.register("wan2.1_skyreels_v2_df")
class WanSkyreelsV2DFRunner(WanRunner):
    scheduler_cls = WanSkyreelsV2DFScheduler
    encodes_frames = True  # a segment's tail is encoded again as the next segment's prefix

    def load_transformer(self):
        refuse_unrun_keys(self.config, "wan2.1_skyreels_v2_df")
        mm_type = (self.config.get("mm_config") or {}).get("mm_type", "Default")
        if mm_type != "Default":
            raise ValueError(f"mm_type {mm_type!r}: the SkyReels-V2-DF DiT runs Default (bf16) linears only; the "
                             "JAX runner passes no mm_type to wan_forward")
        return super().load_transformer()

    def segments(self):
        """(segment count, latent frames a segment, overlap latent frames)."""
        cfg = self.config
        total_lat_f = self.set_target_shape()[1]
        base_lat_f = (int(cfg.get("base_num_frames", cfg.get("target_video_length", 97))) - 1) // 4 + 1
        overlap = int(cfg.get("overlap_history", 17))
        overlap_lat = (overlap - 1) // 4 + 1 if overlap else 0
        if total_lat_f <= base_lat_f:
            return 1, base_lat_f, overlap_lat
        return 1 + int(np.ceil((total_lat_f - base_lat_f) / max(base_lat_f - overlap_lat, 1))), base_lat_f, \
            overlap_lat

    def run_dit(self, encoder_out: Dict[str, Any], latents: Optional[Sequence[torch.Tensor]] = None,
                renoise: Optional[Sequence[Sequence[torch.Tensor]]] = None):
        cfg, arch, dev = self.config, self.arch, self.device
        c, _, lat_h, lat_w = self.set_target_shape()
        n_iter, base_lat_f, overlap_lat = self.segments()
        attn = cfg.get("attention_impl") or cfg.get("self_attn_1_type", "flash_attn3")
        enable_cfg = bool(cfg.get("enable_cfg", True))
        guide = float(cfg.get("sample_guide_scale", 6.0))
        teo = encoder_out["text_encoder_output"]
        ctx = torch.cat([teo["context"], teo["context_null"]]) if enable_cfg else teo["context"]
        seed = int(cfg.get("seed", 42))
        seg_shape = (c, base_lat_f, lat_h, lat_w)
        rope_cos, rope_sin, _ = rope_for_shape(arch, seg_shape, device=dev)
        lat_dev = "cpu" if str(cfg.get("latent_init", "")) == "torch" else dev
        step_s, rows = [], []
        self.timings.update(step_s=step_s, segment_rows=rows)

        out_latents, prefix = None, None
        for seg in range(n_iter):
            scheduler = self.scheduler = self.init_scheduler()
            scheduler.addnoise_condition = float(cfg.get("addnoise_condition", 20)) if prefix is not None else 0.0
            state = scheduler.prepare_df(
                seg_shape, torch.Generator(device=lat_dev).manual_seed(seed + seg), device=dev,
                num_pre_ready=overlap_lat if prefix is not None else 0, ar_step=int(cfg.get("ar_step", 0)),
                casual_block_size=int(cfg.get("causal_block_size", 1)), prefix_latents=prefix,
                latents=None if latents is None else latents[seg])
            noise_gen = torch.Generator(device=dev).manual_seed(seed + seg + 17)
            seg_noise = None if renoise is None else renoise[seg]
            n_rows = scheduler.num_steps()
            rows.append(n_rows)
            for r in range(n_rows):
                t0 = time.perf_counter()
                state, lat, t_frames = scheduler.df_step_pre(
                    state, scheduler.step_matrix[r], noise_gen, noise=None if seg_noise is None else seg_noise[r])
                if enable_cfg:
                    out = wan_forward(self.model, torch.stack([lat, lat]), torch.stack([t_frames, t_frames]), ctx,
                                      rope_cos, rope_sin, arch, self_attn_type=attn, cross_attn_type=attn)
                    pred = out[1] + guide * (out[0] - out[1])
                else:
                    pred = wan_forward(self.model, lat[None], t_frames[None], ctx, rope_cos, rope_sin, arch,
                                       self_attn_type=attn, cross_attn_type=attn)[0]
                state = scheduler.df_step_post(state, pred, scheduler.update_mask[r])
                del pred
                self.sync()
                step_s.append(time.perf_counter() - t0)
            seg_latents = state["latents"]
            del state
            out_latents = seg_latents if out_latents is None else torch.cat(
                [out_latents, seg_latents[:, overlap_lat:]], dim=1)
            if seg < n_iter - 1:  # the tail, decoded and encoded again, is the next segment's prefix
                frames = torch.from_numpy(self.run_vae_decoder(out_latents[:, -overlap_lat:])).to(dev)
                z = vae_encode(self.vae, frames[None], self.vae_cfg, scale=not cfg.get("synthetic_weights"))
                prefix = z[0].permute(3, 0, 1, 2)
            logger.info(f"DF segment {seg + 1}/{n_iter} done")
        return out_latents
