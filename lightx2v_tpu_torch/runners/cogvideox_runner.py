"""CogVideoX runner (counterpart of ``lightx2v_tpu.runners.cogvideox_runner``):
T5 v1.1-XXL context for the prompt and the negative prompt -> the joint
[text; video] DiT with classifier-free guidance as one forward at batch 2 ->
the XDPM scheduler (v-prediction, zero-terminal SNR, trailing spacing) ->
the tiled, frame-batched CogVideoX VAE decode.

``mesh_shape`` (under ``torchrun``) runs Ulysses over the joint stream on the
mesh's sp axis (``models/cogvideox/sharded.py``), the CFG pair whole on
every rank, as the JAX runner does.

Synthetic weights only (checkpoint loading is Queue 1 item 8). A config
that names no transformer width gets the JAX runner's small synthetic mode:
the small ``CogArch`` (2 layers, 4 heads of 32), the small VAE, and a random
context drawn from the prompt's seeded numpy stream, seeded with Python's
salted ``hash()`` as there (so the two packages agree only within one
process). A config that names the widths (``transformer_num_layers``,
``transformer_num_attention_heads``, ``transformer_attention_head_dim``, as
``configs/cogvideox_t2v.json`` does) gets them made on the device: the
bf16 DiT, a bf16 T5 v1.1-XXL with the synthetic tokenizer (the encoder a
real-weights run runs, where the JAX runner's synthetic mode draws a random
context) and the full VAE."""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from ..encoders.t5 import T5_V1_1_XXL, T5EncoderModel, init_random_t5_params_on_device
from ..models.cogvideox.config import CogArch, build_cog_rope
from ..models.cogvideox.model import CogTransformer
from ..models.cogvideox.sharded import cog_forward_sharded
from ..models.cogvideox.weights import init_random_cog_params_on_device, init_random_cog_state_dict, load_cog_params
from ..schedulers.cogvideox import CogvideoxXDPMScheduler
from ..utils.registry import RUNNER_REGISTER
from ..vae.cogvideox_vae import (CogVAEConfig, cog_vae_decode_tiled, init_random_cog_vae_state_dict,
                                 load_cog_vae_params)
from .base_runner import DefaultRunner
from .wan_runner import _not_ported, _SyntheticTokenizer

SMALL_ARCH = CogArch(num_layers=2, num_heads=4, head_dim=32, text_len=16, text_dim=32, time_embed_dim=64)
SMALL_VAE = CogVAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, latent_channels=16,
                         norm_num_groups=4)
_WIDTH_KEYS = ("transformer_num_layers", "transformer_num_attention_heads", "transformer_attention_head_dim")


@RUNNER_REGISTER.register("cogvideox")
class CogvideoxRunner(DefaultRunner):
    def _full_width(self) -> bool:
        return any(k in self.config for k in _WIDTH_KEYS)

    def load_transformer(self):
        if not self.config.get("synthetic_weights"):
            raise _not_ported("checkpoint loading", "Queue 1 item 8")
        if self.config.get("mesh_shape"):
            self.build_run_mesh()
        if not self._full_width():
            self.arch = SMALL_ARCH
            return load_cog_params(init_random_cog_state_dict(self.arch, seed=0, scale=0.05), self.arch,
                                   device=self.device)
        self.arch = CogArch(num_layers=int(self.config.get("transformer_num_layers", 42)),
                            num_heads=int(self.config.get("transformer_num_attention_heads", 48)),
                            head_dim=int(self.config.get("transformer_attention_head_dim", 64)),
                            text_len=int(self.config.get("text_len", 226)))
        return init_random_cog_params_on_device(self.arch, "bf16", seed=0, device=self.device)

    def load_text_encoder(self):
        if not self._full_width():
            return None
        cfg = T5_V1_1_XXL
        enc = T5EncoderModel(self.arch.text_len, cfg=cfg,
                             params=init_random_t5_params_on_device(cfg, seed=1, device=self.device))
        enc.tokenizer = _SyntheticTokenizer(self.arch.text_len, cfg.vocab_size)
        return enc

    def load_vae(self):
        self.vae_cfg = CogVAEConfig() if self._full_width() else SMALL_VAE
        return load_cog_vae_params(init_random_cog_vae_state_dict(self.vae_cfg, seed=2), self.vae_cfg,
                                   device=self.device)

    def set_target_shape(self):
        cfg = self.config
        frames = int(cfg.get("target_video_length", 81))
        h = int(cfg.get("target_height", cfg.get("height", 768)))
        w = int(cfg.get("target_width", cfg.get("width", 1360)))
        self.config["target_shape"] = (16, (frames - 1) // 4 + 1, h // 8, w // 8)
        return self.config["target_shape"]

    def init_scheduler(self):
        return CogvideoxXDPMScheduler(self.config)

    def run_input_encoder(self) -> Dict[str, Any]:
        prompt = self.config.get("prompt", "")
        if self.text_encoder is None:  # the small synthetic mode: a random context per prompt
            rng = np.random.default_rng(abs(hash(prompt)) % 2 ** 31)
            shape = (1, self.arch.text_len, self.arch.text_dim)
            draw = lambda: torch.from_numpy((rng.standard_normal(shape) * 0.2).astype(np.float32))  # noqa: E731
            ctx = draw().to(self.device)
            neg = draw().to(self.device)
        else:
            ctx = self.text_encoder.infer([prompt])
            neg = self.text_encoder.infer([self.config.get("negative_prompt", "") or ""])
        return {"text_encoder_output": {"context": ctx, "context_null": neg}, "image_encoder_output": None}

    def run_dit(self, encoder_out: Dict[str, Any], noises=None):
        """The denoise loop; ``noises`` (one tensor a step) replaces the
        scheduler's re-noise draws. Records each step's seconds in
        ``timings["step_s"]``."""
        target_shape = self.set_target_shape()
        self.scheduler = scheduler = self.init_scheduler()
        lat_gen, noise_gen = self._generators(3)
        state = scheduler.prepare(target_shape, lat_gen, device=self.device)

        arch = self.arch
        _, lat_f, lat_h, lat_w = target_shape
        p, p_t = arch.patch_size, arch.patch_size_t
        cos, sin = (torch.from_numpy(a).to(self.device)
                    for a in build_cog_rope(arch, (lat_f + p_t - 1) // p_t, lat_h // p, lat_w // p))
        attn = self.config.get("attention_impl") or self.config.get("attention_type", "flash_attn3")
        model = CogTransformer(self.model, arch, attn_type=attn)
        if self.mesh is not None:
            def model(lat_b, t, ctx, cos, sin):
                return cog_forward_sharded(self.model, lat_b, t, ctx, cos, sin, arch, self.mesh, attn_type=attn)
        enable_cfg = bool(self.config.get("enable_cfg", True))
        guide = float(self.config.get("guidance_scale", self.config.get("sample_guide_scale", 6.0)))
        teo = encoder_out["text_encoder_output"]
        steps = []
        t0 = time.perf_counter()
        for i in range(scheduler.num_steps()):
            lat, t = scheduler.step_pre(state)
            lat_b = lat[None]
            if enable_cfg:
                out = model(torch.cat([lat_b, lat_b]), torch.cat([t, t]),
                            torch.cat([teo["context"], teo["context_null"]]), cos, sin)
                pred = out[1] + guide * (out[0] - out[1])
                del out
            else:
                pred = model(lat_b, t, teo["context"], cos, sin)[0]
            state = scheduler.step_post(state, pred, noise_gen, noise=None if noises is None else noises[i])
            self.sync()
            steps.append(time.perf_counter())
        self.timings["step_s"] = list(np.diff([t0] + steps))
        return state["latents"]

    def run_vae_decoder(self, latents) -> np.ndarray:
        z = latents.permute(1, 2, 3, 0)[None]  # (C, F, H, W) -> (1, F, H, W, C)
        # the reference's decode loop: 2 latent frames a chunk, the conv caches carried across;
        # tiles past 256 px (32 latents), each with its own frame loop
        frames = cog_vae_decode_tiled(self.vae, z, self.vae_cfg, scale=not self.config.get("synthetic_weights"))
        return np.clip(frames[0].float().cpu().numpy(), -1.0, 1.0)
