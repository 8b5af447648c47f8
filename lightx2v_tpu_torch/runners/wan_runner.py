"""Wan2.1 runners (counterpart of ``lightx2v_tpu.runners.wan_runner``), t2v
with resident weights.

``wan2.1_distill`` is the 4-step step-distill model without CFG. ``wan2.1``
(UniPC with CFG) is registered but its scheduler is not ported yet.

Synthetic weights (``synthetic_weights``): a config that names no ``dim``
gets the JAX runner's small synthetic stack built from the same host numpy
dicts (small DiT, small T5, small VAE), so the two packages run identical
weights. A config at a published Wan width gets a full-size stack made on
the device from seeded ``torch.Generator``s: the DiT (int8 codes plus
per-channel scales under an int8 mm_type), a bf16 UMT5-XXL when text_dim is
4096, and the full Wan VAE.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from ..encoders.t5 import (UMT5_XXL, T5Config, T5EncoderModel, init_random_t5_params_on_device,
                           init_random_t5_state_dict, load_t5_params)
from ..models.wan.config import arch_from_config, is_published_width
from ..models.wan.pipeline import make_denoise_fn
from ..models.wan.weights import (init_random_params_on_device, init_random_weight_dict, load_wan_params,
                                  permute_qk_half)
from ..schedulers.step_distill import WanStepDistillScheduler
from ..tools.convert import quantize_model
from ..utils.registry import RUNNER_REGISTER
from ..vae.wan_vae import WanVAEConfig, init_random_vae_state_dict, load_wan_vae_params, vae_decode, vae_decode_tiled
from .base_runner import DefaultRunner

SMALL_T5 = T5Config(vocab_size=4096, dim=256, dim_attn=256, dim_ffn=512, num_heads=8, num_layers=2)
SMALL_VAE = WanVAEConfig(dim=16, z_dim=16, dim_mult=(1, 2, 2, 2), num_res_blocks=1)


class _SyntheticTokenizer:
    """Deterministic hash tokenizer for synthetic-weights runs (no HF
    tokenizer files)."""

    def __init__(self, seq_len: int, vocab_size: int):
        self.seq_len = seq_len
        self.vocab_size = vocab_size

    def __call__(self, texts, return_mask=False, **kw):
        if isinstance(texts, str):
            texts = [texts]
        ids = np.zeros((len(texts), self.seq_len), np.int32)
        mask = np.zeros((len(texts), self.seq_len), np.int32)
        for i, t in enumerate(texts):
            toks = [(hash(w) % (self.vocab_size - 2)) + 2 for w in t.split()][: self.seq_len - 1]
            toks = toks + [1]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return (ids, mask) if return_mask else ids


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


@RUNNER_REGISTER.register("wan2.1")
class WanRunner(DefaultRunner):

    def _require_synthetic(self):
        if not self.config.get("synthetic_weights"):
            raise _not_ported("checkpoint loading", "Queue 1 item 8")

    # ---------------- component loading ----------------
    def load_transformer(self):
        self._require_synthetic()
        if self.config.get("task", "t2v") != "t2v":
            raise _not_ported("i2v", "Queue 1 item 9")
        if self.config.get("cpu_offload") or self.config.get("lazy_load") or self.config.get("mesh_shape"):
            raise _not_ported("offload, streaming and multi-device runs", "Queue 1 items 13-14")
        if "dim" not in self.config:
            for k, v in dict(dim=384, ffn_dim=768, num_heads=6, num_layers=4, freq_dim=256, text_dim=256).items():
                self.config.setdefault(k, v)
        self.arch = arch_from_config(self.config)
        mm_cfg = self.config.get("mm_config") or {}
        self.mm_type = mm_cfg.get("mm_type", "Default")
        int8 = self.mm_type.startswith("W-int8-")
        if is_published_width(self.arch):
            params = init_random_params_on_device(self.arch, "int8" if int8 else "bf16", seed=0,
                                                  device=self.device)
        else:
            wd = init_random_weight_dict(self.arch, seed=0, scale=0.02)
            if int8:
                wd = quantize_model(wd, "int8")
            params = load_wan_params(wd, self.arch, device=self.device)
        if self.arch.rope_fused:
            params = permute_qk_half(params, self.arch)
        return params

    def load_text_encoder(self):
        self._require_synthetic()
        text_len = int(self.config.get("text_len", 512))
        if self.arch.text_dim == UMT5_XXL.dim:
            cfg = UMT5_XXL
            params = init_random_t5_params_on_device(cfg, seed=1, device=self.device)
        elif self.arch.text_dim == SMALL_T5.dim:
            cfg = SMALL_T5
            params = load_t5_params(init_random_t5_state_dict(cfg, seed=1), cfg, device=self.device)
        else:
            raise ValueError(f"synthetic text encoders exist for text_dim 256 and 4096, got {self.arch.text_dim}")
        enc = T5EncoderModel(text_len, cfg=cfg, params=params)
        enc.tokenizer = _SyntheticTokenizer(text_len, cfg.vocab_size)
        return enc

    def load_vae(self):
        self._require_synthetic()
        if self.config.get("tiny_vae"):
            raise _not_ported("the tiny VAE", "Queue 1 item 17")
        self.vae_cfg = WanVAEConfig() if is_published_width(self.arch) else SMALL_VAE
        return load_wan_vae_params(init_random_vae_state_dict(self.vae_cfg, seed=2), self.vae_cfg,
                                   device=self.device)

    # ---------------- pipeline stages ----------------
    def set_target_shape(self):
        """(C, F, H, W) latent shape; ``shape_bucketing`` rounds F up to 4
        and H/W up to 8 latents and crops the decoded video back."""
        cfg = self.config
        st, sh, sw = cfg.get("vae_stride", (4, 8, 8))
        frames = int(cfg.get("target_video_length", 81))
        h, w = int(cfg.get("target_height", 480)), int(cfg.get("target_width", 832))
        lat_f, lat_h, lat_w = (frames - 1) // st + 1, h // sh, w // sw
        self.config.pop("crop_output", None)
        if cfg.get("shape_bucketing"):
            up = lambda v, q: -(-v // q) * q  # noqa: E731
            bf, bh, bw = up(lat_f, 4), up(lat_h, 8), up(lat_w, 8)
            if (bf, bh, bw) != (lat_f, lat_h, lat_w):
                self.config["crop_output"] = (frames, h, w)
                lat_f, lat_h, lat_w = bf, bh, bw
        self.config["target_shape"] = (16, lat_f, lat_h, lat_w)
        return self.config["target_shape"]

    def init_scheduler(self):
        raise _not_ported("the UniPC scheduler", "Queue 1 item 10")

    def run_input_encoder(self) -> Dict[str, Any]:
        if self.config.get("use_prompt_enhancer"):
            raise _not_ported("the prompt enhancer", "Queue 1 item 18")
        context = self.text_encoder.infer([self.config.get("prompt", "")])
        context_null = context
        if self.config.get("enable_cfg", True):
            context_null = self.text_encoder.infer([self.config.get("negative_prompt", "") or ""])
        return {"text_encoder_output": {"context": context, "context_null": context_null},
                "image_encoder_output": None}

    def _generators(self):
        """(latent generator, re-noise generator). ``latent_init: "torch"``
        draws the latents from a CPU generator (the JAX package's torch
        stream); otherwise both live on the run device."""
        seed = int(self.config.get("seed", 42))
        lat_dev = "cpu" if str(self.config.get("latent_init", "")) == "torch" else self.device
        return (torch.Generator(device=lat_dev).manual_seed(seed),
                torch.Generator(device=self.device).manual_seed(seed + 1))

    def run_dit(self, encoder_out: Dict[str, Any], noises=None):
        target_shape = self.set_target_shape()
        scheduler = self.init_scheduler()
        self.scheduler = scheduler
        lat_gen, noise_gen = self._generators()
        state = scheduler.prepare(target_shape, lat_gen, device=self.device)
        attn = self.config.get("attention_impl") or self.config.get("self_attn_1_type", "flash_attn3")
        if self.config.get("sparge"):
            raise _not_ported("Sparge attention", "Queue 1 item 2")
        cross_attn = self.config.get("cross_attn_1_type", attn)
        denoise = make_denoise_fn(self.arch, scheduler, target_shape,
                                  enable_cfg=bool(self.config.get("enable_cfg", True)), mm_type=self.mm_type,
                                  self_attn_type=attn, cross_attn_type=cross_attn,
                                  feature_caching=self.config.get("feature_caching", "NoCaching"),
                                  device=self.device)
        steps = []

        def on_step(i):
            self.sync()
            steps.append(time.perf_counter())

        t0 = time.perf_counter()
        state = denoise(self.model, state, encoder_out["text_encoder_output"]["context"], noise_gen,
                        noises=noises, on_step=on_step)
        self.timings["step_s"] = list(np.diff([t0] + steps))
        return state["latents"]

    def _crop_to_request(self, frames: np.ndarray) -> np.ndarray:
        crop = self.config.get("crop_output")
        if not crop:
            return frames
        f, h, w = crop
        oh, ow = frames.shape[1], frames.shape[2]
        y0, x0 = max(0, (oh - h) // 2), max(0, (ow - w) // 2)
        return frames[:f, y0:y0 + h, x0:x0 + w]

    def run_vae_decoder(self, latents) -> np.ndarray:
        z = latents.permute(1, 2, 3, 0)[None]  # (C, F, H, W) -> (1, F, H, W, C)
        scale = not self.config.get("synthetic_weights")
        chunk = int(self.config.get("vae_decode_chunk", 4))
        decode = vae_decode_tiled if self.config.get("use_tiling_vae") else vae_decode
        frames = decode(self.vae, z, self.vae_cfg, scale=scale, chunk=chunk)
        return self._crop_to_request(frames[0].clamp(-1.0, 1.0).cpu().numpy())


@RUNNER_REGISTER.register("wan2.1_distill")
class WanDistillRunner(WanRunner):
    """4-step step-distilled model, CFG-free."""

    scheduler_cls = WanStepDistillScheduler

    def init_scheduler(self):
        if "denoising_step_list" not in self.config:
            self.config["denoising_step_list"] = [1000, 750, 500, 250]
        self.config["infer_steps"] = len(self.config["denoising_step_list"])
        return self.scheduler_cls(self.config)
