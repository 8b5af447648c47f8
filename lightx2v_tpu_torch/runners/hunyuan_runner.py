"""HunyuanVideo text-to-video runner (counterpart of
``lightx2v_tpu.runners.hunyuan_runner``, t2v): the Llama hidden states and
the CLIP-L pooled vector of the prompt -> the MMDiT with embedded guidance
(guidance scale x 1000, no CFG) -> flow-match Euler (shift 7) -> the causal
3D VAE decode, tiled past 16 latent frames or with ``use_tiling_vae``.

Synthetic weights only. A config that names no transformer width gets the
JAX runner's small synthetic mode: the small ``HunyuanArch`` (96 wide, 4
heads, 2 + 2 blocks), the small VAE, and random text states and pooled
vector drawn from a numpy stream seeded with Python's salted ``hash()`` of
the prompt, as there (so the two packages agree only within one process). A
config that names ``hidden_size`` (3072, the only width it takes) gets
``HunyuanArch()`` made on the device, the llava-llama-3-8b-class encoder and the CLIP-L text tower made on the device
behind synthetic tokenizers (the encoders a real-weights run runs, where the
JAX runner's synthetic mode draws random states), and the full VAE.

Refused: i2v, feature caching, the HF text encoders (``text_encoder_path``,
``text_encoder_crop_start``) and ``mesh_shape`` (``NotImplementedError``
naming their Queue 1 item), real weights (the JAX runner's text encoders
run through ``transformers``, which the card machine lacks), and a quantized
``mm_config`` (``ValueError``: the JAX runner runs every Hunyuan linear as
``Default`` whatever ``mm_config`` says)."""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from ..encoders.clip import ClipTextArch, CLIPTextModel, init_random_clip_text_params_on_device
from ..encoders.llama import LLAVA_LLAMA3_8B, PROMPT_TEMPLATE, LlamaArch, LlamaEncoderModel, \
    init_random_llama_params_on_device
from ..models.hunyuan.config import HunyuanArch
from ..models.hunyuan.model import HunyuanTransformer, build_hunyuan_rope, text_kv_len
from ..models.hunyuan.weights import (init_random_hunyuan_params_on_device, init_random_hunyuan_state_dict,
                                      load_hunyuan_params)
from ..schedulers.euler import FlowMatchEulerScheduler
from ..utils.registry import RUNNER_REGISTER
from ..vae.hunyuan_vae import (HunyuanVAEConfig, hunyuan_vae_decode, hunyuan_vae_decode_tiled,
                               init_random_hunyuan_vae_state_dict, load_hunyuan_vae_params)
from .base_runner import DefaultRunner
from .wan_runner import _not_ported, _SyntheticTokenizer

SMALL_ARCH = HunyuanArch(hidden_size=96, heads_num=4, double_blocks=2, single_blocks=2, mlp_hidden_dim=192,
                         text_states_dim=32, text_states_dim_2=16, rope_dim_list=(4, 10, 10))
SMALL_VAE = HunyuanVAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, latent_channels=16,
                             norm_num_groups=4)


class _SyntheticLlamaTokenizer(_SyntheticTokenizer):
    """The synthetic tokenizer of the Llama encoder: the video template's
    text before the prompt becomes exactly ``crop_start`` ids (the Llama-3
    tokenizer makes it the 95 tokens the encoder crops), then the prompt's
    words and an end id, padded to ``max_length``."""

    def __init__(self, arch: LlamaArch):
        super().__init__(arch.max_length - arch.crop_start, arch.vocab_size)
        self.prefix = PROMPT_TEMPLATE.split("{}")[0]
        words = [(hash(w) % (arch.vocab_size - 2)) + 2 for w in self.prefix.split()]
        self.head = np.resize(np.asarray(words, np.int32), arch.crop_start)

    def __call__(self, texts, return_mask=False, **kw):
        if isinstance(texts, str):
            texts = [texts]
        if not all(t.startswith(self.prefix) for t in texts):
            raise ValueError("the synthetic Llama tokenizer takes prompts in the video template")
        ids, mask = super().__call__([t[len(self.prefix):] for t in texts], return_mask=True)
        n = len(texts)
        ids = np.concatenate([np.broadcast_to(self.head, (n, len(self.head))), ids], axis=1)
        mask = np.concatenate([np.ones((n, len(self.head)), np.int32), mask], axis=1)
        return (ids, mask) if return_mask else ids


class _SyntheticClipTokenizer(_SyntheticTokenizer):
    """The synthetic tokenizer of the CLIP-L text tower: word ids below the
    vocabulary's highest id, which ends the prompt (CLIP's end-of-text, whose
    row is the pooled vector) and appears nowhere else."""

    def __init__(self, arch: ClipTextArch):
        super().__init__(arch.max_positions, arch.vocab_size - 1)
        self.eot = arch.vocab_size - 1

    def __call__(self, texts, return_mask=False, **kw):
        ids, mask = super().__call__(texts, return_mask=True)
        ids[np.arange(len(ids)), mask.sum(axis=1) - 1] = self.eot
        return (ids, mask) if return_mask else ids


@RUNNER_REGISTER.register("hunyuan")
class HunyuanRunner(DefaultRunner):
    def __init__(self, config):
        if config.get("task", "t2v") == "i2v":
            raise _not_ported("HunyuanVideo i2v (the llava encoder, token replace, RIFLEx, the VAE encoder)",
                              "Queue 1 item 16")
        if config.get("feature_caching", "NoCaching") not in (None, "NoCaching"):
            raise _not_ported("feature caching on HunyuanVideo", "Queue 1 item 16")
        if config.get("mesh_shape"):
            raise _not_ported("Ulysses over the joint stream (models/hunyuan/sharded.py)", "Queue 1 item 14")
        for key in ("text_encoder_path", "text_encoder_crop_start"):
            if config.get(key) is not None:
                raise _not_ported(f"HunyuanVideo's HF text encoders ({key})", "Queue 1 item 16")
        if not config.get("synthetic_weights"):
            raise _not_ported("HunyuanVideo from real weights (the llava-llama-3-8b and CLIP-L text encoders "
                              "through transformers)", "Queue 1 item 16")
        mm_type = (config.get("mm_config") or {}).get("mm_type", "Default")
        if mm_type != "Default":
            raise ValueError(f"mm_type {mm_type!r}: the HunyuanVideo DiT runs Default (bf16) linears only; the JAX "
                             "runner passes no mm_type to hunyuan_forward")
        width = HunyuanArch().hidden_size
        if "hidden_size" in config and int(config["hidden_size"]) != width:
            raise ValueError(f"hidden_size {config['hidden_size']}: the synthetic HunyuanVideo DiT is made at "
                             f"HunyuanArch()'s width {width} only")
        super().__init__(config)

    def _full_width(self) -> bool:
        return "hidden_size" in self.config

    def load_transformer(self):
        if not self._full_width():
            self.arch = SMALL_ARCH
            return load_hunyuan_params(init_random_hunyuan_state_dict(self.arch, seed=0, scale=0.05), self.arch,
                                       device=self.device)
        self.arch = HunyuanArch()
        return init_random_hunyuan_params_on_device(self.arch, seed=0, device=self.device)

    def load_text_encoder(self):
        if not self._full_width():
            return None
        llama, clip = LLAVA_LLAMA3_8B, ClipTextArch()
        return {"llama": LlamaEncoderModel(llama, init_random_llama_params_on_device(llama, seed=1, device=self.device),
                                           _SyntheticLlamaTokenizer(llama)),
                "clip": CLIPTextModel(clip, init_random_clip_text_params_on_device(clip, seed=3, device=self.device),
                                      _SyntheticClipTokenizer(clip))}

    def load_vae(self):
        self.vae_cfg = HunyuanVAEConfig() if self._full_width() else SMALL_VAE
        return load_hunyuan_vae_params(init_random_hunyuan_vae_state_dict(self.vae_cfg, seed=2), self.vae_cfg,
                                       device=self.device)

    def set_target_shape(self):
        cfg = self.config
        frames = int(cfg.get("target_video_length", 85))
        h, w = int(cfg.get("target_height", 720)), int(cfg.get("target_width", 1280))
        self.config["target_shape"] = (16, (frames - 1) // 4 + 1, h // 8, w // 8)
        return self.config["target_shape"]

    def init_scheduler(self):
        self.config.setdefault("sample_shift", 7.0)
        return FlowMatchEulerScheduler(self.config)

    def run_input_encoder(self) -> Dict[str, Any]:
        """The Llama states and mask and the CLIP pooled vector; records
        ``llama_s`` and ``clip_s`` at a published width."""
        prompt = self.config.get("prompt", "")
        if self.text_encoder is None:  # the small synthetic mode: random states per prompt
            rng = np.random.default_rng(abs(hash(prompt)) % 2 ** 31)
            lt = int(self.config.get("text_len", 32))
            states = torch.from_numpy((rng.standard_normal((1, lt, self.arch.text_states_dim)) * 0.2)
                                      .astype(np.float32)).to(self.device)
            mask = np.zeros((1, lt), np.int32)
            mask[0, :max(2, min(lt, len(prompt.split()) + 2))] = 1
            pooled = torch.from_numpy((rng.standard_normal((1, self.arch.text_states_dim_2)) * 0.2)
                                      .astype(np.float32)).to(self.device)
        else:
            t0 = time.perf_counter()
            states, mask = self.text_encoder["llama"].infer([prompt])
            self._mark("llama_s", t0)
            t0 = time.perf_counter()
            pooled = self.text_encoder["clip"].infer([prompt])
            self._mark("clip_s", t0)
        return {"text_encoder_output": {"text_encoder_1_text_states": states,
                                        "text_encoder_1_attention_mask": np.asarray(mask),
                                        "text_encoder_2_text_states": pooled},
                "image_encoder_output": None}

    def run_dit(self, encoder_out: Dict[str, Any]):
        """The Euler loop. ``kv_len`` (image tokens + the prompt's valid text
        tokens) is counted once on the host from the mask and recorded in
        ``timings["kv_len"]``; each step's seconds in ``timings["step_s"]``."""
        target_shape = self.set_target_shape()
        self.scheduler = scheduler = self.init_scheduler()
        state = scheduler.prepare(target_shape, self._generators(0)[0], device=self.device)
        arch = self.arch
        grid = tuple(target_shape[1 + i] // arch.patch_size[i] for i in range(3))
        cos, sin = (torch.from_numpy(a).to(self.device) for a in build_hunyuan_rope(arch, *grid))
        teo = encoder_out["text_encoder_output"]
        mask_np = teo["text_encoder_1_attention_mask"]
        kv_len = self.timings["kv_len"] = text_kv_len(int(np.prod(grid)), mask_np)
        mask = torch.from_numpy(mask_np).to(self.device)
        states = teo["text_encoder_1_text_states"]
        pooled = teo["text_encoder_2_text_states"]
        guidance = torch.tensor([float(self.config.get("embedded_guidance_scale", 6.0)) * 1000.0],
                                dtype=torch.float32, device=self.device)
        attn = self.config.get("attention_impl") or self.config.get("attention_type", "flash_attn3")
        model = HunyuanTransformer(self.model, arch, attn_type=attn)
        steps = []
        t0 = time.perf_counter()
        for _ in range(scheduler.num_steps()):
            lat, t = scheduler.step_pre(state)
            pred = model(lat[None], t, states, mask, pooled, cos, sin, kv_len, guidance)[0]
            state = scheduler.step_post(state, pred)
            self.sync()
            steps.append(time.perf_counter())
        self.timings["step_s"] = list(np.diff([t0] + steps))
        return state["latents"]

    def run_vae_decoder(self, latents) -> np.ndarray:
        z = latents.permute(1, 2, 3, 0)[None]  # (C, F, H, W) -> (1, F, H, W, C)
        scale = not self.config.get("synthetic_weights")
        if self.config.get("use_tiling_vae") or z.shape[1] > 16:
            frames = hunyuan_vae_decode_tiled(self.vae, z, self.vae_cfg, scale=scale)
        else:
            frames = hunyuan_vae_decode(self.vae, z, self.vae_cfg, scale=scale)
        return np.clip(frames[0].float().cpu().numpy(), -1.0, 1.0)
