"""HunyuanVideo runner (counterpart of
``lightx2v_tpu.runners.hunyuan_runner``): the Llama hidden states and the
CLIP-L pooled vector of the prompt -> the MMDiT with embedded guidance
(guidance scale x 1000, no CFG) -> flow-match Euler (shift 7) -> the causal
3D VAE decode, tiled past 16 latent frames or with ``use_tiling_vae``.

``task: "i2v"`` runs the DiT with token replace (the first latent frame's
tokens take the t = 0 modulation) and RIFLEx past 192 frames
(``riflex_k_for(target_video_length)``, recorded in ``timings["riflex_k"]``
with ``timings["tr_len"]``). Like the JAX runner it encodes no image and pins
no latents: its i2v conditions through the modulation alone.
``feature_caching: "Tea"`` decides on the host from the time embeddings of
the whole schedule (``hunyuan_tea_plan``) and skips the whole stack on a
skip step, reusing the last computed prediction (fp32, as the JAX state
holds it); ``timings["calc_steps"]`` records the decisions. ``step_window =
(first, count)`` runs steps first..first + count - 1 of the schedule (the
Tea plan still sees all of it; a cached window starts at a calc step).

Synthetic weights only. A config that names no transformer width gets the
JAX runner's small synthetic mode: the small ``HunyuanArch`` (96 wide, 4
heads, 2 + 2 blocks), the small VAE, and random text states and pooled
vector drawn from a numpy stream seeded with Python's salted ``hash()`` of
the prompt, as there (so the two packages agree only within one process). A
config that names ``hidden_size`` (3072, the only width it takes) gets
``HunyuanArch()`` made on the device, the llava-llama-3-8b-class encoder and the CLIP-L text tower made on the device
behind synthetic tokenizers (the encoders a real-weights run runs, where the
JAX runner's synthetic mode draws random states), and the full VAE.

``mesh_shape`` (t2v, under ``torchrun``) runs Ulysses over the joint
[image; text] stream on the mesh's sp axis (``models/hunyuan/sharded.py``).
i2v with ``mesh_shape`` raises ``NotImplementedError`` (ROADMAP.md, Queue 3,
difference ba): token replace needs the global index of the first frame's
tokens, and the JAX runner then runs on one device without saying so.

Refused: the HF text encoders (``text_encoder_path``,
``text_encoder_crop_start``; ``NotImplementedError`` naming their Queue 1
item), real weights (the JAX runner's text encoders
run through ``transformers``, which the card machine lacks), a caching mode
other than Tea (``ValueError``: the JAX runner runs Tea only), and a
quantized ``mm_config`` (``ValueError``: the JAX runner runs every Hunyuan
linear as ``Default`` whatever ``mm_config`` says; the quantized DiT is
reached through ``HunyuanTransformer(..., mm_type=...)``)."""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..caching.teacache import hunyuan_tea_plan
from ..encoders.clip import ClipTextArch, CLIPTextModel, init_random_clip_text_params_on_device
from ..encoders.llama import LLAVA_LLAMA3_8B, PROMPT_TEMPLATE, LlamaArch, LlamaEncoderModel, \
    init_random_llama_params_on_device
from ..models.hunyuan.config import HunyuanArch
from ..models.hunyuan.model import HunyuanTransformer, build_hunyuan_rope, riflex_k_for, text_kv_len
from ..models.hunyuan.sharded import hunyuan_forward_sharded
from ..models.hunyuan.weights import (init_random_hunyuan_params_on_device, init_random_hunyuan_state_dict,
                                      load_hunyuan_params)
from ..schedulers.euler import FlowMatchEulerScheduler
from ..utils.registry import RUNNER_REGISTER
from ..vae.hunyuan_vae import (HunyuanVAEConfig, hunyuan_vae_decode, hunyuan_vae_decode_tiled,
                               init_random_hunyuan_vae_state_dict, load_hunyuan_vae_params)
from .base_runner import DefaultRunner, check_mesh_shape
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
    # (first step, step count) of the schedule to run; None runs all of it
    step_window: Optional[Tuple[int, int]] = None

    def __init__(self, config):
        if config.get("feature_caching", "NoCaching") not in (None, "NoCaching", "Tea"):
            raise ValueError(f"feature_caching {config['feature_caching']!r}: the HunyuanVideo runner runs Tea only, "
                             "as the JAX runner does")
        if config.get("mesh_shape"):
            if config.get("task") == "i2v":
                raise NotImplementedError("HunyuanVideo i2v with mesh_shape: token replace needs the global index "
                                          "of the first frame's tokens, and the JAX runner runs it on one device "
                                          "(ROADMAP.md, Queue 3, difference ba)")
            check_mesh_shape(config["mesh_shape"])
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
        if config.get("mesh_shape"):
            self.build_run_mesh()

    def _full_width(self) -> bool:
        return "hidden_size" in self.config

    def _i2v(self) -> bool:
        return self.config.get("task", "t2v") == "i2v"

    def load_transformer(self):
        task = self.config.get("task", "t2v")
        if not self._full_width():
            self.arch = dataclasses.replace(SMALL_ARCH, task=task)
            return load_hunyuan_params(init_random_hunyuan_state_dict(self.arch, seed=0, scale=0.05), self.arch,
                                       device=self.device)
        self.arch = HunyuanArch(task=task)
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
        """The Euler loop over the step window. ``kv_len`` (image tokens +
        the prompt's valid text tokens) is counted once on the host from the
        mask and recorded in ``timings["kv_len"]``; each step's seconds in
        ``timings["step_s"]``, its index in ``timings["step_index"]``."""
        target_shape = self.set_target_shape()
        self.scheduler = scheduler = self.init_scheduler()
        state = scheduler.prepare(target_shape, self._generators(0)[0], device=self.device)
        n = scheduler.num_steps()
        first, count = self.step_window or (0, n)
        state["step_index"] = first
        arch = self.arch
        grid = tuple(target_shape[1 + i] // arch.patch_size[i] for i in range(3))
        frames = int(self.config.get("target_video_length", 85))
        riflex_k = riflex_k_for(frames) if self._i2v() else None
        self.timings["riflex_k"] = riflex_k
        self.timings["tr_len"] = grid[1] * grid[2] if self._i2v() else 0
        cos, sin = (torch.from_numpy(a).to(self.device)
                    for a in build_hunyuan_rope(arch, *grid, riflex_k=riflex_k, l_test=grid[0] if riflex_k else None))
        teo = encoder_out["text_encoder_output"]
        mask_np = teo["text_encoder_1_attention_mask"]
        kv_len = self.timings["kv_len"] = text_kv_len(int(np.prod(grid)), mask_np)
        mask = torch.from_numpy(mask_np).to(self.device)
        states = teo["text_encoder_1_text_states"]
        pooled = teo["text_encoder_2_text_states"]
        guidance = torch.tensor([float(self.config.get("embedded_guidance_scale", 6.0)) * 1000.0],
                                dtype=torch.float32, device=self.device)
        attn = self.config.get("attention_impl") or self.config.get("attention_type", "flash_attn3")
        if self.mesh is not None:
            model = partial(hunyuan_forward_sharded, self.model, arch=arch, mesh=self.mesh, attn_type=attn)
        else:
            model = partial(HunyuanTransformer(self.model, arch, attn_type=attn), token_replace=self._i2v())
        plan = hunyuan_tea_plan(scheduler.timesteps, self.config) if self.config.get("feature_caching") == "Tea" \
            else np.ones(n, bool)
        if not plan[first]:
            raise ValueError(f"Tea: a run that starts at step {first} must start at a calc step")
        steps, pred = [], None
        t0 = time.perf_counter()
        for i in range(first, min(n, first + count)):
            lat, t = scheduler.step_pre(state)
            if plan[i]:  # a skip step reuses the last computed prediction
                pred = model(lat[None], t, states, mask, pooled, cos, sin, kv_len, guidance=guidance)[0]
            state = scheduler.step_post(state, pred)
            self.sync()
            steps.append(time.perf_counter())
        self.timings["step_s"] = list(np.diff([t0] + steps))
        self.timings["step_index"] = list(range(first, first + len(steps)))
        self.timings["calc_steps"] = [bool(c) for c in plan[first:first + len(steps)]]
        return state["latents"]

    def run_vae_decoder(self, latents) -> np.ndarray:
        z = latents.permute(1, 2, 3, 0)[None]  # (C, F, H, W) -> (1, F, H, W, C)
        scale = not self.config.get("synthetic_weights")
        if self.config.get("use_tiling_vae") or z.shape[1] > 16:
            frames = hunyuan_vae_decode_tiled(self.vae, z, self.vae_cfg, scale=scale)
        else:
            frames = hunyuan_vae_decode(self.vae, z, self.vae_cfg, scale=scale)
        return np.clip(frames[0].float().cpu().numpy(), -1.0, 1.0)
