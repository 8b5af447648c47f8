"""CausVid autoregressive runner (counterpart of
``lightx2v_tpu.runners.wan_causvid_runner``).

A long video is fragments x AR frame blocks. Each block resets the
step-distill scheduler and runs its ``denoising_step_list`` (9 steps by
default) with the block's tokens attending the KV cache of every earlier
block of the fragment (``models/wan/causvid.py``). Between fragments the
cache is re-anchored by one forward over the last block's final latents at
the last timestep, written at the window's start. The output is the blocks'
latents in order: ``num_blocks + (num_fragments - 1) * (num_blocks - 1)``
blocks of ``num_frame_per_block`` latent frames.

Noise: each block's initial latents come from one generator seeded with the
run seed, drawn block after block; each block's re-noise draws restart from
a generator seeded seed + 1, as each block's JAX scheduler restarts its
``PRNGKey(seed + 1)``. ``run_dit(..., block_latents=, noises=)`` replaces
the two (the tests inject the JAX draws).

The cache is (L, 1, num_frames x tokens per frame, N, D) bf16, made once per
run; a re-anchor overwrites its first block, and slots past a forward's
``kv_len`` are never read, so it is not cleared between fragments.
``timings`` adds ``block_s`` (each AR block), ``reanchor_s``,
``kv_cache_gb`` and, on CUDA, ``dit_start_mem_gb`` (the device memory in use
when the denoise starts); ``step_s`` holds every block forward's seconds.

Refused as the JAX runner does not run them: the offload keys,
``feature_caching``, ``changing_resolution`` and ``mesh_shape``."""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import torch

from ..models.wan.causvid import causvid_forward, init_kv_cache, precompute_cross_kv
from ..models.wan.model import text_embeddings
from ..ops.linear import resolve_mm
from ..ops.rope import build_wan_rope_grid
from ..schedulers.step_distill import WanStepDistillScheduler
from ..utils.logging_utils import logger
from ..utils.registry import RUNNER_REGISTER
from .wan_runner import WanRunner, refuse_unrun_keys

CAUSVID_STEPS = [999, 934, 862, 756, 603, 410, 250, 140, 74]


@RUNNER_REGISTER.register("wan2.1_causvid")
class WanCausVidRunner(WanRunner):
    scheduler_cls = WanStepDistillScheduler

    def load_transformer(self):
        refuse_unrun_keys(self.config, "wan2.1_causvid")
        return super().load_transformer()

    def init_scheduler(self):
        if "sample_shift" not in self.config:
            raise ValueError("wan2.1_causvid needs sample_shift, the step-distill schedule's sigma shift (the JAX "
                             "runner's scheduler reads it too; configs/wan_t2v_causvid.json names none)")
        if "denoising_step_list" not in self.config:
            self.config["denoising_step_list"] = list(CAUSVID_STEPS)
        self.config["infer_steps"] = len(self.config["denoising_step_list"])
        return self.scheduler_cls(self.config)

    def layout(self):
        """(latent frames per block, tokens per latent frame, the window's
        latent frames, blocks per fragment, fragments, the block's latent
        shape)."""
        cfg = self.config
        _, sh, sw = cfg.get("vae_stride", (4, 8, 8))
        lat_h, lat_w = int(cfg.get("target_height", 480)) // sh, int(cfg.get("target_width", 832)) // sw
        _, ph, pw = self.arch.patch_size
        num_frames = int(cfg.get("num_frames", 21))
        fpb = int(cfg.get("num_frame_per_block", 7))
        num_blocks = int(cfg.get("num_blocks", num_frames // fpb))
        return (fpb, (lat_h // ph) * (lat_w // pw), num_frames, num_blocks, int(cfg.get("num_fragments", 1)),
                (16, fpb, lat_h, lat_w))

    def run_dit(self, encoder_out: Dict[str, Any], block_latents: Optional[Sequence[torch.Tensor]] = None,
                noises: Optional[Sequence[torch.Tensor]] = None):
        cfg, arch, dev = self.config, self.arch, self.device
        fpb, frame_seq, num_frames, num_blocks, num_fragments, target_blk = self.layout()
        cfg["target_shape"] = target_blk
        if dev.type == "cuda":  # what the denoise starts from (the T5 is released before it with release_modules)
            self.timings["dit_start_mem_gb"] = torch.cuda.memory_allocated(dev) / 1e9
        scheduler = self.scheduler = self.init_scheduler()
        lat_gen, _ = self._generators(1)
        scheduler.prepare(target_blk, lat_gen, device=dev)  # the schedule; the draw is discarded, as in JAX
        n_steps = scheduler.num_steps()
        seed = int(cfg.get("seed", 42))

        ctx = text_embeddings(self.model, encoder_out["text_encoder_output"]["context"], resolve_mm("Default"))
        cross_kv = precompute_cross_kv(self.model, ctx, arch)
        del ctx
        kv = init_kv_cache(arch, num_frames * frame_seq, device=dev)
        self.timings["kv_cache_gb"] = 2 * kv["k"].numel() * kv["k"].element_size() / 1e9
        attn = cfg.get("attention_impl") or cfg.get("self_attn_1_type", "flash_attn3")
        pt, ph, pw = arch.patch_size
        lat_h, lat_w = target_blk[2:]
        rope = {sf: tuple(torch.from_numpy(a).to(dev) for a in build_wan_rope_grid(
            arch.head_dim, fpb // pt, lat_h // ph, lat_w // pw, start_frame=sf)) for sf in range(0, num_frames, fpb)}
        t_last = torch.tensor([float(scheduler.timesteps[-1])], dtype=torch.float32, device=dev)

        def forward(lat, t, kv_start, kv_end):
            return causvid_forward(self.model, lat[None], t, kv, cross_kv, *rope[kv_start // frame_seq], kv_start,
                                   kv_end, arch, mm_type=self.mm_type, attn_type=attn)[0]

        step_s, block_s, reanchor_s = [], [], []
        self.timings.update(step_s=step_s, block_s=block_s, reanchor_s=reanchor_s)
        out_blocks, last, n_block = [], None, 0
        for frag in range(num_fragments):
            kv_start, kv_end = 0, fpb * frame_seq
            if frag > 0:  # re-anchor: the last block's latents at the last timestep, at the window's start
                logger.info(f"fragment {frag + 1}/{num_fragments}: re-anchoring kv cache")
                t0 = time.perf_counter()
                forward(last.to(torch.bfloat16), t_last, kv_start, kv_end)
                self.sync()
                reanchor_s.append(time.perf_counter() - t0)
                kv_start, kv_end = kv_end, kv_end + fpb * frame_seq
            for b in range(num_blocks - (1 if frag > 0 else 0)):
                t_blk = time.perf_counter()
                state = scheduler.prepare(target_blk, lat_gen, device=dev)
                if block_latents is not None:
                    state["latents"] = block_latents[n_block].to(dev, torch.float32)
                noise_gen = torch.Generator(device=dev).manual_seed(seed + 1)
                for j in range(n_steps):
                    t0 = time.perf_counter()
                    lat, t = scheduler.step_pre(state)
                    pred = forward(lat, t, kv_start, kv_end)
                    state = scheduler.step_post(state, pred, noise_gen, noise=None if noises is None else noises[j])
                    self.sync()
                    step_s.append(time.perf_counter() - t0)
                out_blocks.append(state["latents"])
                last = state["latents"]
                block_s.append(time.perf_counter() - t_blk)
                kv_start, kv_end = kv_end, kv_end + fpb * frame_seq
                n_block += 1
                logger.info(f"fragment {frag + 1}: block {b + 1} done")
        return torch.cat(out_blocks, dim=1)  # (C, total latent frames, H, W)
