"""Runner abstractions (counterpart of ``lightx2v_tpu.runners.base_runner``).

A runner owns one model family's pieces (text encoder, image encoder for
i2v, DiT, VAE, scheduler) on one device and drives ``run_pipeline``: encode
-> denoise -> VAE decode -> save video. With ``release_modules`` the text
and image encoders are dropped before the denoise and the DiT before the
decode (reloaded by the next run).

``timings`` holds each stage's seconds (``encode_s``, ``dit_s``,
``decode_s``; a runner may add parts of a stage) and, on CUDA, ``mem_gb``:
the device's peak allocated memory after each stage or part, in order, so
the stage that set the run's peak is the first to show the final value."""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logging_utils import logger
from ..utils.media import cache_video, seed_all


class BaseRunner:
    def __init__(self, config):
        self.config = config
        self.device = resolve_device(config.get("device") or "cuda")

    def load_transformer(self):
        raise NotImplementedError

    def load_text_encoder(self):
        raise NotImplementedError

    def load_vae(self):
        raise NotImplementedError

    def load_image_encoder(self):
        return None

    def init_scheduler(self):
        raise NotImplementedError

    def set_target_shape(self):
        raise NotImplementedError


class DefaultRunner(BaseRunner):
    """Generic pipeline: encode, denoise, decode."""

    def __init__(self, config):
        super().__init__(config)
        seed_all(int(config.get("seed", 42)))
        self.timings: Dict[str, Any] = {}
        self.init_modules()

    def init_modules(self):
        t0 = time.perf_counter()
        self.model = self.load_transformer()
        self.text_encoder = self.load_text_encoder()
        self.image_encoder = self.load_image_encoder()
        self.vae = self.load_vae()
        self.sync()
        self.timings["load_s"] = time.perf_counter() - t0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _generators(self, noise_offset: int):
        """(latent generator, re-noise generator seeded ``seed +
        noise_offset``). ``latent_init: "torch"`` draws the latents from a
        CPU generator (the JAX package's torch stream); otherwise both live
        on the run device."""
        seed = int(self.config.get("seed", 42))
        lat_dev = "cpu" if str(self.config.get("latent_init", "")) == "torch" else self.device
        return (torch.Generator(device=lat_dev).manual_seed(seed),
                torch.Generator(device=self.device).manual_seed(seed + noise_offset))

    def _release(self, name: str):
        setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def run_input_encoder(self) -> Dict[str, Any]:
        raise NotImplementedError

    def run_dit(self, encoder_out: Dict[str, Any]):
        raise NotImplementedError

    def run_vae_decoder(self, latents) -> np.ndarray:
        raise NotImplementedError

    def save_video(self, frames: np.ndarray, save_path: str):
        cache_video(frames, save_path, fps=int(self.config.get("fps", 16)))
        logger.info(f"saved video to {save_path}")

    def _mark(self, name: str, t0: float):
        """Record the seconds since ``t0`` (after a sync) and the peak
        device memory so far under ``name``."""
        self.sync()
        self.timings[name] = time.perf_counter() - t0
        if self.device.type == "cuda":
            self.timings.setdefault("mem_gb", {})[name] = torch.cuda.max_memory_allocated(self.device) / 1e9

    def _stage(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self._mark(name, t0)
        logger.info(f"[Profile] {name}: {self.timings[name]:.3f} s")
        return out

    def run_pipeline(self, save_video: bool = True) -> Optional[np.ndarray]:
        release = bool(self.config.get("release_modules", False))
        if self.text_encoder is None:
            self.text_encoder = self.load_text_encoder()
            self.image_encoder = self.load_image_encoder()
        self.timings.pop("mem_gb", None)
        encoder_out = self._stage("encode_s", self.run_input_encoder)
        if release:
            self._release("text_encoder")
            self._release("image_encoder")
        if self.model is None:
            self.model = self.load_transformer()
        latents = self._stage("dit_s", self.run_dit, encoder_out)
        if release:
            self._release("model")
        frames = self._stage("decode_s", self.run_vae_decoder, latents)
        if save_video:
            self.save_video(frames, self.config.get("save_video_path", "./output.mp4"))
        return frames
