"""Runner abstractions (counterpart of ``lightx2v_tpu.runners.base_runner``).

A runner owns one model family's pieces (text encoder, image encoder for
i2v, DiT, VAE, scheduler) on one device and drives ``run_pipeline``: encode
-> denoise -> VAE decode -> save video. With ``release_modules`` the text
and image encoders are dropped before the denoise and the DiT before the
decode (reloaded by the next run).

``timings`` holds the load seconds (``load_s``, and per component in
``load_parts_s``), each stage's seconds (``encode_s``, ``dit_s``,
``decode_s``, ``save_s`` when it writes the video; a runner may add parts
of a stage) and, on CUDA, ``mem_gb``: the device's peak allocated memory
after each stage or part of this run, in order, so the stage that set the
run's peak is the first to show the final value. A run starts from the
keys its load wrote and resets the device's peak, so each run's entries
are its own.

Serving (``server/service.py``) feeds a task through ``set_inputs`` and
stops it through ``stop_event``: ``run_pipeline`` calls ``check_stop``
after the encode and after the DiT, as the JAX runner does, and raises
``TaskStopped`` there. ``progress_callback(done, total)`` is called when
the denoise ends."""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logging_utils import logger
from ..utils.media import cache_video, seed_all


class TaskStopped(Exception):
    """A task-stop request interrupted the pipeline between stages."""


class BaseRunner:
    def __init__(self, config):
        self.config = config
        self.device = resolve_device(config.get("device") or "cuda")
        self.progress_callback = None
        self.stop_event = None  # per-task threading.Event set by the service

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

    def set_progress_callback(self, cb):
        self.progress_callback = cb

    def set_inputs(self, inputs: Dict[str, Any]):
        """Merge a task's fields (prompt, negative_prompt, image_path,
        seed, ...) into the config. Quantization is a load-time property: a
        requested ``mm_type`` other than the loaded one raises
        ``ValueError``; on a runner with no ``mm_type`` it is ignored with a
        warning."""
        req_mm = inputs.pop("mm_type", None)
        loaded = getattr(self, "mm_type", None)
        if req_mm and loaded is None:
            logger.warning(f"task requested mm_type {req_mm!r} but this runner has no mm_type (request ignored; "
                           "quantization is a load-time property of the server config)")
        if req_mm and loaded and req_mm != loaded:
            raise ValueError(f"task requested mm_type {req_mm!r} but the server loaded {loaded!r}; relaunch with "
                             "that mm_config/quantized ckpt (per-task quantization switching is not supported)")
        self.config.update({k: v for k, v in inputs.items() if v is not None})


class DefaultRunner(BaseRunner):
    """Generic pipeline: encode, denoise, decode."""

    def __init__(self, config):
        super().__init__(config)
        seed_all(int(config.get("seed", 42)))
        self.timings: Dict[str, Any] = {}
        self.init_modules()
        self._load_keys = frozenset(self.timings)

    def init_modules(self):
        t0 = time.perf_counter()
        parts = self.timings["load_parts_s"] = {}
        for name, load in (("model", self.load_transformer), ("text_encoder", self.load_text_encoder),
                           ("image_encoder", self.load_image_encoder), ("vae", self.load_vae)):
            t1 = time.perf_counter()
            setattr(self, name, load())
            self.sync()
            parts[name] = time.perf_counter() - t1
            if self.device.type == "cuda":  # the device peak so far, after each part
                self.timings.setdefault("load_mem_gb", {})[name] = torch.cuda.max_memory_allocated(self.device) / 1e9
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

    def check_stop(self):
        """Raise ``TaskStopped`` when this runner's task was asked to stop
        (stop granularity is the stage boundary)."""
        if self.stop_event is not None and self.stop_event.is_set():
            raise TaskStopped("task stop requested")

    def _begin_run(self):
        """Drop the previous run's timings (the load's stay) and reset the
        device's peak memory."""
        self.timings = {k: v for k, v in self.timings.items() if k in self._load_keys}
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def _stage(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self._mark(name, t0)
        logger.info(f"[Profile] {name}: {self.timings[name]:.3f} s")
        return out

    def run_pipeline(self, save_video: bool = True) -> Optional[np.ndarray]:
        release = bool(self.config.get("release_modules", False))
        self._begin_run()
        if self.text_encoder is None:
            self.text_encoder = self.load_text_encoder()
            self.image_encoder = self.load_image_encoder()
        encoder_out = self._stage("encode_s", self.run_input_encoder)
        if release:
            self._release("text_encoder")
            self._release("image_encoder")
        self.check_stop()
        if self.model is None:
            self.model = self.load_transformer()
        latents = self._stage("dit_s", self.run_dit, encoder_out)
        if release:
            self._release("model")
        self.check_stop()
        frames = self._stage("decode_s", self.run_vae_decoder, latents)
        if save_video:
            self._stage("save_s", self.save_video, frames, self.config.get("save_video_path", "./output.mp4"))
        return frames
