"""Audio-driven video runner (counterpart of
``lightx2v_tpu.runners.wan_audio_runner``).

Audio features (``encoders/audio.py``: the waveform envelope of
``audio_path``, else the JAX runner's ``default_rng(5)`` draw) are projected
to token groups per latent frame, and every ``audio_adapter_interval``-th
DiT block adds the adapter's gated Perceiver cross-attention
(``models/wan/audio_adapter.py``). The denoise is flow-match Euler
(``schedulers/euler.py``, shift 5 unless set). Self- and cross-attention
both run ``attention_impl`` or ``self_attn_1_type`` with no mask, as the JAX
runner calls them: ``radial_attn`` without a mask map is the dense flash
kernel.

A model with 2 z + 4 input channels takes ``y`` = [a 4-channel frame mask |
the VAE latents of the previous segment's last 5 frames, noised and masked,
in a zero video] (``_build_prev_cond``; zeros without a previous segment,
None under ``tiny_vae``). The i2v image encode runs as in the Wan runner,
but, as in the JAX runner, neither its CLIP tokens nor its latents reach
the DiT.

``run_pipeline`` with ``video_duration`` and an existing ``audio_path``
longer than one window generates ``target_video_length``-frame segments
overlapping by 5 frames (seed + segment index each), each with its own
audio window, and stitches frames and audio; ``audio_track`` holds the
stitched (waveform, sample rate), which ``save_video`` muxes into one
``.av.mp4`` (MJPEG + PCM16, ``utils/media.mux_mp4_pcm``; ``mux_container:
"avi"`` for RIFF-AVI). ``timings`` adds each segment's ``prev_cond_s_<i>``,
``dit_s_<i>`` and ``decode_s_<i>``, their ``dit_s`` / ``decode_s`` totals
and every Euler step's ``step_s``.

Synthetic weights: the JAX synthesizer's adapter from host numpy (seed 7)
in the small mode, a device-drawn one of the same layout at a published
width; else ``audio_adapter_path`` or ``model_path/audio_adapter.safetensors``
(``.safetensors`` or a torch ``.pt`` / ``.pth``). Without
``synthetic_weights`` the audio features come from the wav2vec-class
encoder of ``audio_encoder_path`` or ``model_path`` (``encoders/audio.py``),
on the runner's device; with it, from the waveform's envelope, as in the
JAX runner. Refused as the JAX runner
does not run them: the offload keys, ``feature_caching``,
``changing_resolution`` and ``mesh_shape``."""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..encoders.audio import AudioEncoder, read_wav
from ..models.wan.audio_adapter import (KV_DIM, adapter_bytes, audio_projection, audio_time_embedding,
                                        init_random_audio_adapter, init_random_audio_adapter_on_device,
                                        load_audio_adapter, perceiver_ca)
from ..models.wan.config import is_published_width
from ..models.wan.model import wan_block, wan_post_process, wan_pre_process
from ..models.wan.pipeline import rope_for_shape
from ..ops.attention import attention
from ..ops.linear import resolve_mm
from ..schedulers.euler import FlowMatchEulerScheduler
from ..utils.logging_utils import logger
from ..utils.media import mux_avi_pcm, mux_mp4_pcm
from ..utils.registry import RUNNER_REGISTER
from ..utils.safetensors_io import read_state_dict
from ..vae.wan_vae import vae_encode
from .wan_runner import WanRunner, refuse_unrun_keys

PREV_FRAMES = 5  # frames a segment conditions on, and overlaps the previous one by


@RUNNER_REGISTER.register("wan2.1_audio")
class WanAudioRunner(WanRunner):
    scheduler_cls = FlowMatchEulerScheduler
    encodes_frames = True  # the previous segment's last frames are encoded as conditioning
    audio_track = None

    def init_scheduler(self):
        self.config.setdefault("sample_shift", 5.0)
        return self.scheduler_cls(self.config)

    def load_transformer(self):
        cfg = self.config
        refuse_unrun_keys(cfg, "wan2.1_audio")
        if cfg.get("audio_path"):
            self._audio_encoder()  # an audio encoder the port does not run raises here, before the DiT is made
        params = super().load_transformer()
        interval, arch = int(cfg.get("audio_adapter_interval", 1)), self.arch
        if self._synthetic():
            make = init_random_audio_adapter_on_device if is_published_width(arch) else init_random_audio_adapter
            self.audio_adapter = make(dim=arch.dim, kv_dim=KV_DIM, num_layers=arch.num_layers, interval=interval,
                                      heads=arch.num_heads, seed=7, device=self.device)
        else:
            path = cfg.get("audio_adapter_path") or self._model_file("audio_adapter.safetensors")
            self.audio_adapter = load_audio_adapter(read_state_dict(path), interval=interval, heads=arch.num_heads,
                                                    device=self.device)
        self.timings["adapter_gb"] = adapter_bytes(self.audio_adapter) / 1e9
        return params

    def _audio_encoder(self) -> AudioEncoder:
        if not hasattr(self, "_encoder"):
            cfg = self.config
            self._encoder = AudioEncoder(None if self._synthetic() else
                                         cfg.get("audio_encoder_path") or cfg.get("model_path"), self.device)
        return self._encoder

    def _features(self, feats: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(self.device)

    def run_input_encoder(self) -> Dict[str, Any]:
        out = super().run_input_encoder()
        frames = int(self.config.get("target_video_length", 81))
        audio_path = self.config.get("audio_path")
        if audio_path and os.path.exists(audio_path):
            feats = self._audio_encoder().infer(audio_path, frames, fps=float(self.config.get("fps", 16.0)))
        else:
            feats = np.random.default_rng(5).standard_normal((1, frames, 1024)).astype(np.float32) * 0.1
        out["audio_encoder_output"] = self._features(feats)
        return out

    def run_dit(self, encoder_out: Dict[str, Any]):
        cfg, arch, dev = self.config, self.arch, self.device
        target_shape = self.set_target_shape()
        scheduler = self.scheduler = self.init_scheduler()
        lat_gen, _ = self._generators(1)
        state = scheduler.prepare(target_shape, lat_gen, device=dev)
        z_dim, lat_f, lat_h, lat_w = target_shape
        prev = encoder_out.get("previmg_encoder_output")
        y = None if prev is None else torch.cat([prev["prev_mask"], prev["prev_latents"]])
        if y is None and arch.in_dim == 2 * z_dim + 4:  # no previous segment: zero mask and latents
            y = torch.zeros((z_dim + 4, lat_f, lat_h, lat_w), dtype=torch.float32, device=dev)
        rope_cos, rope_sin, seq_len = rope_for_shape(arch, target_shape, device=dev)
        pt, ph, pw = arch.patch_size
        tpf, gf = (lat_h // ph) * (lat_w // pw), lat_f // pt
        adapter = self.audio_adapter
        attn = cfg.get("attention_impl") or cfg.get("self_attn_1_type", "flash_attn3")
        mm_fn, attn_fn = resolve_mm(self.mm_type), partial(attention, attn)
        interval, heads, n_inject = int(adapter["interval"]), int(adapter["heads"]), len(adapter["ca_blocks"])
        weight = float(cfg.get("audio_adapter_weight", 1.0))
        ctx = encoder_out["text_encoder_output"]["context"]
        audio_tokens = audio_projection(adapter["proj"], encoder_out["audio_encoder_output"], gf,
                                        num_tokens=int(adapter["num_tokens"]))
        step_s = self.timings.setdefault("step_s", [])
        for _ in range(scheduler.num_steps()):
            t0 = time.perf_counter()
            lat, t = scheduler.step_pre(state)
            x, embed, embed0, ctx_e, ctx_img, grid, s_tokens = wan_pre_process(
                self.model, lat[None], t, ctx, arch, y=None if y is None else y[None], seq_len=seq_len)
            if "time_embedding" in adapter:
                t_emb = audio_time_embedding(adapter["time_embedding"], t)
            else:  # the adapter's AdaLN is neutral without a time embedding
                t_emb = torch.zeros((1, 3, arch.dim), dtype=torch.float32, device=dev)
            for li, block in enumerate(self.model["blocks"]):
                x = wan_block(block, x, embed0, ctx_e, ctx_img, rope_cos, rope_sin, arch, mm_fn, attn_fn, attn_fn)
                if li % interval == 0 and li // interval < n_inject:  # audio injection every `interval` blocks
                    vid = x[:, :gf * tpf]
                    delta = perceiver_ca(adapter["ca_blocks"][li // interval], audio_tokens,
                                         vid.reshape(x.shape[0], gf, tpf, arch.dim), t_emb, heads=heads)
                    vid += weight * delta.reshape(vid.shape).to(x.dtype)
                    del vid, delta
            pred = wan_post_process(self.model, x, embed, grid, s_tokens, arch)[0]
            del x
            state = scheduler.step_post(state, pred)
            self.sync()
            step_s.append(time.perf_counter() - t0)
        return state["latents"]

    # ------------- multi-segment generation -------------
    def _build_prev_cond(self, prev_frames_px: Optional[np.ndarray], idx: int,
                         max_frames: int) -> Optional[Dict[str, torch.Tensor]]:
        """The previous segment's last 5 frames (noised with a seeded sigma,
        10% of pixels dropped; zeros for segment 0) at the head of a zero
        video, VAE-encoded, and the 4-channel mask that is 1 on those
        frames."""
        z_dim = 16
        if self.arch.in_dim != 2 * z_dim + 4 or self.config.get("tiny_vae"):
            return None  # the model has no conditioning channels (or the runner no encoder)
        h, w = int(self.config.get("target_height", 480)), int(self.config.get("target_width", 832))
        full = np.zeros((max_frames, h, w, 3), np.float32)
        cond_frames = 0
        if prev_frames_px is not None:
            last = prev_frames_px[-PREV_FRAMES:].astype(np.float32)
            rnd = np.random.RandomState(42 + idx)
            sigma = float(np.exp(rnd.normal(-3.0, 0.5)))
            last = last + rnd.randn(*last.shape).astype(np.float32) * sigma
            keep = (rnd.rand(*last.shape[1:3]) > 0.1).astype(np.float32)
            full[:PREV_FRAMES] = last * keep[None, :, :, None]
            cond_frames = PREV_FRAMES
        z = vae_encode(self.vae, torch.from_numpy(full).to(self.device)[None], self.vae_cfg,
                       scale=not self._synthetic())
        prev_latents = z[0].permute(3, 0, 1, 2)  # (z, lat_f, h / 8, w / 8)
        lat_f, lh, lw = prev_latents.shape[1:]
        m = np.zeros(((lat_f - 1) * 4 + 1, lh, lw), np.float32)
        m[:cond_frames] = 1.0
        m = np.concatenate([np.repeat(m[:1], 4, axis=0), m[1:]], axis=0)  # frame 0 repeated 4x, then groups of 4
        m = m.reshape(lat_f, 4, lh, lw).transpose(1, 0, 2, 3)
        return {"prev_latents": prev_latents, "prev_mask": torch.from_numpy(np.ascontiguousarray(m)).to(self.device)}

    def run_pipeline(self, save_video: bool = True) -> Optional[np.ndarray]:
        cfg = self.config
        fps = float(cfg.get("target_fps", cfg.get("fps", 16)))
        max_frames = int(cfg.get("target_video_length", 81))
        audio_path, duration = cfg.get("audio_path"), cfg.get("video_duration")
        self.audio_track = None
        if not duration or not audio_path or not os.path.exists(audio_path):
            return super().run_pipeline(save_video)
        waveform, sr = read_wav(audio_path)
        expected = min(max(1, int(float(duration) * fps)), int(len(waveform) / sr * fps))
        if expected <= max_frames:
            frames = super().run_pipeline(False)
            self.audio_track = (waveform[: round(len(frames) * sr / fps)], sr)
            if save_video:
                self._save(frames)
            return frames

        step = max_frames - PREV_FRAMES
        n_seg = max(int((expected - max_frames) / step) + 1, 1)
        res_frames = expected - n_seg * step
        if res_frames > PREV_FRAMES:
            n_seg += 1
        logger.info(f"audio multi-segment: {expected} frames -> {n_seg} segments")
        self._begin_run()
        if self.text_encoder is None:
            self.text_encoder = self.load_text_encoder()
            self.image_encoder = self.load_image_encoder()
        if self.model is None:
            self.model = self.load_transformer()
        t0 = time.perf_counter()
        encoder_out = super().run_input_encoder()
        self._mark("encode_s", t0)
        if cfg.get("release_modules"):
            self._release("text_encoder")
            self._release("image_encoder")
        base_seed = int(cfg.get("seed", 42))
        segments, audio_slices, prev_video = [], [], None
        try:
            for idx in range(n_seg):
                start = idx * step
                seg_wave = waveform[round(start * sr / fps):round((start + max_frames + 1) * sr / fps)]
                encoder_out["audio_encoder_output"] = self._features(
                    self._audio_encoder().infer_array(seg_wave, sr, max_frames, fps=fps))
                t0 = time.perf_counter()
                encoder_out["previmg_encoder_output"] = self._build_prev_cond(prev_video, idx, max_frames)
                self._mark(f"prev_cond_s_{idx}", t0)
                cfg["seed"] = base_seed + idx
                t0 = time.perf_counter()
                latents = self.run_dit(encoder_out)
                self._mark(f"dit_s_{idx}", t0)
                t0 = time.perf_counter()
                frames = prev_video = self.run_vae_decoder(latents)
                self._mark(f"decode_s_{idx}", t0)
                del latents
                keep = frames[PREV_FRAMES:] if idx > 0 else frames
                if idx == n_seg - 1 and res_frames > PREV_FRAMES:
                    keep = keep[: max(res_frames - (PREV_FRAMES if idx > 0 else 0), 1)]
                segments.append(keep)
                s0 = 0 if idx == 0 else round((PREV_FRAMES + 1) * sr / fps)
                audio_slices.append(seg_wave[s0: s0 + round(len(keep) * sr / fps)])
        finally:
            cfg["seed"] = base_seed
        for stage in ("dit_s", "decode_s"):
            self.timings[stage] = sum(self.timings[f"{stage}_{i}"] for i in range(n_seg))
        video = np.concatenate(segments, axis=0)
        self.audio_track = (np.concatenate(audio_slices), sr)
        if save_video:
            self._save(video)
        return video

    def _save(self, video: np.ndarray):
        self.save_video(video, self.config.get("save_video_path", "./output.mp4"))
        self._mux_av(video, *self.audio_track)

    def _mux_av(self, video: np.ndarray, audio: np.ndarray, sr: int) -> str:
        """One container with the frames and the audio: ``<save path>.av.mp4``
        (or ``.avi`` with ``mux_container: "avi"``)."""
        cfg = self.config
        stem = os.path.splitext(cfg.get("save_video_path", "./output.mp4"))[0]
        fps = int(cfg.get("target_fps", cfg.get("fps", 16)))
        if cfg.get("mux_container", "mp4") == "avi":
            out = mux_avi_pcm(video, audio, sr, stem + ".avi", fps=fps)
        else:
            out = mux_mp4_pcm(video, audio, sr, stem + ".av.mp4", fps=fps)
        logger.info(f"saved muxed a/v container to {out}")
        return out
