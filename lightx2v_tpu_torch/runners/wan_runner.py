"""Wan2.1 runners (counterpart of ``lightx2v_tpu.runners.wan_runner``), t2v
and i2v with resident weights.

``wan2.1`` is the base model: UniPC with classifier-free guidance as one
batched forward. ``wan2.1_distill`` is the 4-step step-distill model without
CFG.

Synthetic weights (``synthetic_weights``): a config that names no ``dim``
gets the JAX runner's small synthetic stack built from the same host numpy
dicts (small DiT, small T5, small VAE), so the two packages run identical
weights. A config at a published Wan width gets a full-size stack made on
the device from seeded ``torch.Generator``s: the DiT (int8 codes plus
per-channel scales under an int8 mm_type, e4m3 codes plus per-channel
scales under an fp8 one, nibble-packed int4 plus per-(channel, group)
scales under an int4 one), a UMT5-XXL when text_dim is 4096 (bf16, or int8
or fp8 with ``t5_quantized`` and ``t5_quant_scheme``), and the full Wan VAE.

i2v (``task: "i2v"``, ``image_path``): the image is resized to the target
size (``utils/image.resize_area``, cv2's INTER_AREA), its CLIP tokens become
the image context, and the VAE latents of [image, zeros x (frames - 1)] (untiled,
normalized, as the JAX runner encodes even under ``use_tiling_vae``) with a
4-channel first-frame mask become ``y``, 20 channels beside the 16 of the
latents. In the small synthetic mode the CLIP tokens are zeros, as the JAX
runner feeds them. At a published width the runner makes the ViT-H/14
tower on the device (bf16, or int8 / fp8 with ``clip_quantized`` and
``clip_quant_scheme``) and runs it, as it makes the UMT5-XXL where the JAX
runner would use a small T5: the card runs the tower that a real-weights
run runs.

Checkpoints (no ``synthetic_weights``): the DiT from ``dit_quantized_ckpt``
or ``model_path`` (safetensors, one file, chunks with an index, or the
converter's blocks layout; ``utils/safetensors_io.load_sharded``), with the
``lora_configs`` folded in before its params are built; the UMT5-XXL from
``model_path/models_t5_umt5-xxl-enc-bf16.pth`` (quantized at load with
``t5_quantized``) with the HF tokenizer files of ``model_path/google/umt5-xxl``
(or a tokenizer set on the encoder); the CLIP ViT-H/14 from
``model_path/models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth``; the
VAE from ``model_path/Wan2.1_VAE.pth``. A LoRA on a quantized checkpoint, a
float checkpoint under a quantized ``mm_type`` and a quantized one under
``Default`` raise ``ValueError`` pointing at ``tools/convert.py``.
``enable_dynamic_cfg`` feeds
``cfg_scale`` to a checkpoint's ``cfg_cond_proj``.

Offload (``models/wan/streaming.py``, ``lazy_offload.py``): with
``cpu_offload`` or ``weight_streaming`` the blocks live packed in pinned
host memory (built and packed one at a time at load, so the card holds the
non-block weights and one block then) and stream to two device slots; with ``lazy_load`` they stay in
a blocks-layout checkpoint and ``num_disk_workers`` threads read them into
a staging pool of ``max_memory`` GB. CFG stays one batch-2 forward, so the
weights stream once a step. ``timings["offload"]`` holds each step's
counters (host-to-device bytes and copy ms, stall ms, disk bytes and read
seconds, and with caching the bytes its state moved to and from the host).
Tea, Custom, TaylorSeer and Ada run under offload as the JAX streamed
forward runs them (``models/wan/pipeline.py``, ``streamed``): a skipped step
copies no block. TaylorWS and ``changing_resolution`` under offload raise
``NotImplementedError`` (ROADMAP.md, Queue 3, difference ac): the JAX runner
runs the one uncached and the other with resident weights.

``tiny_vae`` decodes with the taew2_1 decoder (``vae/tiny_vae.py``: random
from seed 2 with ``synthetic_weights`` or without ``tiny_vae_path``, as the
JAX runner), ``TINY_VAE_CHUNK`` latent frames at a time, and ignores
``use_tiling_vae``. ``vae_int8`` runs the Wan VAE decoder's convolutions on
int8 codes (``quantize_vae_decoder_int8``).

Multi-GPU (``mesh_shape``, one process per GPU under ``torchrun``, t2v and
i2v): the denoise runs over the ``(dp, sp, tp)`` mesh (``models/wan/sharded.py``;
``parallel_attn_type`` "ulysses" (default) or "ring" over sp), the blocks
held as this rank's tp shard; ``parallel_vae`` decodes over the mesh
(``parallel/vae_parallel.py``). Offload, ``changing_resolution`` and
``do_mm_calib`` with ``mesh_shape`` raise ``NotImplementedError`` (ROADMAP.md,
Queue 3, difference az): the JAX runner runs them on one device whatever
``mesh_shape`` says, which on N ranks would be N identical runs.

``do_mm_calib`` (mm_type ``Default`` only; a quantized one raises
``ValueError``, as does the disk tier ``NotImplementedError``) runs one
calibration forward before the denoise and writes the activation stats
(``collect_calib_stats``, ``tools/calibrate.py``).

``feature_caching`` (Tea, Custom, TaylorSeer, TaylorWS, Ada) runs in the
denoise loop (``models/wan/pipeline.py``), the config passed on as its
caching config; ``timings["calc_steps"]`` records which steps ran the block
stack. ``changing_resolution`` runs the first ``changing_resolution_steps``
(k) steps at ``resolution_rate`` of the latent's height and width, one more
forward at step k whose x0 prediction is resized trilinearly to the full
latent and re-noised from the re-noise generator, then a fresh UniPC at
shift + 2 from step k + 1 (``_run_dit_changing_resolution``).

``step_window = (first, count)`` (an attribute, or the config key
``step_window``) runs steps first..first + count - 1 of the file's schedule
(every decision still sees the whole schedule; a UniPC run restarts its
multistep history at ``first``). A changing-resolution window must hold
step k; each phase runs its part of it.

``sparge: true`` runs the video self-attention as Sparge with the
per-layer budgets of ``sparge_ckpt`` (or ``sparge_l1_per_layer``), the
table's leading failed layers dense (``_self_attn_setup``).
``self_attn_1_type: "radial_attn"`` runs radial attention at
(``sparse_block_q`` x ``sparse_block_k``) superblocks; the optional
``radial_sparsity_type`` (``"bsr"`` or ``"two_pass"``) is passed on as
``radial_attention``'s ``sparsity_type``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..encoders.clip import (ClipVisionArch, CLIPVisionModel, init_random_clip_params_on_device,
                             load_clip_from_path, quantize_clip_params)
from ..encoders.t5 import (UMT5_XXL, T5Config, T5EncoderModel, init_random_t5_params_on_device,
                           init_random_t5_state_dict, load_t5_params, quantize_t5_params)
from ..models.wan.config import arch_from_config, is_published_width
from ..models.wan.lazy_offload import BlockPrefetcher, LazyBlockStore, is_blocks_layout
from ..models.wan.model import wan_forward, wan_forward_cfg
from ..models.wan.pipeline import make_denoise_fn, rope_for_shape
from ..models.wan.sharded import tp_shard_blocks
from ..models.wan.streaming import BlockStreamer, HostBlocks
from ..models.wan.weights import (init_random_params_on_device, init_random_weight_dict, load_wan_params,
                                  permute_block_qk_half)
from ..ops.radial import MaskMap
from ..parallel.mesh import mesh_axis_size
from ..parallel.vae_parallel import parallel_vae_decode
from ..schedulers.step_distill import WanStepDistillScheduler
from ..schedulers.unipc import WanUniPCScheduler
from ..tools.calibrate import collect_block_stats, save_stats
from ..tools.convert import apply_lora, quantize_model
from ..utils.image import resize_area, resize_trilinear
from ..utils.logging_utils import logger
from ..utils.media import load_image
from ..utils.prompt_enhancer import enhance_via_service
from ..utils.registry import RUNNER_REGISTER
from ..utils.safetensors_io import load_file, load_sharded
from ..vae.tiny_vae import init_random_tiny_vae_params, load_tiny_vae_params, tiny_decode_wan_latents
from ..vae.wan_vae import (WanVAEConfig, init_random_vae_state_dict, load_wan_vae_from_path, load_wan_vae_params,
                           quantize_vae_decoder_int8, vae_decode, vae_decode_tiled, vae_encode)
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


# mm_type -> the weight scheme its synthetic weights are made in
_SCHEMES = {"int8": "int8", "fp8": "fp8", "int4": "int4", "nvfp4": "int4", "mxfp8": "mxfp8", "mxfp6": "mxfp6"}


def scheme_of_mm_type(mm_type: str) -> Optional[str]:
    """The weight scheme of an mm_type (None for a float one)."""
    parts = mm_type.split("-")
    if not mm_type.startswith("W-") or len(parts) < 2:
        return None
    return "fp8_block128" if parts[2:3] == ["block128"] else _SCHEMES.get(parts[1])


OFFLOAD_KEYS = ("cpu_offload", "weight_streaming", "lazy_load")
# the reference's file names under model_path
T5_CKPT = "models_t5_umt5-xxl-enc-bf16.pth"
CLIP_CKPT = "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"
VAE_CKPT = "Wan2.1_VAE.pth"
# latent frames the tiny VAE decodes at a time (4 output frames each; at 480x832 a chunk's largest
# activations are 8 frames of 64 channels, 0.82 GB in fp32)
TINY_VAE_CHUNK = 2
FOLD_FIRST = ("fold LoRAs and quantize with python -m lightx2v_tpu_torch.tools.convert "
              "(--lora path[:strength] --quant int8|fp8|int4)")


def refuse_unrun_keys(cfg, model_cls: str):
    """Raise for the keys whose feature the JAX ``model_cls`` runner does not
    run (its denoise loop reads resident blocks, has no caching hook, one
    resolution and one device), rather than run them as if absent."""
    for key in OFFLOAD_KEYS:
        if cfg.get(key):
            raise NotImplementedError(f"{key} on {model_cls}: the JAX runner's denoise reads resident blocks")
    if cfg.get("feature_caching", "NoCaching") not in (None, "NoCaching"):
        raise NotImplementedError(f"feature_caching on {model_cls}: the JAX runner's denoise has no caching hook")
    if cfg.get("changing_resolution"):
        raise NotImplementedError(f"changing_resolution on {model_cls}: the JAX runner denoises at one resolution")
    if cfg.get("mesh_shape"):
        raise NotImplementedError(f"mesh_shape on {model_cls}: the JAX runner runs on one device (ROADMAP.md, "
                                  "Queue 1 item 14)")


@RUNNER_REGISTER.register("wan2.1")
class WanRunner(DefaultRunner):
    scheduler_cls = WanUniPCScheduler
    # (first step, step count) of the schedule to run; None runs all of it
    step_window: Optional[Tuple[int, int]] = None
    # t2v drops the VAE's encoder unless the runner encodes frames itself
    encodes_frames = False

    def __init__(self, config):
        super().__init__(config)
        if config.get("step_window"):
            self.step_window = tuple(int(v) for v in config["step_window"])

    def _synthetic(self) -> bool:
        return bool(self.config.get("synthetic_weights"))

    def _offload(self) -> bool:
        return any(self.config.get(k) for k in OFFLOAD_KEYS)

    def _model_file(self, name: str) -> str:
        if not self.config.get("model_path"):
            raise ValueError(f"{name} is read from model_path: set model_path (or synthetic_weights)")
        return os.path.join(self.config["model_path"], name)

    def _check_scheme(self, scheme: Optional[str], quantized: bool):
        """The checkpoint's linears must be what the mm_type multiplies."""
        if scheme and not quantized:
            raise ValueError(f"mm_type {self.mm_type} needs a quantized checkpoint, this one is float: {FOLD_FIRST}")
        if quantized and not scheme:
            raise ValueError("the checkpoint is quantized: set mm_config.mm_type to its scheme (its config.json names "
                             "it)")

    # ---------------- component loading ----------------
    def load_transformer(self):
        cfg = self.config
        if cfg.get("mesh_shape"):
            for key in (*OFFLOAD_KEYS, "changing_resolution", "do_mm_calib"):
                if cfg.get(key):
                    raise NotImplementedError(f"{key} with mesh_shape: the JAX runner runs it on one device, which "
                                              "on N ranks would be N identical runs (ROADMAP.md, Queue 3, difference "
                                              "az; Queue 1 item 14)")
            self.build_run_mesh()
        if cfg.get("do_mm_calib"):
            if (cfg.get("mm_config") or {}).get("mm_type", "Default") != "Default":
                raise ValueError("do_mm_calib runs the Default GEMM on the checkpoint's weights, which under a "
                                 "quantized mm_type are codes without their scales: calibrate the float "
                                 "checkpoint with mm_type Default (ROADMAP.md, Queue 3, difference au)")
            if cfg.get("lazy_load"):
                raise NotImplementedError("do_mm_calib with lazy_load: the JAX runner holds no blocks to "
                                          "calibrate on the disk tier (ROADMAP.md, Queue 3, difference au)")
        if self._offload() and cfg.get("changing_resolution"):
            raise NotImplementedError("changing_resolution under offload: the JAX runner runs it with resident "
                                      "weights, ignoring cpu_offload, weight_streaming and lazy_load (ROADMAP.md, "
                                      "Queue 3, difference ac)")
        if self._offload() and cfg.get("feature_caching") == "TaylorWS":
            raise NotImplementedError("TaylorWS under offload: the JAX streamed forward runs it uncached "
                                      "(ROADMAP.md, Queue 3, difference ac)")
        if self._synthetic() and "dim" not in cfg:
            for k, v in dict(dim=384, ffn_dim=768, num_heads=6, num_layers=4, freq_dim=256, text_dim=256).items():
                cfg.setdefault(k, v)
        self.arch = arch_from_config(cfg)
        self.mm_type = (cfg.get("mm_config") or {}).get("mm_type", "Default")
        scheme = scheme_of_mm_type(self.mm_type)
        ckpt = cfg.get("dit_quantized_ckpt") or cfg.get("model_path")
        if cfg.get("lazy_load"):
            if not ckpt or not is_blocks_layout(ckpt):
                raise ValueError("lazy_load reads a blocks-layout checkpoint (dit_quantized_ckpt or model_path "
                                 "written by tools/convert.py --layout blocks)")
            if cfg.get("lora_configs"):
                raise ValueError(f"lora_configs with a blocks-layout checkpoint: {FOLD_FIRST}")
            store = LazyBlockStore(ckpt, self.arch, device=self.device)
            self._check_scheme(scheme, store.quantized())
            return dict(store.small, blocks=store)
        # the host-RAM tier builds the blocks one at a time and packs each into
        # pinned host memory, so the card never holds the whole stack
        offload = self._offload()
        if self._synthetic():
            if is_published_width(self.arch):
                params = init_random_params_on_device(self.arch, scheme or "bf16", seed=0, device=self.device,
                                                      iter_blocks=offload)
            else:
                wd = init_random_weight_dict(self.arch, seed=0, scale=0.02)
                if scheme:
                    wd = quantize_model(wd, scheme)
                params = load_wan_params(wd, self.arch, device=self.device, iter_blocks=offload)
        else:
            if not ckpt:
                raise ValueError("set model_path or dit_quantized_ckpt (or synthetic_weights)")
            wd = load_sharded(ckpt)
            for lc in cfg.get("lora_configs") or []:
                apply_lora(wd, load_file(lc["path"]), float(lc.get("strength", 1.0)), device=self.device)
            self._check_scheme(scheme, any(k.endswith(".weight_scale") for k in wd))
            params = load_wan_params(wd, self.arch, device=self.device, iter_blocks=offload)
            del wd
        blocks = params["blocks"]
        if self.arch.rope_fused:
            blocks = (permute_block_qk_half(b, self.arch) for b in blocks)
        params["blocks"] = HostBlocks(blocks, pin=self.device.type == "cuda") if offload else \
            tp_shard_blocks(list(blocks), self.mesh)
        return params

    def load_text_encoder(self):
        text_len = int(self.config.get("text_len", 512))
        scheme = "bf16"
        if self.config.get("t5_quantized"):
            scheme = "int8" if "int8" in str(self.config.get("t5_quant_scheme", "int8")) else "fp8"
        if not self._synthetic():
            # a quantized T5 is read on the host and quantized on its way to the device, one tensor at a time
            enc = T5EncoderModel(text_len, cfg=UMT5_XXL, checkpoint_path=self._model_file(T5_CKPT),
                                 tokenizer_path=self._model_file(os.path.join("google", "umt5-xxl")),
                                 device=self.device if scheme == "bf16" else "cpu")
            if scheme != "bf16":
                enc.params = quantize_t5_params(enc.params, scheme, device=self.device)
            return enc
        if self.arch.text_dim == UMT5_XXL.dim:
            cfg = UMT5_XXL
            params = init_random_t5_params_on_device(cfg, seed=1, device=self.device, scheme=scheme)
        elif self.arch.text_dim == SMALL_T5.dim:
            cfg = SMALL_T5
            params = load_t5_params(init_random_t5_state_dict(cfg, seed=1), cfg, device=self.device)
            if scheme != "bf16":
                params = quantize_t5_params(params, scheme)
        else:
            raise ValueError(f"synthetic text encoders exist for text_dim 256 and 4096, got {self.arch.text_dim}")
        enc = T5EncoderModel(text_len, cfg=cfg, params=params)
        enc.tokenizer = _SyntheticTokenizer(text_len, cfg.vocab_size)
        return enc

    def _i2v(self) -> bool:
        return self.config.get("task", "t2v") == "i2v"

    def load_image_encoder(self):
        """The i2v CLIP tower: a checkpoint's; or in the small synthetic
        mode None (zero tokens), and at a published width a ViT-H/14 made on
        the device."""
        if not self._i2v():
            return None
        arch = ClipVisionArch()
        if not self._synthetic():
            params = load_clip_from_path(self._model_file(CLIP_CKPT), arch, device=self.device)
        elif is_published_width(self.arch):
            params = init_random_clip_params_on_device(arch, seed=3, device=self.device)
        else:
            return None
        if self.config.get("clip_quantized"):
            scheme = "int8" if "int8" in str(self.config.get("clip_quant_scheme", "int8")) else "fp8"
            params = quantize_clip_params(params, scheme)
        return CLIPVisionModel(arch, params=params)

    def load_vae(self):
        if self.config.get("tiny_vae"):
            # taew2_1: random (seed 2) with synthetic weights or no tiny_vae_path, as the JAX runner
            if self._i2v():
                raise ValueError("tiny_vae decodes only: i2v encodes its image with the Wan VAE")
            self.vae_cfg = None
            if self._synthetic() or not self.config.get("tiny_vae_path"):
                return init_random_tiny_vae_params(seed=2, device=self.device)
            return load_tiny_vae_params(self.config["tiny_vae_path"], device=self.device)
        if not self._synthetic():
            self.vae_cfg = WanVAEConfig()
            params = load_wan_vae_from_path(self._model_file(VAE_CKPT), self.vae_cfg, device=self.device)
        else:
            self.vae_cfg = WanVAEConfig() if is_published_width(self.arch) else SMALL_VAE
            params = load_wan_vae_params(init_random_vae_state_dict(self.vae_cfg, seed=2), self.vae_cfg,
                                         device=self.device)
        if not (self._i2v() or self.encodes_frames):  # t2v never encodes: its encoder stays off the device
            del params["encoder"], params["conv1"]
        if self.config.get("vae_int8"):
            params = quantize_vae_decoder_int8(params)
        return params

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
        return self.scheduler_cls(self.config)

    def run_input_encoder(self) -> Dict[str, Any]:
        """The T5 context of the prompt (and of the negative prompt under
        CFG); for i2v the image's. With ``use_prompt_enhancer`` and
        ``prompt_enhancer_url`` the prompt is rewritten by the enhancer
        service first (the raw prompt when the service fails)."""
        if self._i2v() and not self.config.get("image_path"):
            raise ValueError("task i2v needs image_path")
        prompt = self.config.get("prompt", "")
        if self.config.get("use_prompt_enhancer") and self.config.get("prompt_enhancer_url"):
            prompt = enhance_via_service(prompt, self.config["prompt_enhancer_url"]) or prompt
        t0 = time.perf_counter()
        context = self.text_encoder.infer([prompt])
        context_null = context
        if self.config.get("enable_cfg", True):
            context_null = self.text_encoder.infer([self.config.get("negative_prompt", "") or ""])
        out = {"text_encoder_output": {"context": context, "context_null": context_null},
               "image_encoder_output": None}
        if self._i2v():
            self._mark("t5_s", t0)
            out["image_encoder_output"] = self.run_image_encoder(self.config["image_path"])
        return out

    def run_image_encoder(self, image_path: str) -> Dict[str, Any]:
        """i2v conditioning: the CLIP tokens of the image resized to the
        target size, and the VAE latents of [image, zeros x (frames - 1)]
        behind a 4-channel mask that is 1 on the first latent frame. Records
        ``clip_s`` and ``vae_encode_s``."""
        cfg = self.config
        h, w = int(cfg.get("target_height", 480)), int(cfg.get("target_width", 832))
        frames = int(cfg.get("target_video_length", 81))
        t0 = time.perf_counter()
        img = resize_area(load_image(image_path), h, w)
        if self.image_encoder is None:
            clip_out = torch.zeros((1, 257, self.arch.clip_dim), dtype=torch.float32, device=self.device)
        else:
            clip_out = self.image_encoder.infer(img)
        self._mark("clip_s", t0)
        t0 = time.perf_counter()
        vid = torch.zeros((1, frames, h, w, 3), dtype=torch.float32, device=self.device)
        vid[0, 0] = torch.from_numpy(img).to(self.device)
        z = vae_encode(self.vae, vid, self.vae_cfg)[0].permute(3, 0, 1, 2)  # (z, lat_f, h/8, w/8)
        del vid
        msk = torch.zeros((4, *z.shape[1:]), dtype=torch.float32, device=self.device)
        msk[:, 0] = 1.0
        y = torch.cat([msk, z])[None]
        self._mark("vae_encode_s", t0)
        return {"clip_encoder_out": clip_out, "vae_encode_out": y}

    def _prepare(self, scheduler, shape, generator, first: int, **kw):
        """The scheduler's state at step ``first`` (a UniPC restart there)."""
        if first:
            kw["start_step"] = first
        state = scheduler.prepare(shape, generator, device=self.device, **kw)
        state["step_index"] = first
        return state

    def _step_timer(self):
        """(on_step callback, list of step end times): syncs after each step."""
        ends = []

        def on_step(_):
            self.sync()
            ends.append(time.perf_counter())

        return on_step, ends

    @contextlib.contextmanager
    def dit_params(self):
        """(params, streamer) for one run: the resident params and None, or
        under offload the params with their blocks streamed through a
        ``BlockStreamer`` (the disk tier's prefetcher closed afterwards)."""
        blocks = self.model["blocks"]
        if not isinstance(blocks, (HostBlocks, LazyBlockStore)):
            yield self.model, None
            return
        store = blocks
        if isinstance(blocks, LazyBlockStore):
            gb = self.config.get("max_memory")
            store = BlockPrefetcher(blocks, num_workers=int(self.config.get("num_disk_workers", 2)),
                                    max_host_bytes=int(float(gb) * 2**30) if gb else None,
                                    pin=self.device.type == "cuda")
            self.timings["host_buffer_gb"] = store.num_buffers * store.layout.nbytes / 1e9
        else:
            self.timings["host_buffer_gb"] = blocks.num_blocks * blocks.layout.nbytes / 1e9
        try:
            streamer = BlockStreamer(store, self.device)
            yield dict(self.model, blocks=streamer), streamer
        finally:
            if store is not blocks:
                store.close()

    def run_dit(self, encoder_out: Dict[str, Any], noises=None, renoise=None):
        if self.config.get("do_mm_calib"):
            self.collect_calib_stats(encoder_out)
        if self.config.get("changing_resolution"):
            return self._run_dit_changing_resolution(encoder_out, renoise)
        with self.dit_params() as (params, streamer):
            return self._run_dit(params, streamer, encoder_out, noises)

    def collect_calib_stats(self, encoder_out: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """``do_mm_calib``: one calibration forward at the first timestep
        (the scheduler's first latents and timestep, every linear the
        Default GEMM, self- and cross-attention ``self_attn_1_type``), the
        stats written to ``calib_output_path`` (default calib_stats.npz) for
        ``tools/convert.py --calib_stats``. On the host-RAM tier the blocks
        stream through as in a step. Returns the stats."""
        cfg = self.config
        target_shape = self.set_target_shape()
        scheduler = self.init_scheduler()
        state = self._prepare(scheduler, target_shape, self._generators(1)[0], 0)
        rope_cos, rope_sin, _ = rope_for_shape(self.arch, target_shape, device=self.device)
        lat, t = scheduler.step_pre(state)
        teo, ieo = encoder_out["text_encoder_output"], encoder_out.get("image_encoder_output") or {}
        with self.dit_params() as (params, _):
            stats = collect_block_stats(params, self.arch, lat[None], t.reshape(1).float(), teo["context"],
                                        rope_cos, rope_sin, y=ieo.get("vae_encode_out"),
                                        clip_fea=ieo.get("clip_encoder_out"),
                                        self_attn_type=cfg.get("self_attn_1_type", "xla"))
        out_path = cfg.get("calib_output_path", "calib_stats.npz")
        save_stats(stats, out_path)
        logger.info(f"calibration stats written to {out_path}")
        return stats

    def _run_dit(self, params, streamer, encoder_out: Dict[str, Any], noises=None):
        target_shape = self.set_target_shape()
        scheduler = self.init_scheduler()
        self.scheduler = scheduler
        lat_gen, noise_gen = self._generators(1)
        first, count = self.step_window or (0, None)
        state = self._prepare(scheduler, target_shape, lat_gen, first)
        attn, cross_attn, self_attn_kwargs = self._self_attn_setup()
        if attn == "radial_attn":
            pt, ph, pw = self.arch.patch_size
            gf = target_shape[1] // pt
            vid_tokens = gf * (target_shape[2] // ph) * (target_shape[3] // pw)
            self_attn_kwargs = {"mask_map": MaskMap(video_token_num=vid_tokens, num_frame=gf),
                                "decay_factor": float(self.config.get("decay_factor", 0.5)),
                                "block_q": int(self.config.get("sparse_block_q", 2048)),
                                "block_k": int(self.config.get("sparse_block_k", 1024))}
            if self.config.get("radial_sparsity_type"):
                self_attn_kwargs["sparsity_type"] = str(self.config["radial_sparsity_type"])
        enable_cfg = bool(self.config.get("enable_cfg", True))
        denoise = make_denoise_fn(self.arch, scheduler, target_shape, enable_cfg=enable_cfg,
                                  guide_scale=float(self.config.get("sample_guide_scale", 5.0)),
                                  mm_type=self.mm_type,
                                  self_attn_type=attn, cross_attn_type=cross_attn,
                                  feature_caching=self.config.get("feature_caching", "NoCaching"),
                                  caching_config=self.config, num_steps=count,
                                  self_attn_kwargs=self_attn_kwargs, device=self.device,
                                  cfg_scale_embed=(float(self.config.get("cfg_scale", 4.0))
                                                   if self.config.get("enable_dynamic_cfg") else None),
                                  streamed=streamer is not None, mesh=self.mesh,
                                  sp_size=mesh_axis_size(self.mesh, "sp"),
                                  parallel_attn_type=self.config.get("parallel_attn_type") or "ulysses")
        on_step, ends = self._step_timer()
        if streamer is not None:
            stats = self.timings["offload"] = []
            timer = on_step

            def on_step(j):
                timer(j)  # synced: the step's copies and reads are done
                sc = denoise.stream_cache
                stats.append({**streamer.take_stats(), **(sc.take_stats() if sc is not None else {})})

        t0 = time.perf_counter()
        teo, ieo = encoder_out["text_encoder_output"], encoder_out.get("image_encoder_output") or {}
        state = denoise(params, state, teo["context"], noise_gen, noises=noises, on_step=on_step,
                        context_null=teo["context_null"] if enable_cfg else None,
                        y=ieo.get("vae_encode_out"), clip_fea=ieo.get("clip_encoder_out"))
        self.timings["step_s"] = list(np.diff([t0] + ends))
        self.timings["calc_steps"] = list(denoise.calc_steps)
        self.timings["step_index"] = list(range(first, first + len(ends)))
        if self.progress_callback:
            self.progress_callback(scheduler.num_steps(), scheduler.num_steps())
        return state["latents"]

    def _run_dit_changing_resolution(self, encoder_out: Dict[str, Any], renoise=None):
        """Two phases (t2v, no caching, as the JAX runner): steps 0..k-1 at
        ``resolution_rate``; at step k one more low-resolution forward, its
        x0 prediction ``latents - sigma_k * pred`` (fp32) resized trilinearly
        to the full latent and re-noised, ``(1 - sigma_k) * clean + sigma_k *
        noise``, the noise drawn from the re-noise generator (or
        ``renoise``); then a fresh UniPC at shift + 2 from step k + 1. Self-
        and cross-attention both run ``attention_impl`` or
        ``self_attn_1_type``; every forward runs the runner's ``mm_type``."""
        cfg = self.config
        target = self.set_target_shape()
        c, f_, h, w = target
        rate = float(cfg.get("resolution_rate", 0.75))
        n = int(cfg.infer_steps)
        k = int(cfg.get("changing_resolution_steps", n // 2))
        low = (c, f_, int(h * rate) // 2 * 2, int(w * rate) // 2 * 2)
        first, count = self.step_window or (0, n)
        if not first <= k < first + count:
            raise ValueError(f"a changing-resolution window must hold step {k}, got {self.step_window}")
        end = min(n, first + count)
        enable_cfg = bool(cfg.get("enable_cfg", True))
        guide = float(cfg.get("sample_guide_scale", 5.0))
        attn = cfg.get("attention_impl") or cfg.get("self_attn_1_type", "flash_attn3")
        teo = encoder_out["text_encoder_output"]
        ctx, ctx_null = teo["context"], teo["context_null"] if enable_cfg else None
        lat_gen, noise_gen = self._generators(1)
        kw = dict(enable_cfg=enable_cfg, guide_scale=guide, mm_type=self.mm_type, self_attn_type=attn,
                  cross_attn_type=attn, device=self.device)
        on_step, ends = self._step_timer()
        t0 = time.perf_counter()

        # phase A: steps first..k-1 at low resolution
        sched_a = self.scheduler = self.scheduler_cls(cfg)
        state = self._prepare(sched_a, low, lat_gen, first)
        state = make_denoise_fn(self.arch, sched_a, low, num_steps=k - first, **kw)(
            self.model, state, ctx, on_step=on_step, context_null=ctx_null)

        # step k: a low-resolution forward, x0 prediction, trilinear resize, re-noise
        cos, sin, _ = rope_for_shape(self.arch, low, device=self.device)
        lat, t = sched_a.step_pre(state)
        fkw = dict(mm_type=self.mm_type, self_attn_type=attn, cross_attn_type=attn)
        if enable_cfg:
            pred = wan_forward_cfg(self.model, lat[None], t, ctx, ctx_null, guide, cos, sin, self.arch, **fkw)[0]
        else:
            pred = wan_forward(self.model, lat[None], t, ctx, cos, sin, self.arch, **fkw)[0]
        sig_k = float(sched_a.sigmas[k])
        clean = resize_trilinear(state["latents"].float() - sig_k * pred.float(), target[1:])
        del state, pred
        if renoise is None:
            renoise = torch.randn(target, generator=noise_gen, dtype=torch.float32, device=noise_gen.device)
        noisy = (1.0 - sig_k) * clean + sig_k * renoise.to(self.device)
        del clean
        on_step(k)

        # phase B: steps k+1..end-1 at full resolution, shift + 2, a fresh multistep history
        sched_b = self.scheduler = self.scheduler_cls(cfg)
        seed_b = torch.Generator(device=lat_gen.device).manual_seed(int(cfg.get("seed", 42)) + 1)
        state = self._prepare(sched_b, target, seed_b, k + 1, shift=float(cfg.sample_shift) + 2.0)
        state["latents"] = noisy
        state = make_denoise_fn(self.arch, sched_b, target, num_steps=end - (k + 1), **kw)(
            self.model, state, ctx, on_step=on_step, context_null=ctx_null)
        self.timings["step_s"] = list(np.diff([t0] + ends))
        self.timings["calc_steps"] = [True] * len(ends)
        self.timings["step_index"] = list(range(first, end))
        return state["latents"]

    def _self_attn_setup(self):
        """(self_attn_type, cross_attn_type, self_attn_kwargs) from the
        config. ``sparge`` turns the self-attention into Sparge (keep ratio,
        l1, superblocks), with per-layer l1 from ``sparge_l1_per_layer`` or
        the ``l1`` array of the ``sparge_ckpt`` table; the table's leading
        run of failed layers (``passed``) runs dense unless
        ``sparge_dense_prefix`` says otherwise. Cross-attention stays flash."""
        cfg = self.config
        attn = cfg.get("attention_impl") or cfg.get("self_attn_1_type", "flash_attn3")
        if cfg.get("sparge"):
            attn = "sparge"
        cross_attn = cfg.get("cross_attn_1_type", attn)
        if cross_attn in ("radial_attn", "sparge"):
            cross_attn = "flash_attn3"
        if attn != "sparge":
            return attn, cross_attn, None
        kw = {"keep_ratio": float(cfg.get("sparge_keep_ratio", 0.3)), "l1": float(cfg.get("sparge_l1", 0.07)),
              "block_q": int(cfg.get("sparse_block_q", 2048)), "block_k": int(cfg.get("sparse_block_k", 1024))}
        per_layer = cfg.get("sparge_l1_per_layer")
        passed = None
        if not per_layer and cfg.get("sparge_ckpt"):
            table = np.load(cfg["sparge_ckpt"])
            per_layer = table["l1"]
            if "passed" in table:
                passed = np.asarray(table["passed"], bool)
        if per_layer is not None:
            per_layer = [float(x) for x in per_layer]
            if len(per_layer) != self.arch.num_layers:
                raise ValueError(f"sparge l1 table has {len(per_layer)} entries, model has "
                                 f"{self.arch.num_layers} layers")
            kw["l1_per_layer"] = per_layer
        dense_prefix = cfg.get("sparge_dense_prefix")
        if dense_prefix is None and passed is not None:
            # the leading run of failed layers
            dense_prefix = int(np.argmax(passed)) if passed.any() else len(passed)
            if not passed[dense_prefix:].all():
                logger.warning("sparge table has non-leading failed layers; only a leading dense prefix is "
                               "supported, mid-stack failures run at their table l1")
        if dense_prefix:
            kw["dense_prefix"] = int(dense_prefix)
        return attn, cross_attn, kw

    def _crop_to_request(self, frames: np.ndarray) -> np.ndarray:
        crop = self.config.get("crop_output")
        if not crop:
            return frames
        f, h, w = crop
        oh, ow = frames.shape[1], frames.shape[2]
        y0, x0 = max(0, (oh - h) // 2), max(0, (ow - w) // 2)
        return frames[:f, y0:y0 + h, x0:x0 + w]

    def run_vae_decoder(self, latents) -> np.ndarray:
        if self.config.get("tiny_vae"):  # use_tiling_vae does not apply, as in the JAX runner
            frames = tiny_decode_wan_latents(self.vae, latents, chunk=TINY_VAE_CHUNK)
            return self._crop_to_request(frames.clamp(-1.0, 1.0).cpu().numpy())
        z = latents.permute(1, 2, 3, 0)[None]  # (C, F, H, W) -> (1, F, H, W, C)
        scale = not self.config.get("synthetic_weights")
        chunk = int(self.config.get("vae_decode_chunk", 4))
        if self.config.get("parallel_vae") and self.mesh is not None:
            frames = parallel_vae_decode(self.vae, z, self.vae_cfg, self.mesh, scale=scale, chunk=chunk)
        else:
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
