#!/usr/bin/env python3
"""Smoke test of lightx2v_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                 # build, kernel phases, every path
    python3 chip_smoke.py --kernels-only  # build and kernel phases only
    python3 chip_smoke.py --profile out/  # and a profiled run of each path
    python3 chip_smoke.py --kernels-only --kernel int4_matmul  # one kernel's phase
    python3 chip_smoke.py --path base     # the kernel phases and one path
    python3 chip_smoke.py --path fp8_distill   # the kernel phases and the fp8 path
    python3 chip_smoke.py --path i2v      # the kernel phases and the i2v path
    python3 chip_smoke.py --path cogvideox   # the kernel phases and the CogVideoX path
    python3 chip_smoke.py --path hunyuan     # the kernel phases and the HunyuanVideo path (from files)
    python3 chip_smoke.py --kernel flash_attention --path audio_encoder   # the wav2vec-class audio encoders
    python3 chip_smoke.py --path tea_fp8 --path changing_resolution   # caching, changing resolution
    python3 chip_smoke.py --path offload_stream_fp8 --path offload_lazy_i2v   # the offload tiers
    python3 chip_smoke.py --path offload_stream_tea --path offload_lazy_t2v_tiny   # offload x caching, lightx2v_6*
    python3 chip_smoke.py --kernel flash_attention --path causvid --path skyreels_df --path audio   # the other runners
    python3 chip_smoke.py --kernel rope_rotate --path serve   # slice 1, then its runner behind the HTTP server
    python3 chip_smoke.py --kernel w8a8_matmul_fullk --path hunyuan_quant --path cogvideox_quant   # quantized DiTs
    python3 chip_smoke.py --kernel flash_attention --path hunyuan_i2v_tea --path vae_encoders   # i2v Tea, encoders
    python3 chip_smoke.py --kernel rope_rotate --path quant_schemes --path ptq   # the PTQ loop and the schemes
    python3 chip_smoke.py --kernel flash_attention --path dist   # dist_ranks, then the config under torchrun

1. Prints the card's name and power limit, builds every CUDA kernel of the
   port from ``lightx2v_tpu_torch/csrc`` (one nvcc per source, in parallel)
   and prints the build seconds.
2. Kernel phase: each kernel runs at the shapes of the Wan2.1-T2V-14B 480P
   main paths, is held against its plain PyTorch version on the same inputs
   (bars below), and is timed with CUDA events beside its plain version,
   one PyTorch library call computing the same function where there is one
   (a yardstick only: the port never calls it), and its bound on this card.
3. Slice 1: one full-width int8 DiT block on a small input against the
   plain versions on the CPU; then the port's ``WanDistillRunner`` on
   ``configs/deploy/wan_t2v.json`` with synthetic weights made on the card
   (14B int8 DiT, 40 blocks; bf16 UMT5-XXL; full Wan VAE): T5 encode ->
   distill denoise, cut to the first of its 4 steps (``SLICE_STEPS``, the
   time limit's cut: 2 from the dist path until the hunyuan path read its
   files; flagship and offload_stream_fp8 too) -> tiled VAE decode of
   81x480x832.
   Serve (``serve``, after slice 1 and on its runner; ``--path serve``
   runs slice 1 first): ``server/service.py`` and ``server/api.py`` on
   127.0.0.1, driven with ``urllib``: request 1 (slice 1's prompt and seed)
   completes with slice 1's frames bit for bit; request 2, submitted while
   request 1 runs, is stopped while pending; request 3 (another seed) is
   stopped once processing and ends at the next stage boundary with no
   decode and no file; request 4 (another seed and prompt) completes, its
   file (cv2's where cv2 imports, else the PIL MJPEG writer's) downloads
   byte for byte and its first frame decodes to 832 x 480, and its frames
   written by the PIL MJPEG writer parse back; the metrics count 2
   completed and 2 stopped. The runner keeps its modules resident. The launch counts are slice 1's
   times the requests whose DiT ran; the line gives each request's seconds
   from submit to its final status, queue wait, stage seconds, save seconds
   and peak memory, and request 3's stop latency.
4. Flagship (slice 2): one full-width w4a8 block the same way; then the
   runner on the same config with the bench flagship's overrides (w4a8 DiT
   linears, Sparge self-attention with the tuned per-layer table and its
   dense layer 0, int8 UMT5-XXL, untiled decode).

5. Base (slice 3, this script's main path): one full-width block with
   weight-only int4 linears and sage self-attention the same way; then the
   port's ``WanRunner`` (``wan2.1``) on ``configs/bench/lightx2v_1.json`` at
   the 14B widths with ``W-int4-group-sym-A-bf16-Tpu`` linears: bf16
   UMT5-XXL on the prompt and the negative prompt -> UniPC with
   classifier-free guidance as one forward at batch 2, cut to a 1-step
   schedule (the file's 40 would take minutes; the time limit's cut, from 3
   steps, which ran both corrector orders, then 2, then 1 since the dist
   path) -> untiled decode.
6. Radial: the slice-1 config with ``radial_attn`` self-attention and a
   1-entry step list (2 until the dist path's cuts), once in the block-sparse execution (128 x 128 blocks)
   and once in ``two_pass`` (query tiles of min(sparse_block_q, 256) rows,
   so ``sparse_block_q`` 256 gives the plan's 195-row tiles).
7. fp8 distill (slice 4): one full-width fp8 block the same way; then the
   distill runner on ``configs/bench/lightx2v_3_distill.json`` (the
   reference's LightX2V_3-Distill row: fp8 e4m3 DiT linears, fused-RoPE
   flash, its distill steps, tiled decode) at the 14B widths with the fp8
   UMT5-XXL (``t5_quantized``, ``t5_quant_scheme: "fp8"``). Cut: the first
   ``FP8_STEPS`` of its 4 steps (the time limit's cut).
8. i2v: one full-width int8 i2v block (36 input channels, the image
   cross-attention over 257 CLIP tokens) the same way; the full-width CLIP
   ViT-H/14 tower, bf16 and int8, on the card vs the CPU; the full Wan
   VAE's encode of 5 frames of 64 x 64 on the card vs the CPU; then the
   distill runner on ``configs/deploy/wan_i2v.json`` as it is (Wan2.1-I2V-14B
   widths, int8 DiT, fused-RoPE flash) with a seeded 480 x 832 PNG: bf16
   UMT5-XXL -> area resize (the identity at this size) -> CLIP tower on the
   card (bicubic 224 x 224) -> VAE encode of [image, 80 zero frames] ->
   distill denoise with the image cross-attention, cut to its first of 4
   steps (2 until the hunyuan path read its files) -> tiled decode. Its line gives the encode's parts (T5, CLIP, VAE encode) and the stage
   that set the peak device memory.
9. CogVideoX (slice 6): one full-width CogVideoX1.5-5B block (48 heads of
   64, dim 3072) on a small input the same way; the full CogVideoX VAE's
   frame-batched decode of 3 and 5 x 4 x 6 latents on the card vs the CPU; then
   the port's ``CogvideoxRunner`` on ``configs/cogvideox_t2v.json`` as it is
   (42 joint blocks at full width, 768 x 1360, 81 frames, 45,106 tokens an
   attention call, CFG as one forward at batch 2 at scale 6): bf16 T5
   v1.1-XXL on the prompt and the negative prompt -> XDPM -> tiled,
   frame-batched decode. Cut: the first of the file's 50 XDPM steps (the
   first-order update; the time limit's cut, from 2, which also ran the
   second-order one: tests/test_torch_cogvideox.py runs 50 on the CPU).
10. HunyuanVideo (slice 9): one full-width double-stream and one
   single-stream block (hidden 3072, 24 heads of 128) on a small input (2 x
   8 x 8 latents, 32 text tokens of which 20 are valid) the same way; the
   full Hunyuan VAE's decode of 3 x 4 x 6 latents on the card vs the CPU;
   then the path from files (``run_hunyuan_from_files``): a full-width
   model directory in the reference's layout written from the device
   synthesizers into a temporary directory (~45 GB; the temp directory or
   ``build/``, whichever has room, else it fails): the DiT's
   ``mp_rank_00_model_states.pt``, the VAE's ``pytorch_model.pt``, an HF
   ``LlamaForCausalLM`` directory in 5 GB shards with its index (32 blocks,
   the final norm and ``lm_head``: the reader must skip the last 2 blocks,
   the norm and the head) and an HF ``CLIPTextModel`` directory; then the
   port's ``HunyuanRunner`` on ``configs/hunyuan_t2v.json`` as it is with
   ``model_path`` and ``text_encoder_path`` on it and no
   ``synthetic_weights`` (``HunyuanArch()``: 20 double and 40 single
   blocks, 720 x 1280, 85 frames, 79,200 image tokens + 256 text tokens an
   attention call, embedded guidance 6, no CFG): every loaded tensor equal
   to the synthesized one (checksums taken at write time), the bf16
   llava-llama-3-8b-class encoder (30 of 32 blocks) and CLIP-L text tower
   behind the synthetic tokenizers (the card machine has no
   ``transformers``: a test double this script sets) -> flow-match Euler ->
   the temporally and spatially tiled decode to 85 x 720 x 1280. Cut: the
   first of the file's 50 Euler steps (``hunyuan_i2v_tea`` runs the same
   forward). Its line gives the write seconds and GB/s per component, the
   load seconds and read GB/s per part, the Llama and CLIP seconds and the
   joint attention's ``kv_len``.
11. Feature caching: first the caching steps at the 1.3B width on a small
   input, card vs CPU (TaylorSeer's calc and skip, a one-sided per-side Tea
   step); then the ``wan2.1`` runner on each config as it is, at the widths
   it names or else Wan2.1-T2V-1.3B's: ``tea_fp8`` (``configs/bench/
   lightx2v_4.json`` at 14B: TeaCache on fp8 W8A8, CFG at 5 with per-side
   decisions, 40 UniPC steps, tiled decode), ``taylorseer_1_3b``,
   ``taylorws_1_3b``, ``ada_1_3b`` and ``custom_1_3b``
   (``configs/caching/*``). Cuts, through the runner's ``step_window`` so
   that every decision sees the file's step count: Tea and Custom a window
   of 4 and 2 steps that starts at a calc step and holds a skip step of the
   full-schedule host replay (printed first as a ``tea_series`` line with
   its calc count), the Taylor pattern's first 6 steps, Ada's first 4. A
   skip step launches no kernel: the counts are those of the forwards that
   computed (a one-sided per-side forward is one at batch 1), the calc
   entries must equal the plan's (Ada's codebook chooses its own), and each
   cut must hold a calc and a skip step. The path line gives the calc and
   skip steps' times apart.
12. Changing resolution (``configs/changing_resolution/wan_t2v.json`` at
   14B as it is: bf16 ``Default`` linears, CFG at 6, 50 steps switching at
   step 25 from 16 x 21 x 44 x 78 latents (18,018 tokens) to the full 32,760).
   Cut: steps 24 (phase A), 25 (the low-resolution forward, x0, trilinear
   resize, re-noise) and 26 (phase B, a fresh UniPC at shift 10), each at
   the file's timestep: three forwards.
13. Offload, host-RAM tier (``offload_stream_fp8``):
   ``configs/bench/lightx2v_5_distill.json`` as it is at the 14B widths (fp8
   W8A8, dense flash self-attention with RoPE in torch, no CFG, its 4
   distill steps, ``weight_streaming``): the fp8 DiT is made on the card,
   packed block by block into pinned host memory, and streamed through two
   device slots on a copy stream each step.
14. Offload, disk tier (``offload_lazy_i2v``):
   ``configs/offload/wan_i2v_disk_lazy_480p.json`` as it is, with
   ``dit_quantized_ckpt``, ``model_path`` and ``image_path`` pointed at
   files the script writes (about 29 GB, in the system temp directory or
   the repo's ``build/``, whichever has room; else the DiT's depth is cut
   to what fits, full width kept, and printed): the full-width i2v DiT made
   as a reference-key bf16 dict on the card, a rank-32 LoRA over every
   block linear folded in by the converter, int8 on the card, the blocks
   layout; the bf16 UMT5-XXL, CLIP and VAE ``.pth`` files. Every file is
   fsynced and its pages dropped (``posix_fadvise``), and each block file's
   again after each read, so every step reads its blocks from the disk.
   The runner loads from those files (the T5 quantized to int8 at load),
   with the synthetic tokenizer set on its encoder, and runs the first of
   the file's 40 UniPC steps (CFG at batch 2, sage, int8; 2 until the
   hunyuan path read its files) through its step window; the directory is
   deleted afterwards.
   Before each of the two paths' counted runs, the step-0 prediction of the
   offloaded forward is held bit for bit against the resident forward on
   the same weights and inputs. Their lines add the load seconds per
   component, stall ms, H2D and disk GB/s per step, the peak device memory
   after each stage, the host's available RAM and peak RSS (``VmHWM``), and
   the pinned GB.
15. Offload with feature caching (``offload_stream_tea``):
   ``configs/bench/lightx2v_4.json`` (Tea 0.2, fp8, CFG at 5) with
   ``cpu_offload`` and ``weight_streaming``: lightx2v_5's tier under
   lightx2v_4's cache, Tea deciding once for the CFG batch. Cut: a 3-step
   window of the host Tea series holding a calc and a skip step. Gates: the
   step-0 streamed prediction bit for bit the resident one; a skip step
   copies 0 block bytes (and the staged bf16 residual in), a calc step the
   40 blocks.
16. The low-memory tier (``offload_lazy_t2v_tiny``,
   ``offload_lazy_t2v_cfg_tiny``): ``configs/bench/lightx2v_6_distill.json``
   as it is (int8, ``lazy_load`` with 2 disk workers and a 4 GB pool, RoPE
   in torch, 1 of its 4 distill steps since the hunyuan path read its files, the tiny VAE) and
   ``lightx2v_6.json`` (UniPC,
   CFG at batch 2; cut to 1 of its 40 steps, 2 until the dist path's cuts), from files the script writes
   beside the lazy i2v path's (the t2v int8 DiT in the blocks layout, the
   bf16 UMT5-XXL ``.pth``, shared, and a ``taew2_1.pth`` read through the
   tiny VAE's converter). The distill path holds its step-0 prediction bit
   for bit against the resident forward; both time the tiny decode alone
   with its device peak and hold its first 2 latent frames (a 240 x 416
   corner) on the card against the CPU. Before them, the ``vae_int8`` phase:
   the full Wan VAE's tiled decode of a 16 x 21 x 60 x 104 latent with the
   int8 decoder against the float one (times, SNR > 15 dB).
17. CausVid (``causvid``): ``configs/wan_t2v_causvid.json`` at the 14B
   widths (bf16 ``Default`` linears) with ``sample_shift`` 5, which the
   file does not name, cut to 2 of its 3 fragments and to the first entry
   of its 9-step distill list (every other one until the dist path's cuts):
   3 AR blocks of 7 latent frames (10,920 tokens) a fragment against a
   21-frame (32,760-slot, 26.8 GB) bf16 KV cache, 1 distill step a block,
   the second fragment's first block re-anchored: 5 block forwards and 1
   re-anchor; the decode of 35 latent
   frames (137 x 480 x 832). Its line adds each AR block's and re-anchor's seconds, the
   cache's GB, and the device memory in use when the denoise starts (the T5
   released).
18. SkyReels-V2-DF (``skyreels_df``): ``configs/wan_skyreels_v2_df.json``
   at the 14B widths: 544 x 960, 97 frames (25 latent frames, 51,000
   tokens), CFG at 6 at batch 2, one timestep per latent frame. Cut: the
   first of its 30 timestep-matrix rows (one segment: no re-encode; the
   time limit's cut, from 2).
19. Audio-driven i2v (``audio``): ``configs/audio_driven/wan_i2v_audio.json``
   at the i2v 14B widths with a seeded PNG and a seeded 16 kHz wav of
   157,000 samples: 157 frames, two 81-frame segments, each cut to the
   first of its 4 Euler steps, the second conditioned on the VAE latents of the first's last 5 frames,
   the audio adapter's 40 fp32 injections (synthetic, made on the card),
   radial_attn without a mask (dense flash); the frames and the stitched
   audio muxed into an ``.av.mp4`` (PIL JPEGs, PCM16) and parsed back.
   The audio encoder (``audio_encoder``, a phase after ``audio``): a
   wavlm-base-plus-width (768 wide, 12 layers) and a hubert-large-width
   (1024 wide, 24 layers, in an ``audio_encoder/`` subfolder) HF directory
   written from the device synthesizer; ``AudioEncoder(path)`` on the card
   in fp32 on the audio config's 81-frame window of a seeded wav, held
   against the same function on the CPU (max abs difference below 1e-5 of
   the features' max abs), timed.
20. HunyuanVideo i2v with TeaCache (``hunyuan_i2v_tea``):
   ``configs/hunyuan_t2v.json`` with ``task: "i2v"``, 193 frames at 480 x
   832 (49 x 30 x 52 = 76,440 image tokens + 256 text), ``feature_caching:
   "Tea"`` at ``teacache_thresh`` 0.2, full width (the Llama and CLIP-L
   synthesizers): token replace on the first latent frame's 1,560 tokens
   and RIFLEx k = 4 (both checked), the host Tea series over the 50 steps
   (printed), then a 4-step window of it holding its calc and skip steps,
   and the tiled decode of the 49 latent frames to 193 x 480 x 832. Like
   the JAX runner it encodes no image.
21. The quantized HunyuanVideo DiT (``hunyuan_quant``, ``run_hunyuan_quant``)
   at bench.py's ``run_hunyuan`` shape, after one full-width int8 double +
   single block on the card against the CPU: int8 end to end (1 Euler
   step since the dist path, 2 before; the tiled decode), fp8, weight-only int4 (row 11) and int4 x int8
   (row 8) one forward each, each scheme's weights made and released in
   turn, each with exact launch counts.
22. The quantized CogVideoX1.5-5B DiT (``cogvideox_quant``): one CFG forward
   at batch 2 at bench.py's 480p shape at int8 and at fp8, after one
   full-width int8 block on the card against the CPU; exact launch counts
   of rows 3 / 3f and 2d.
23. The VAE encoders (``vae_encoders``): HunyuanVideo's and CogVideoX's at
   their published configs on a seeded 17 x 480 x 832 clip, timed with
   their device peaks, and a 5 x 64 x 64 corner of it encoded on the card
   against the CPU.
24. The quant schemes (``quant_schemes``, a phase): one full-width block
   each at ``fp8_block128``, ``mxfp8`` and ``mxfp6`` (the synthesizer's
   layouts) on the card against the CPU plain version, then each scheme's
   linear at (32,760, 5120 -> 5120) timed beside row 3f on the same weights.
25. The post-training-quantization loop (``ptq``, ``run_ptq``) on
   ``configs/deploy/wan_t2v.json`` at the 14B widths, on a reference-key
   bf16 dict made on the card: the runner with mm_type ``Default`` and
   ``do_mm_calib`` calibrates at the first timestep (an empty step window:
   400 stats, launches of rows 1 / 1r / 2 counted exactly); block 0 folded
   against unfolded in bf16 (the fold-transparency gate); int8 of the
   unsmoothed dict, then the fold and int8 block by block; the config as
   it is (int8) on the smoothed dict, cut to 1 of its 4 distill steps and
   the tiled decode, exact launch counts, with the PSNR of its step-0
   prediction against the unsmoothed int8 one printed (no bar: synthetic
   weights); then ``tools/tune_sparge``'s CLI (``--structured --preset
   14b``: 21 x 60 x 104 latents, 40 layers, keep 0.3, the default grid) with
   exact counts of rows 9 and 2 and the table's invariants as a gate.
26. Checkpoint validation: after ``offload_lazy_i2v``, before its DiT
   directory goes, ``tools/validate_ckpt`` on it (two-sided key coverage,
   a 32-token forward on the card under its ``config.json``'s mm_type) and
   on the Wan VAE ``.pth``.
27. Multi-GPU (``dist``, ``run_dist``): ``configs/dist_infer/
   wan_t2v_dist_ulysses.json`` (Ulysses over {"dp": 2, "sp": 4}, parallel
   VAE) at the 14B widths through the user's launcher, ``python -m
   torch.distributed.run --standalone --nproc_per_node 1 -m
   lightx2v_tpu_torch.infer``: one rank on NCCL (the card machine has one
   H100; NCCL refuses two ranks on one device), so the mesh is cut to {"dp":
   1, "sp": 1}, and the schedule to the first of its 50 UniPC steps (CFG at
   batch 2; the time limit's cut). Its latents must equal, bit for bit, those
   of the single-device runner on the same config without ``mesh_shape``,
   run through ``python -m lightx2v_tpu_torch.infer`` after it; only rank 0
   writes the video. Its line gives the rank, world and backend the process
   saw, its stage seconds and peak memory. The arithmetic across ranks is
   held on the CPU (``tests/test_torch_parallel*.py``, gloo). Before it, in
   the kernel phases, ``dist_ranks``: one rank's kernel work of the file's
   own sp = 4 layout at full width (``kernel_phase_dist_ranks``).

The kernel phases also hold and time the fused-RoPE flash kernel at
changing resolution's phase A, (2, 18,018, 40, 128) with a 98-row last
query tile, and rows 3f/4f at tea_fp8's M = 65,520 (``other_shapes``
entries). They print the radial comparison at the main shape (dense
flash, block-sparse at 128 x 128 and 256 x 128, two_pass), hold two merged
half-key partials against one dense call, time the dense flash kernel at the
self-attention shape without RoPE and over i2v's 257 image keys
(``other_shapes`` entries, SDPA their yardstick), the dense kernel's 64-wide
form at CogVideoX's (2, 45,106, 48, 64) (its own row,
``flash_attention_d64``, bound by the larger of its tensor-core and its
exp2 time), the dense kernel at HunyuanVideo's joint stream, (1, 79,456,
24, 128) with the path's ``kv_len`` (a ragged last query tile, a partly
masked last key tile; SDPA on the valid keys its yardstick), at CausVid's
AR block (q of 10,920 against the 32,760-slot cache at kv_len 21,840, V =
1e4 in the stale slots past it, and 32,760) and SkyReels-V2-DF's (2,
51,000, 40, 128), and the 8-bit full-K GEMM
at i2v's M = 257 beside M = 512, and hold the RoPE pass of the fused-RoPE
flash (``rope_rotate``, its own kernel row and counter) bit for bit against
its plain version. Rows 3 and 3f are also held and timed at every quantized
HunyuanVideo and CogVideoX linear's shape (M from 1 to 34,772, K up to
15,360, N up to 21,504: on the card an 8-bit linear of any width runs the
full-K kernel, and ``guard_exact_dot`` makes one that reaches the float64
exact dot raise), rows 11 and 8 at HunyuanVideo's, row 2 at the i2v path's
(1, 76,696, 24, 128) and row 2d at (2, 17,386, 48, 64). The
fp8 rows' library yardstick is the torch quantize pass plus
``torch._scaled_mm`` with row-wise scales; the per-head block-sparse row's is
``torch.compile(flex_attention)`` on the same block mask (None, with the
reason printed, where it does not compile). The 8-bit rows are also timed in
parts (``[parts]`` lines, and keys of their kernel rows): the quantize pass
and the GEMM of rows 3/3f beside the bare ``torch._int_mm`` /
``torch._scaled_mm`` on the same codes, and the FFN's GEMM1 and GEMM2 of
rows 4/4f; row 3f is also held against its plain version on one-signed
inputs at the main shape. The w4a8 rows are timed in parts the same way:
row 8's quantize pass and GEMM, row 7's quantize pass, GEMM1 and GEMM2; their
synthetic weight scales vary by (row, group), so a scale read from the wrong
row or group shows. Row 10 (``sage_attention``) is timed in parts too,
its quantize pass and its attention kernel, beside the port's own bf16
``flash_attention`` on the same q, k, v, and held against its plain version
on one-signed q and k at the main shape.

For each path the launch counters are zeroed just before the run and read
just after, and must equal the path's exact counts. The line before the
last two is ``{"kernels": [...]}``, then the card line, then
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
Without a CUDA device, or without the package beside this file, it exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# dense peaks by card (NVIDIA data sheets): (bf16 FLOP/s, int8 OP/s, bytes/s)
PEAKS = {
    "H100 PCIe": (756e12, 1513e12, 2.0e12),
    "H100 NVL": (835e12, 1671e12, 3.9e12),
    "H100": (989e12, 1979e12, 3.35e12),  # SXM
}

# main-path shapes: latents 16x21x60x104 -> 32,760 tokens, 40 heads of 128
S, HEADS, HD, DIM, FFN, TXT = 32760, 40, 128, 5120, 13824, 512
IMG = 257  # i2v image context: the CLIP tower's cls + 16 x 16 patch tokens
T5_DIM, T5_FFN = 4096, 10240  # UMT5-XXL
GROUP = 512  # int4 quant group along in-features at these widths
REPS = 5  # timed calls per kernel (CUDA-event median)
INT4A8 = "W-int4-group-sym-A-int8-token-dynamic-Tpu"
INT4W = "W-int4-group-sym-A-bf16-Tpu"
INT8 = "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"
FP8 = "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Tpu"
FRAMES = 21  # latent frames of 1560 tokens
# CogVideoX1.5-5B at 768x1360, 81 frames: 11 x 48 x 85 video tokens (21 latent frames padded to 22) + 226 text
COG_S, COG_HEADS, COG_HD = 11 * 48 * 85 + 226, 48, 64
# exp2 a second on the special-function units: 16 a clock on each of 132 SMs at the 1,980 MHz boost clock
PEAK_EX2 = 16 * 132 * 1.98e9
COG_JSON = "configs/cogvideox_t2v.json"
COG_STEPS = 1  # of the file's 50: step 0, first-order (the time limit's cut)
# HunyuanVideo at 720x1280, 85 frames: 22 x 45 x 80 image tokens + 256 text tokens, 24 heads of 128
HY_IMG, HY_TXT, HY_HEADS = 22 * 45 * 80, 256, 24
HY_JSON = "configs/hunyuan_t2v.json"
HY_STEPS = 1  # of the file's 50 Euler steps (hunyuan_i2v_tea runs the same forward)
HY_FILES_GB = 48.0  # disk the hunyuan path's files take (~44.6 GB: DiT 25.4, Llama with lm_head 16.9, VAE, CLIP-L)
HY_SHARD_GB = 5.0  # the Llama directory's shard size, as HF's save_pretrained default
# HunyuanVideo i2v with TeaCache: 193 frames at 480 x 832 (49 x 30 x 52 = 76,440 image tokens; RIFLEx past 192
# frames), a 4-step window of the host Tea series holding its calc and skip steps
HY_I2V = dict(hidden_size=3072, task="i2v", target_video_length=193, target_height=480, target_width=832,
              feature_caching="Tea", teacache_thresh=0.2)
HY_I2V_IMG = 49 * 30 * 52
HY_I2V_CUT = ("tea", 4)
# bench.py's run_hunyuan and run_cogvideox shape: 21 x 60 x 104 latents; Hunyuan 32,760 image + 256 text tokens,
# CogVideoX (frames padded to 22) 17,160 video + 226 text tokens, CFG's batch of 2
BENCH_LAT = (16, 21, 60, 104)
HY_Q_IMG, HY_Q_TXT = 21 * 30 * 52, 256
COG_Q_S = 11 * 30 * 52 + 226
HY_SCHEMES = (("int8", INT8), ("fp8", FP8), ("int4", INT4W), ("int4a8", INT4A8))
HY_Q_STEPS = 1  # int8's Euler steps (a 1-step schedule, shift 7; 2 until the dist path's cuts) before the tiled decode
# the VAE encoders' clip: 17 frames of 480 x 832 -> 5 x 60 x 104 latents; the corner held against the CPU
ENC_FRAMES, ENC_CORNER = 17, (5, 64, 64)
# CausVid (configs/wan_t2v_causvid.json): AR blocks of 7 latent frames of 1560 tokens, a window of 21 frames
CV_JSON = "configs/wan_t2v_causvid.json"
CV_FRAGMENTS = 2  # of the file's 3: 5 AR blocks and one re-anchor (the time limit's cut)
CV_STEP_STRIDE = 9  # the first entry of the file's 9-step denoising list: 1 step a block (the same cut)
CV_BLOCK_TOKENS, CV_WINDOW = 7 * 1560, 21 * 1560
# SkyReels-V2-DF (configs/wan_skyreels_v2_df.json): 544x960, 97 frames -> 25 latent frames of 34 x 60 tokens
DF_JSON = "configs/wan_skyreels_v2_df.json"
DF_TOKENS = 25 * 34 * 60
DF_ROWS = 1  # of the matrix's 30 rows (one segment: 30 UniPC steps; the time limit's cut)
# audio-driven i2v (configs/audio_driven/wan_i2v_audio.json): a 16 kHz mono wav of 157,000 samples is 157 frames at
# 16 fps, two 81-frame segments overlapping by 5
AUDIO_JSON = "configs/audio_driven/wan_i2v_audio.json"
AUDIO_SAMPLES = 157_000
AUDIO_STEPS = 1  # of each segment's 4 Euler steps (the time limit's cut)
PROMPT = "a red panda climbing a bamboo tree in the rain"
DEPLOY_JSON = "configs/deploy/wan_t2v.json"
BASE_JSON = "configs/bench/lightx2v_1.json"
FP8_JSON = "configs/bench/lightx2v_3_distill.json"
I2V_JSON = "configs/deploy/wan_i2v.json"
# the bench flagship: the deploy config plus these overrides
FLAGSHIP = dict(mm_config={"mm_type": INT4A8}, sparge=True, sparge_keep_ratio=0.3,
                sparge_ckpt=str(ROOT / "configs/sparge/wan_t2v_14b_structured_keep03.npz"),
                sparse_block_q=2048, sparse_block_k=1024, t5_quantized=True, use_tiling_vae=False)
WAN14B = dict(dim=DIM, ffn_dim=FFN, num_heads=HEADS, num_layers=40, text_len=TXT)
NEG = "blurry, low quality, distorted, static frame"
# the base model: the upstream baseline bench config at the 14B widths, weight-only int4, a 1-step schedule for its 40
BASE = dict(WAN14B, mm_config={"mm_type": INT4W}, infer_steps=1, negative_prompt=NEG)
# radial attention on the slice-1 config, one step, in its two executions
RADIAL_BSR = dict(self_attn_1_type="radial_attn", sparse_block_q=128, sparse_block_k=128,
                  denoising_step_list=[1000], radial_sparsity_type="bsr")
RADIAL_TWO_PASS = dict(RADIAL_BSR, sparse_block_q=256, radial_sparsity_type="two_pass")
# the reference's LightX2V_3-Distill row (fp8 DiT, fused-RoPE flash, its 4 distill steps, tiled decode) at the
# 14B widths, with the fp8 UMT5-XXL
FP8_DISTILL = dict(WAN14B, t5_quantized=True, t5_quant_scheme="fp8")
FP8_STEPS = 1  # of the file's 4 distill steps (the time limit's cut; 2 until the hunyuan path read its files)
I2V_STEPS = 1  # of configs/deploy/wan_i2v.json's 4 distill steps (the same cut)
# slice 1, serve (on slice 1's runner), flagship and offload_stream_fp8: the first of their 4 distill steps (the time
# limit's cut; 2 from the dist path until the hunyuan path read its files)
SLICE_STEPS = 1
TEA_JSON = "configs/bench/lightx2v_4.json"
CR_JSON = "configs/changing_resolution/wan_t2v.json"
# Wan2.1-T2V-1.3B (PRESETS["wan2.1_1.3b"]) for the configs/caching files that name no width
WAN1_3B = dict(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30, text_len=TXT)
# the cached paths: (config file, widths, how its cut is planned, steps in the cut); the cuts run through the
# runner's step_window, so every caching decision sees the file's step count. Custom's use_ret_steps warm-up
# computes steps 0-4, so its 2-step window is steps 4-5, a calc and a skip (steps 0-6 until the hunyuan path read its
# files); the Taylor pattern is calc, skip, skip, skip, calc, skip.
CACHED = {
    "tea_fp8": (TEA_JSON, WAN14B, "tea", 4),
    "taylorseer_1_3b": ("configs/caching/taylorseer/wan_t2v_taylorseer.json", WAN1_3B, "taylor", 6),
    "taylorws_1_3b": ("configs/caching/taylorws/wan_t2v_taylorws.json", WAN1_3B, "taylor", 6),
    "ada_1_3b": ("configs/caching/adacache/wan_t2v_ada.json", WAN1_3B, "ada", 4),
    "custom_1_3b": ("configs/caching/custom/wan_t2v_custom_1_3b.json", WAN1_3B, "tea", 2),
}
# the offload tiers: the host-RAM tier on the reference's LightX2V_5-Distill row (fp8, weight streaming) and the
# disk tier on the lazy i2v config, run from checkpoint files this script writes (about 29 GB at 40 blocks)
STREAM_JSON = "configs/bench/lightx2v_5_distill.json"
LAZY_JSON = "configs/offload/wan_i2v_disk_lazy_480p.json"
LAZY_STEPS = 1  # of the file's 40 UniPC steps (2 until the hunyuan path read its files)
LORA_RANK = 32
# the low-memory rows of the bench ladder on the disk tier (int8, 2 workers, a 4 GB pool, the tiny VAE), from a
# t2v blocks checkpoint and a taew2_1-style .pth this script writes; lightx2v_6 cut to 1 of its 40 UniPC steps
LAZY_T2V = {"offload_lazy_t2v_tiny": ("configs/bench/lightx2v_6_distill.json", "wan2.1_distill", 1),
            "offload_lazy_t2v_cfg_tiny": ("configs/bench/lightx2v_6.json", "wan2.1", 1)}
# lightx2v_4 (Tea 0.2, fp8, CFG at 5) on the host-RAM tier: a window of its host Tea series (one decision for the
# CFG batch under offload) holding a calc and a skip step
STREAM_TEA = (TEA_JSON, "tea", 3)
TINY_CHECK_FRAMES = 2  # latent frames of the lazy t2v path's latents decoded on the CPU against the card
SERVE_PROMPT = "a paper boat drifting down a flooded street at dusk"
SERVE_WAIT = 300  # seconds: the longest any one wait of the serve path may take
# the post-training-quantization loop (calibrate, fold, int8, run, tune) on the deploy config at the 14B widths
PTQ_STEPS = 1  # of the config's 4 distill steps (2 until the dist path's cuts)
BLOCK128 = "W-fp8-block128-sym-A-fp8-channel-group128-sym-dynamic-Tpu"
# the schemes phase: (scheme, mm_type, the block gate's bar); e4m3 activations at the fp8 block's bar
SCHEMES_PHASE = (("fp8_block128", BLOCK128, 6e-2), ("mxfp8", "W-mxfp8-A-mxfp8-dynamic-Tpu", 6e-2),
                 ("mxfp6", "W-mxfp6-A-mxfp8-dynamic-Tpu", 3e-2))
# multi-GPU (configs/dist_infer/wan_t2v_dist_ulysses.json: mesh {"dp": 2, "sp": 4}, 14B widths, CFG, UniPC): the card
# machine has one H100, so the path runs the config under torchrun as a world of one NCCL rank with the mesh cut to
# {"dp": 1, "sp": 1} and the schedule to its first DIST_STEPS of 50 steps; the dist_ranks phase runs one rank's
# kernel work of the file's own sp = 4 layout at full width
DIST_JSON = "configs/dist_infer/wan_t2v_dist_ulysses.json"
DIST_STEPS = 1
DIST_SP = 4
DIST_PAD = 190  # ring: pad rows at the tail of the last rank's chunk, masked (kv_len 8,000 of its 8,190 keys)
DIST_WAIT = 600  # seconds: the longest either of the path's two processes may take
PATHS = ("slice", "serve", "flagship", "base", "radial_bsr", "radial_two_pass", "fp8_distill", "i2v", "cogvideox",
         "hunyuan", "tea_fp8", "changing_resolution", "taylorseer_1_3b", "taylorws_1_3b", "ada_1_3b", "custom_1_3b",
         "offload_stream_fp8", "offload_lazy_i2v", "offload_stream_tea", "offload_lazy_t2v_tiny",
         "offload_lazy_t2v_cfg_tiny", "causvid", "skyreels_df", "audio", "audio_encoder", "hunyuan_i2v_tea",
         "hunyuan_quant", "cogvideox_quant", "vae_encoders", "quant_schemes", "ptq", "dist")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def peaks_for(name: str):
    for key in ("H100 PCIe", "H100 NVL", "H100"):
        if key in name:
            return PEAKS[key]
    return PEAKS["H100"]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, timed with CUDA
    events around each run."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return float(times[len(times) // 2])


def bound(flops: float, nbytes: float, peak_ops: float, peak_bw: float):
    t_ops, t_bytes = flops / peak_ops, nbytes / peak_bw
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def library(fn, n, make=False):
    """ms of a PyTorch library call (a yardstick only), or None where this
    build lacks it or cannot compile it; the reason is printed. With
    ``make``, ``fn()`` first builds the callable to time."""
    import torch

    try:
        return cuda_ms(fn() if make else fn, n)
    except Exception as e:  # noqa: BLE001 -- a yardstick that does not run is reported, not fatal
        print(f"[library] not timed: {type(e).__name__}: {str(e)[:300]}", flush=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return None


def check_close(name: str, out, ref, rtol: float, atol: float) -> float:
    """max |out - ref|; fails unless it is <= atol + rtol * max |ref|."""
    import torch

    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((out.float() - ref.float()).abs().max())
    lim = atol + rtol * float(ref.float().abs().max())
    print(f"[check] {name}: max_abs_err {err:.3e} (bar {lim:.3e})", flush=True)
    if not err <= lim:
        raise AssertionError(f"{name}: max_abs_err {err} exceeds {lim}")
    return err


def fullk_parts(wm, x, w, ws, b, kind: str, reps: int) -> dict:
    """The full-K 8-bit GEMM's two kernels timed apart, the quantize pass
    and the GEMM on its codes, beside the bare PyTorch GEMM on the same
    codes (a yardstick for the GEMM alone): ``torch._int_mm`` (int32 out, no
    scaling) or ``torch._scaled_mm`` with row-wise scales, bf16 out,
    ``use_fast_accum=False``."""
    import torch

    lib, stream = wm._lib(), torch.cuda.current_stream().cuda_stream
    (m, k), n = x.shape, w.shape[0]
    quant_ms = cuda_ms(lambda: wm._quant(lib, x, k, kind, stream), reps)
    xq, xs = wm._quant(lib, x, k, kind, stream)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    gemm_ms = cuda_ms(lambda: wm._gemm(lib, xq, w, xs, 1, k, ws, b, out, m, n, k, None, kind, stream, "gemm"), reps)
    if kind == "int8":
        call = "torch._int_mm (int32 out)"
        lib_ms = library(lambda: torch._int_mm(xq, w.t()), reps)
    else:
        call = "torch._scaled_mm (row-wise scales, bf16 out, use_fast_accum=False)"
        sa, sb = xs.contiguous(), ws[None, :].contiguous()
        lib_ms = library(lambda: torch._scaled_mm(xq, w.t(), scale_a=sa, scale_b=sb, out_dtype=torch.bfloat16,
                                                  use_fast_accum=False), reps)
    parts = dict(quantize_ms=quant_ms, gemm_ms=gemm_ms, library_gemm_ms=lib_ms, library_gemm_call=call)
    print(f"[parts] 8-bit full-K {kind} M={m}: {json.dumps(parts)}", flush=True)
    return parts


def ffn_parts(wm, x, w0, s0, b0, w2, s2, b2, kind: str, reps: int) -> dict:
    """The 8-bit FFN's three kernels timed apart: the quantize pass, GEMM1
    (GELU and the hidden requantization in its epilogue) and GEMM2 (the
    grouped GEMM over the hidden's bh groups)."""
    import torch

    from lightx2v_tpu_torch.ops.cuda import _build

    lib, stream = wm._lib(), torch.cuda.current_stream().cuda_stream
    (m, k), h, n = x.shape, w0.shape[0], w2.shape[0]
    bh = wm.pick_bh(h)
    quant_ms = cuda_ms(lambda: wm._quant(lib, x, k, kind, stream), reps)
    xq, xs = wm._quant(lib, x, k, kind, stream)
    hq = torch.empty((m, h), dtype=wm._CODE_DTYPE[kind], device=x.device)
    hs = torch.empty((m, h // bh), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)

    def gemm1():
        _build.check(lib.ffn_w8a8_gemm1(xq.data_ptr(), w0.data_ptr(), xs.data_ptr(), s0.data_ptr(), b0.data_ptr(),
                                        hq.data_ptr(), hs.data_ptr(), m, h, k, bh, int(kind == "fp8"), stream),
                     "ffn gemm1")

    gemm1_ms = cuda_ms(gemm1, reps)
    gemm2_ms = cuda_ms(lambda: wm._gemm(lib, hq, w2, hs, h // bh, bh, s2, b2, out, m, n, h, None, kind, stream,
                                        "ffn gemm2"), reps)
    parts = dict(quantize_ms=quant_ms, gemm1_ms=gemm1_ms, gemm2_ms=gemm2_ms)
    print(f"[parts] 8-bit FFN {kind} M={m}: {json.dumps(parts)}", flush=True)
    return parts


def w4a8_parts(w4, x, w, ws, b, reps: int) -> dict:
    """Row 8's two kernels timed apart: the quantize pass and the GEMM on
    its codes."""
    import torch

    lib, stream = w4._lib(), torch.cuda.current_stream().cuda_stream
    (m, k), n = x.shape, w.shape[0]
    group = k // ws.shape[1]
    quant_ms = cuda_ms(lambda: w4._quant(lib, x, group, stream), reps)
    xq, xs = w4._quant(lib, x, group, stream)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    gemm_ms = cuda_ms(lambda: w4._gemm(lib, xq, w, xs, ws, b, out, group, stream, "gemm"), reps)
    parts = dict(quantize_ms=quant_ms, gemm_ms=gemm_ms)
    print(f"[parts] w4a8 M={m}: {json.dumps(parts)}", flush=True)
    return parts


def ffn_w4a8_parts(w4, x, w0, s0, b0, w2, s2, b2, reps: int) -> dict:
    """Row 7's three kernels timed apart: the quantize pass, GEMM1 (GELU and
    the hidden requantization in its epilogue) and GEMM2 (the GEMM of row 8
    over the hidden's bh groups)."""
    import torch

    lib, stream = w4._lib(), torch.cuda.current_stream().cuda_stream
    (m, k), h, n = x.shape, w0.shape[0], w2.shape[0]
    group, bh = k // s0.shape[1], h // s2.shape[1]
    quant_ms = cuda_ms(lambda: w4._quant(lib, x, group, stream), reps)
    xq, xs = w4._quant(lib, x, group, stream)
    hq = torch.empty((m, h), dtype=torch.int8, device=x.device)
    hs = torch.empty((m, h // bh), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    gemm1_ms = cuda_ms(lambda: w4._gemm1(lib, xq, xs, w0, s0, b0, hq, hs, group, bh, stream), reps)
    gemm2_ms = cuda_ms(lambda: w4._gemm(lib, hq, w2, hs, s2, b2, out, bh, stream, "gemm2"), reps)
    parts = dict(quantize_ms=quant_ms, gemm1_ms=gemm1_ms, gemm2_ms=gemm2_ms)
    print(f"[parts] w4a8 FFN: {json.dumps(parts)}", flush=True)
    return parts


def sage_parts(sa, fa, q, k, v, reps: int) -> dict:
    """Row 10's two kernels timed apart, the quantize pre-pass (q and k) and
    the attention kernel on its codes, beside the port's own bf16 dense
    flash kernel on the same q, k, v (does int8 Q.K^T pay on this card?)."""
    import torch

    lib, stream = sa._lib(), torch.cuda.current_stream().cuda_stream
    quant_ms = cuda_ms(lambda: (sa._quant_rows(lib, q, stream), sa._quant_rows(lib, k, stream)), reps)
    q8, qs = sa._quant_rows(lib, q, stream)
    k8, ks = sa._quant_rows(lib, k, stream)
    attend_ms = cuda_ms(lambda: sa._attend(lib, q8, qs, k8, ks, v, None, stream), reps)
    flash_ms = cuda_ms(lambda: fa.flash_attention(q, k, v), reps)
    parts = dict(quantize_ms=quant_ms, attention_ms=attend_ms, flash_attention_ms=flash_ms)
    print(f"[parts] sage_attention (2, {S}, {HEADS}, {HD}): {json.dumps(parts)}", flush=True)
    return parts


# ---------------------------------------------------------------------------
# kernel phase


def kernel_phase(peaks, reps: int, want):
    import torch
    import torch.nn.functional as F

    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm
    from lightx2v_tpu_torch.ops.rope import apply_rope_half, build_wan_rope_grid

    peak_bf16, peak_int8, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, extra = [], []  # extra: other main-path shapes of a kernel

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    if want("flash_attention_fused_rope") or want("flash_attention") or want("rope_rotate"):
        q = randn(1, S, HEADS, HD)
    # ---- flash attention with fused RoPE (self-attention) ----
    if want("flash_attention_fused_rope"):
        k, v = randn(1, S, HEADS, HD), randn(1, S, HEADS, HD)
        cos_np, sin_np = build_wan_rope_grid(HD, 21, 30, 52)
        cos = torch.from_numpy(cos_np).to(dev)
        sin = torch.from_numpy(sin_np).to(dev)
        out = fa.flash_attention_fused_rope(q, k, v, cos, sin)
        torch.cuda.synchronize()
        hs = slice(0, 2)  # the plain version materializes S x S per head
        ref = fa.flash_attention_fused_rope_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs], cos, sin)
        # bar: bf16 output; P rounded to bf16 at different running maxima
        # (online vs one-pass softmax) and a different summation order
        err = check_close("flash_attention_fused_rope", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref
        ms = cuda_ms(lambda: fa.flash_attention_fused_rope(q, k, v, cos, sin), reps)
        plain_ms = cuda_ms(lambda: fa.flash_attention_fused_rope_plain(q, k, v, cos, sin), 1, warmup=0)

        def lib_rope():
            qr, kr = apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin)
            return F.scaled_dot_product_attention(qr.transpose(1, 2), kr.transpose(1, 2), v.transpose(1, 2))

        lib_ms = cuda_ms(lib_rope, reps)
        b_ms, b_by = bound(4.0 * HEADS * S * S * HD, 4 * S * HEADS * HD * 2 + 2 * S * HD // 2 * 4, peak_bf16, peak_bw)
        rows.append(dict(name="flash_attention_fused_rope", route="cuda",
                         source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                         replaces="lightx2v_tpu/ops/pallas/flash_attention.py:243",
                         shape=f"q,k,v (1,{S},{HEADS},{HD}) bf16; cos,sin ({S},64) fp32",
                         max_abs_err=err, bar="2e-2*max|ref| + 1e-3", ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_call="apply_rope_half x2 + F.scaled_dot_product_attention"))
        del out

    # ---- the same kernel at changing resolution's phase A: CFG's batch of two at 16 x 21 x 44 x 78 latents,
    # 18,018 tokens, whose last 128-row query tile holds 98 rows ----
    if want("flash_attention_fused_rope"):
        grid_a = (21, 22, 39)
        sa = grid_a[0] * grid_a[1] * grid_a[2]
        qa, ka, va = (randn(2, sa, HEADS, HD) for _ in range(3))
        ca, sna = (torch.from_numpy(t).to(dev) for t in build_wan_rope_grid(HD, *grid_a))
        out = fa.flash_attention_fused_rope(qa, ka, va, ca, sna)
        torch.cuda.synchronize()
        hs = slice(0, 2)
        ref = fa.flash_attention_fused_rope_plain(qa[:, :, hs], ka[:, :, hs], va[:, :, hs], ca, sna)
        err = check_close(f"flash_attention_fused_rope (2,{sa},{HEADS},{HD})", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref, out
        ms = cuda_ms(lambda: fa.flash_attention_fused_rope(qa, ka, va, ca, sna), reps)
        plain_ms = cuda_ms(lambda: fa.flash_attention_fused_rope_plain(qa, ka, va, ca, sna), 1, warmup=0)

        def lib_rope_a():
            qr, kr = apply_rope_half(qa, ca, sna), apply_rope_half(ka, ca, sna)
            return F.scaled_dot_product_attention(qr.transpose(1, 2), kr.transpose(1, 2), va.transpose(1, 2))

        lib_ms = cuda_ms(lib_rope_a, reps)
        b_ms, b_by = bound(4.0 * 2 * HEADS * sa * sa * HD, 4 * 2 * sa * HEADS * HD * 2 + 2 * sa * HD // 2 * 4,
                           peak_bf16, peak_bw)
        extra.append(dict(name="flash_attention_fused_rope", route="cuda",
                          source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                          replaces="lightx2v_tpu/ops/pallas/flash_attention.py:243",
                          shape=f"q,k,v (2,{sa},{HEADS},{HD}) bf16; cos,sin ({sa},64) fp32 (changing resolution, "
                                "phase A)",
                          max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          library_call="apply_rope_half x2 + F.scaled_dot_product_attention"))
        del qa, ka, va

    # ---- the RoPE pass of flash_attention_fused_rope (once per call) ----
    if want("flash_attention_fused_rope") or want("rope_rotate"):
        if not want("flash_attention_fused_rope"):
            k = randn(1, S, HEADS, HD)
            cos_np, sin_np = build_wan_rope_grid(HD, 21, 30, 52)
            cos, sin = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
        gain = fa._gain(HD)
        qr, kr = fa.rope_rotate(q, k, cos, sin, gain)
        qp, kp = fa.rope_rotate_plain(q, k, cos, sin, gain)
        torch.cuda.synchronize()
        if not (torch.equal(qr, qp) and torch.equal(kr, kp)):
            raise AssertionError("rope_rotate: not bit-identical to its plain version")
        print("[check] rope_rotate: bit-identical to rope_rotate_plain", flush=True)
        del qr, kr, qp, kp
        ms = cuda_ms(lambda: fa.rope_rotate(q, k, cos, sin, gain), reps * 2)
        print(f"[rope_rotate] RoPE pass {ms:.4f} ms at (1,{S},{HEADS},{HD})", flush=True)
        plain_ms = cuda_ms(lambda: fa.rope_rotate_plain(q, k, cos, sin, gain), reps)
        b_ms, b_by = bound(0.0, 4 * S * HEADS * HD * 2 + 2 * S * HD // 2 * 4, peak_bf16, peak_bw)
        rows.append(dict(name="rope_rotate", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                         replaces="lightx2v_tpu/ops/pallas/flash_attention.py:301",
                         shape=f"q,k (1,{S},{HEADS},{HD}) bf16; cos,sin ({S},64) fp32",
                         max_abs_err=0.0, bar="bit-identical", ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         library_call="none (no single PyTorch call applies RoPE)"))
        del k
    if want("flash_attention_fused_rope"):
        del v

    # ---- flash attention (cross-attention over 512 text tokens; i2v's 257 image tokens: the last
    # key tile holds one valid row, the rest zero-filled by TMA and masked by kv_limit) ----
    if want("flash_attention"):
        for sk in (TXT, IMG):
            kc, vc = randn(1, sk, HEADS, HD), randn(1, sk, HEADS, HD)
            out = fa.flash_attention(q, kc, vc)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, kc, vc)
            err = check_close(f"flash_attention {sk} keys", out, ref, 2e-2, 1e-3)
            del ref, out
            ms = cuda_ms(lambda: fa.flash_attention(q, kc, vc), reps)
            plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, kc, vc), 2)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kc.transpose(1, 2),
                                                                    vc.transpose(1, 2)), reps)
            b_ms, b_by = bound(4.0 * HEADS * S * sk * HD, (2 * S + 2 * sk) * HEADS * HD * 2, peak_bf16, peak_bw)
            (rows if sk == TXT else extra).append(dict(
                name="flash_attention", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                replaces="lightx2v_tpu/ops/pallas/flash_attention.py:409",
                shape=f"q (1,{S},{HEADS},{HD}); k,v (1,{sk},{HEADS},{HD}) bf16",
                max_abs_err=err, bar="2e-2*max|ref| + 1e-3", ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library_call="F.scaled_dot_product_attention"))
            del kc, vc

        # ---- the dense kernel at the self-attention shape, without RoPE ----
        ks, vs = randn(1, S, HEADS, HD), randn(1, S, HEADS, HD)
        hs = slice(0, 2)
        out = fa.flash_attention(q, ks, vs)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q[:, :, hs], ks[:, :, hs], vs[:, :, hs])
        err = check_close("flash_attention self-attention shape", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref, out
        ms = cuda_ms(lambda: fa.flash_attention(q, ks, vs), reps)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), ks.transpose(1, 2),
                                                                vs.transpose(1, 2)), reps)
        b_ms, b_by = bound(4.0 * HEADS * S * S * HD, 4 * S * HEADS * HD * 2, peak_bf16, peak_bw)
        extra.append(dict(name="flash_attention", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                          replaces="lightx2v_tpu/ops/pallas/flash_attention.py:409",
                          shape=f"q,k,v (1,{S},{HEADS},{HD}) bf16 (self-attention, no RoPE)",
                          max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=None,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          library_call="F.scaled_dot_product_attention"))
        del ks, vs
    if want("flash_attention_fused_rope") or want("flash_attention") or want("rope_rotate"):
        del q

    # ---- w8a8_matmul_fullk (q/k/v/o at M=32,760; cross k/v at M=512; i2v's image k/v at M=257) ----
    def quant_lib(x2):
        s = torch.clamp_min(x2.float().abs().amax(-1), 1e-8) * (1.0 / 127.0)
        return torch.clamp(torch.round(x2.float() / s[:, None]), -127, 127).to(torch.int8), s

    def w8a8_lib(x2, w, ws, b):
        xq, s = quant_lib(x2)
        acc = torch._int_mm(xq, w.t())
        return (acc.float() * s[:, None] * ws[None] + b[None]).to(torch.bfloat16)

    if want("w8a8_matmul_fullk"):
        w = torch.randint(-127, 128, (DIM, DIM), generator=g, device=dev, dtype=torch.int8)
        ws = torch.full((DIM,), 0.02 / 127, device=dev)
        bvec = randn(DIM, dtype=torch.float32, std=0.02)
        for m in (S, TXT, IMG):
            x = randn(m, DIM)
            out = wm.w8a8_matmul_fullk(x, w, ws, bvec)
            torch.cuda.synchronize()
            ref = wm.w8a8_matmul_fullk_plain(x, w, ws, bvec)
            # bar: the integer codes and the int32 sums are exact on both
            # sides; only the bf16 rounding of rare fp32 ties can differ
            err = check_close(f"w8a8_matmul_fullk M={m}", out, ref, 2 ** -7, 0.0)
            del ref, out
            ms = cuda_ms(lambda: wm.w8a8_matmul_fullk(x, w, ws, bvec), reps * 2)
            plain_ms = cuda_ms(lambda: wm.w8a8_matmul_fullk_plain(x, w, ws, bvec), 2)
            lib_ms = cuda_ms(lambda: w8a8_lib(x, w, ws, bvec), reps * 2)
            b_ms, b_by = bound(2.0 * m * DIM * DIM, m * DIM * 2 + DIM * DIM + 2 * DIM * 4 + m * DIM * 2,
                               peak_int8, peak_bw)
            (rows if m == S else extra).append(dict(name="w8a8_matmul_fullk", route="cuda",
                             source="lightx2v_tpu_torch/csrc/w8a8_matmul.cu",
                             replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:182",
                             shape=f"x ({m},{DIM}) bf16; w ({DIM},{DIM}) int8",
                             max_abs_err=err, bar="2^-7*max|ref|", ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             library_call="torch quantize + torch._int_mm + torch scaling",
                             **fullk_parts(wm, x, w, ws, bvec, "int8", reps * 2)))
            del x
        del w

    # ---- ffn_w8a8 ----
    if want("ffn_w8a8"):
        x = randn(S, DIM)
        w0 = torch.randint(-127, 128, (FFN, DIM), generator=g, device=dev, dtype=torch.int8)
        w2 = torch.randint(-127, 128, (DIM, FFN), generator=g, device=dev, dtype=torch.int8)
        s0, s2 = torch.full((FFN,), 0.02 / 127, device=dev), torch.full((DIM,), 0.02 / 127, device=dev)
        b0, b2 = randn(FFN, dtype=torch.float32, std=0.02), randn(DIM, dtype=torch.float32, std=0.02)
        out = wm.ffn_w8a8(x, w0, s0, b0, w2, s2, b2)
        torch.cuda.synchronize()
        ref = wm.ffn_w8a8_plain(x, w0, s0, b0, w2, s2, b2)
        # bar: x codes exact; h is fp32 on both sides but tanh on the card and
        # in torch may differ by an ulp, flipping a rare h code by one step
        err = check_close("ffn_w8a8", out, ref, 2e-2, 0.0)
        del ref, out
        ms = cuda_ms(lambda: wm.ffn_w8a8(x, w0, s0, b0, w2, s2, b2), reps)
        plain_ms = cuda_ms(lambda: wm.ffn_w8a8_plain(x, w0, s0, b0, w2, s2, b2), 1)

        def ffn_lib():
            h = w8a8_lib(x, w0, s0, b0).float()
            h = wm.gelu_tanh(h).to(torch.bfloat16)
            return w8a8_lib(h, w2, s2, b2)

        lib_ms = cuda_ms(ffn_lib, reps)
        b_ms, b_by = bound(2.0 * S * (DIM * FFN + FFN * DIM), S * DIM * 2 * 2 + 2 * DIM * FFN, peak_int8, peak_bw)
        rows.append(dict(name="ffn_w8a8", route="cuda", source="lightx2v_tpu_torch/csrc/w8a8_matmul.cu",
                         replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:301",
                         shape=f"x ({S},{DIM}) bf16; w0 ({FFN},{DIM}), w2 ({DIM},{FFN}) int8",
                         max_abs_err=err, bar="2e-2*max|ref|", ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_call="two (torch quantize + torch._int_mm), per-token h scales",
                         **ffn_parts(wm, x, w0, s0, b0, w2, s2, b2, "int8", reps)))
        del x, w0, w2
    torch.cuda.empty_cache()
    return rows, extra


def kernel_phase_flagship(peaks, reps: int, want):
    """The four kernels the bench flagship adds, at its shapes."""
    import numpy as np
    import torch

    from lightx2v_tpu_torch.ops import sparge
    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from lightx2v_tpu_torch.ops.cuda import w4a8_matmul as w4
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    peak_bf16, peak_int8, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rows, extra = [], []
    none_int4 = "none (no single PyTorch call computes per-group-scaled int4 x int8)"

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    def packed(n, k):  # synthetic int4 weights as the runner makes them, with scales that vary by (row, group)
        return (torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8),
                (0.5 + torch.rand((n, k // GROUP), generator=g, device=dev)) * (0.02 / 7))

    # ---- w4a8_matmul (q/k/v/o and cross q/o at M=32,760; cross k/v at M=512) ----
    if want("w4a8_matmul"):
        w, ws = packed(DIM, DIM)
        bvec = randn(DIM, dtype=torch.float32, std=0.02)
        for m in (S, TXT):
            x = randn(m, DIM)
            out = w4.w4a8_matmul(x, w, ws, bvec)
            torch.cuda.synchronize()
            ref = w4.w4a8_matmul_plain(x, w, ws, bvec)
            # bar: identical int8 codes, exact int32 group sums and the same
            # fp32 order on both sides; only bf16 rounding of rare ties differs
            err = check_close(f"w4a8_matmul M={m}", out, ref, 2 ** -7, 0.0)
            del ref, out
            ms = cuda_ms(lambda: w4.w4a8_matmul(x, w, ws, bvec), reps * 2)
            plain_ms = cuda_ms(lambda: w4.w4a8_matmul_plain(x, w, ws, bvec), 1)
            b_ms, b_by = bound(2.0 * m * DIM * DIM, m * DIM * 2 + DIM * DIM // 2 + ws.numel() * 4 + DIM * 4 + m * DIM * 2,
                               peak_int8, peak_bw)
            (rows if m == S else extra).append(dict(
                name="w4a8_matmul", route="cuda", source="lightx2v_tpu_torch/csrc/w4a8_matmul.cu",
                replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:585",
                shape=f"x ({m},{DIM}) bf16; w ({DIM},{DIM // 2}) u8 + ({DIM},{DIM // GROUP}) fp32",
                max_abs_err=err, bar="2^-7*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, library_call=none_int4, **w4a8_parts(w4, x, w, ws, bvec, reps * 2)))
            del x
        del w, ws

    # ---- ffn_w4a8 ----
    if want("ffn_w4a8"):
        x = randn(S, DIM)
        w0, s0 = packed(FFN, DIM)
        w2, s2 = packed(DIM, FFN)
        b0, b2 = randn(FFN, dtype=torch.float32, std=0.02), randn(DIM, dtype=torch.float32, std=0.02)
        out = w4.ffn_w4a8(x, w0, s0, b0, w2, s2, b2)
        torch.cuda.synchronize()
        ref = w4.ffn_w4a8_plain(x, w0, s0, b0, w2, s2, b2)
        # bar: x codes exact; h is fp32 on both sides but tanh on the card and
        # in torch may differ by an ulp, flipping a rare h code by one step
        err = check_close("ffn_w4a8", out, ref, 2e-2, 0.0)
        del ref, out
        ms = cuda_ms(lambda: w4.ffn_w4a8(x, w0, s0, b0, w2, s2, b2), reps)
        plain_ms = cuda_ms(lambda: w4.ffn_w4a8_plain(x, w0, s0, b0, w2, s2, b2), 1)
        b_ms, b_by = bound(4.0 * S * DIM * FFN, S * DIM * 2 * 2 + DIM * FFN + (s0.numel() + s2.numel() + FFN + DIM) * 4,
                           peak_int8, peak_bw)
        rows.append(dict(name="ffn_w4a8", route="cuda", source="lightx2v_tpu_torch/csrc/w4a8_matmul.cu",
                         replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:439",
                         shape=f"x ({S},{DIM}) bf16; w0 ({FFN},{DIM // 2}) u8 + ({FFN},{DIM // GROUP}); "
                               f"w2 ({DIM},{FFN // 2}) u8 + ({DIM},{FFN // GROUP}) fp32",
                         max_abs_err=err, bar="2e-2*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, library_call=none_int4,
                         **ffn_w4a8_parts(w4, x, w0, s0, b0, w2, s2, b2, reps)))
        del x, w0, w2

    # ---- w8a8_matmul, k-blocked (UMT5-XXL fc2: K = 10,240 > 8192) ----
    if want("w8a8_matmul"):
        x = randn(TXT, T5_FFN)
        w = torch.randint(-127, 128, (T5_DIM, T5_FFN), generator=g, device=dev, dtype=torch.int8)
        ws = torch.full((T5_DIM,), 0.02 / 127, device=dev)
        out = wm.w8a8_matmul(x, w, ws)
        torch.cuda.synchronize()
        ref = wm.w8a8_matmul_plain(x, w, ws)
        err = check_close("w8a8_matmul (k-blocked)", out, ref, 2 ** -7, 0.0)
        del ref, out
        ms = cuda_ms(lambda: wm.w8a8_matmul(x, w, ws), reps * 2)
        plain_ms = cuda_ms(lambda: wm.w8a8_matmul_plain(x, w, ws), 2)
        b_ms, b_by = bound(2.0 * TXT * T5_FFN * T5_DIM, TXT * T5_FFN * 2 + T5_DIM * T5_FFN + T5_DIM * 4 + TXT * T5_DIM * 2,
                           peak_int8, peak_bw)
        rows.append(dict(name="w8a8_matmul", route="cuda", source="lightx2v_tpu_torch/csrc/w8a8_matmul.cu",
                         replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:76",
                         shape=f"x ({TXT},{T5_FFN}) bf16; w ({T5_DIM},{T5_FFN}) int8; k-block 1024",
                         max_abs_err=err, bar="2^-7*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, library_call="none (no single PyTorch call scales per (token, k-block))"))
        del x, w

    # ---- block_sparse_attention, per-head, on Sparge's own selection ----
    if want("block_sparse_attention"):
        bq, bk = 2048, 1024
        q, k, v = randn(1, S, HEADS, HD), randn(1, S, HEADS, HD), randn(1, S, HEADS, HD)
        sel_ms = cuda_ms(lambda: sparge.sparge_select_blocks(q, k, keep_ratio=0.3, l1=0.3, block_q=bq, block_k=bk), 3)
        idx, cnt = sparge.sparge_select_blocks(q, k, keep_ratio=0.3, l1=0.3, block_q=bq, block_k=bk)
        out = bsa.block_sparse_attention(q, k, v, idx, cnt, bq=bq, bk=bk)
        torch.cuda.synchronize()
        hs = slice(0, 2)  # the plain version gathers and multiplies per (head, q superblock)
        ref = bsa.block_sparse_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs], idx[:2], cnt[:2], bq=bq, bk=bk)
        err = check_close("block_sparse_attention", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref, out
        ms = cuda_ms(lambda: bsa.block_sparse_attention(q, k, v, idx, cnt, bq=bq, bk=bk), reps)
        plain_ms = cuda_ms(lambda: bsa.block_sparse_attention_plain(q, k, v, idx, cnt, bq=bq, bk=bk), 1, warmup=0)
        # operations of this selection: 4*D per (query row, valid selected key)
        ic, cc = idx.cpu().numpy(), cnt.cpu().numpy()
        q_rows = np.minimum(bq, S - np.arange(ic.shape[1]) * bq)
        k_valid = np.minimum(bk, S - np.arange(-(-S // bk)) * bk)
        pairs = sum(int(q_rows[i]) * int(k_valid[ic[h, i, :cc[h, i]]].sum()) for h in range(ic.shape[0])
                    for i in range(ic.shape[1]))
        b_ms, b_by = bound(4.0 * HD * pairs, 4 * S * HEADS * HD * 2 + idx.numel() * 4 + cnt.numel() * 4, peak_bf16, peak_bw)
        lib_ms = library(lambda: flex_attention_call(q, k, v, idx, cnt, bq, bk, out_check=hs), 2, make=True)
        rows.append(dict(name="block_sparse_attention", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                         replaces="lightx2v_tpu/ops/pallas/block_sparse_attention.py:206",
                         shape=f"q,k,v (1,{S},{HEADS},{HD}) bf16; indices {tuple(idx.shape)}, counts {tuple(cnt.shape)} "
                               f"i32; bq {bq}, bk {bk}; selected {int(cc.sum())} of {cc.size * ic.shape[2]}",
                         max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_call="torch.compile(flex_attention) with the same per-head block mask",
                         selection_ms=sel_ms, dense_fraction=pairs / (HEADS * S * S)))
        del q, k, v
    torch.cuda.empty_cache()
    return rows, extra


def flex_attention_call(q, k, v, idx, cnt, bq: int, bk: int, out_check=None):
    """A callable of torch.compile(flex_attention) over the per-head block
    table (idx (H, nq, n), cnt (H, nq)) as a BlockMask of (bq, bk) blocks:
    the library yardstick of the per-head block-sparse kernel. Compiled and
    checked against the kernel on the heads ``out_check`` at its first call."""
    import torch
    from torch.nn.attention.flex_attention import BlockMask, flex_attention

    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa

    h, nq, n = idx.shape
    nk = -(-k.shape[1] // bk)
    kv_idx = torch.zeros((1, h, nq, nk), dtype=torch.int32, device=q.device)
    kv_idx[..., :n] = idx
    mask = BlockMask.from_kv_blocks(cnt[None].to(torch.int32).contiguous(), kv_idx, BLOCK_SIZE=(bq, bk),
                                    seq_lengths=(q.shape[1], k.shape[1]))
    flex = torch.compile(flex_attention, dynamic=False)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def call():
        return flex(qt, kt, vt, block_mask=mask)

    if out_check is not None:
        ref = bsa.block_sparse_attention(q, k, v, idx, cnt, bq=bq, bk=bk)[:, :, out_check]
        got = call().transpose(1, 2)[:, :, out_check]
        torch.cuda.synchronize()
        print(json.dumps({"flex_attention_vs_kernel_max_abs_diff": float((got.float() - ref.float()).abs().max())}),
              flush=True)
    return call


def kernel_phase_base(peaks, reps: int, want):
    """The four kernels of the base and radial paths, at their shapes, and
    the radial comparison at the main shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lightx2v_tpu_torch.ops import radial
    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa
    from lightx2v_tpu_torch.ops.cuda import int4_matmul as i4
    from lightx2v_tpu_torch.ops.cuda import sage_attention as sa
    from lightx2v_tpu_torch.parallel.ring import merge_partials

    peak_bf16, peak_int8, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows, extra = [], []
    hs = slice(0, 2)  # the attention plain versions materialize S x S per head

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    # ---- sage_attention (base path: self-attention of both CFG branches) ----
    if want("sage_attention"):
        q, k, v = randn(2, S, HEADS, HD), randn(2, S, HEADS, HD), randn(2, S, HEADS, HD)
        out = sa.sage_attention(q, k, v)
        torch.cuda.synchronize()
        ref = sa.sage_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs])
        # bar: identical int32 logits on both sides; P rounded to bf16 at
        # different running maxima (online vs one-pass softmax), summation order
        err = check_close("sage_attention", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref, out
        ms = cuda_ms(lambda: sa.sage_attention(q, k, v), reps)
        parts = sage_parts(sa, fa, q, k, v, reps)
        plain_ms = cuda_ms(lambda: sa.sage_attention_plain(q, k, v), 1, warmup=0)
        lib_ms = library(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                                v.transpose(1, 2)), reps)
        pairs = 2.0 * HEADS * S * S
        t_ops = 2.0 * HD * pairs / peak_int8 + 2.0 * HD * pairs / peak_bf16  # int8 QK^T, then bf16 P.V
        t_bytes = 4 * q.numel() * 2 / peak_bw
        rows.append(dict(name="sage_attention", route="cuda", source="lightx2v_tpu_torch/csrc/sage_attention.cu",
                         replaces="lightx2v_tpu/ops/pallas/sage_attention.py:120",
                         shape=f"q,k,v (2,{S},{HEADS},{HD}) bf16",
                         max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=plain_ms,
                         bound_ms=max(t_ops, t_bytes) * 1e3, bound_by="operations" if t_ops >= t_bytes else "bytes",
                         library_ms=lib_ms, library_call="F.scaled_dot_product_attention (bf16)", **parts))
        # one-signed q and k at the main shape: logits of one sign and large
        # int32 sums (the int -> float conversion), the same bar on 2 heads
        q, k = q.abs() * 3, k.abs() * 3
        out = sa.sage_attention(q, k, v)
        torch.cuda.synchronize()
        ref = sa.sage_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs])
        rows[-1]["max_abs_err_one_signed"] = check_close("sage_attention one-signed", out[:, :, hs], ref, 2e-2, 1e-3)
        del q, k, v, out, ref

    # ---- int4_matmul (base path: every block linear; M = 65,520, and 1,024 for cross k/v) ----
    if want("int4_matmul"):
        def int4_lib(x2, w, ws):
            return torch.matmul(x2, i4.unpack_int4(w, ws).to(torch.bfloat16).t())

        for m, n, kin in ((2 * S, DIM, DIM), (2 * S, FFN, DIM), (2 * S, DIM, FFN), (2 * TXT, DIM, DIM)):
            x = randn(m, kin)
            w = torch.randint(0, 256, (n, kin // 2), generator=g, device=dev, dtype=torch.uint8)
            ws = torch.rand((n, kin // GROUP), generator=g, device=dev) * (0.02 / 7) + 0.01 / 7
            bvec = randn(n, dtype=torch.float32, std=0.02)
            out = i4.int4_matmul(x, w, ws, bvec)
            torch.cuda.synchronize()
            ref = i4.int4_matmul_plain(x, w, ws, bvec)
            # bar: exact bf16 x int4 products and the same per-group fp32
            # rescale; additions inside a group in another order move a bf16
            # rounding now and then (one ulp at the top of the range)
            err = check_close(f"int4_matmul M={m} N={n} K={kin}", out, ref, 2 ** -7, 0.0)
            del ref, out
            ms = cuda_ms(lambda: i4.int4_matmul(x, w, ws, bvec), reps)
            plain_ms = cuda_ms(lambda: i4.int4_matmul_plain(x, w, ws, bvec), 1)
            lib_ms = library(lambda: int4_lib(x, w, ws), reps)
            b_ms, b_by = bound(2.0 * m * n * kin, m * kin * 2 + n * kin // 2 + ws.numel() * 4 + n * 4 + m * n * 2,
                               peak_bf16, peak_bw)
            (rows if (m, n, kin) == (2 * S, DIM, DIM) else extra).append(dict(
                name="int4_matmul", route="cuda", source="lightx2v_tpu_torch/csrc/int4_matmul.cu",
                replaces="lightx2v_tpu/ops/pallas/int4_matmul.py:102",
                shape=f"x ({m},{kin}) bf16; w ({n},{kin // 2}) u8 + ({n},{kin // GROUP}) fp32",
                max_abs_err=err, bar="2^-7*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_call="dequantize to bf16 in torch + torch.matmul"))
            del x, w, ws

    # ---- flash_attention_with_lse (two-pass radial: near pass, then one frame of the far pass) ----
    plan = radial._two_pass_plan(S, S, FRAMES, 0.5, "wan", 256)
    tpf, bq, near, far = plan
    nt, nwin = far.shape[1], far.shape[2]

    if want("flash_attention_with_lse"):
        def lse_lib(q, k, v):
            return torch.ops.aten._scaled_dot_product_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                                      v.transpose(1, 2))[:2]

        for b_, sq_, sk_ in ((FRAMES, tpf, 4 * tpf), (nt, bq, nwin * bq)):
            q, k, v = randn(b_, sq_, HEADS, HD), randn(b_, sk_, HEADS, HD), randn(b_, sk_, HEADS, HD)
            out, lse = fa.flash_attention_with_lse(q, k, v)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_with_lse_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs])
            err = check_close(f"flash_attention_with_lse out ({b_},{sq_},{sk_})", out[:, :, hs], ref, 2e-2, 1e-3)
            # bar for lse: the same fp32 sums in another order
            lse_err = check_close(f"flash_attention_with_lse lse ({b_},{sq_},{sk_})", lse[:, :, hs], ref_lse, 0.0, 1e-3)
            del ref, out
            ms = cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v), reps)
            plain_ms = cuda_ms(lambda: fa.flash_attention_with_lse_plain(q, k, v), 1, warmup=0)
            lib_ms = library(lambda: lse_lib(q, k, v), reps)
            b_ms, b_by = bound(4.0 * b_ * HEADS * sq_ * sk_ * HD,
                               (2 * q.numel() + 2 * k.numel()) * 2 + lse.numel() * 4, peak_bf16, peak_bw)
            (rows if b_ == FRAMES else extra).append(dict(
                name="flash_attention_with_lse", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                replaces="lightx2v_tpu/ops/pallas/flash_attention.py:432",
                shape=f"q ({b_},{sq_},{HEADS},{HD}); k,v ({b_},{sk_},{HEADS},{HD}) bf16; lse ({b_},{sq_},{HEADS}) fp32",
                max_abs_err=err, lse_max_abs_err=lse_err, bar="out 2e-2*max|ref| + 1e-3, lse 1e-3 (2 heads)", ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library_call="aten._scaled_dot_product_flash_attention (output and logsumexp)"))
            del q, k, v, lse

    # ---- block_sparse_attention, shared mask (radial, 128 x 128 blocks) ----
    if want("block_sparse_attention_shared"):
        q, k, v = randn(1, S, HEADS, HD), randn(1, S, HEADS, HD), randn(1, S, HEADS, HD)
        mm = radial.MaskMap(S, FRAMES)
        fine = mm.query_mask(S, 0.5, "wan")
        idx, cnt = mm.block_tables(S, 0.5, "wan", 128, 128, dev)
        out = bsa.block_sparse_attention(q, k, v, idx, cnt, bq=128, bk=128)
        torch.cuda.synchronize()
        ref = bsa.block_sparse_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs], idx, cnt, bq=128, bk=128)
        err = check_close("block_sparse_attention_shared", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref, out
        ms = cuda_ms(lambda: bsa.block_sparse_attention(q, k, v, idx, cnt, bq=128, bk=128), reps)
        plain_ms = cuda_ms(lambda: bsa.block_sparse_attention_plain(q, k, v, idx, cnt, bq=128, bk=128), 1, warmup=0)
        tok = torch.from_numpy(fine).to(dev).repeat_interleave(128, 0).repeat_interleave(128, 1)[:S, :S].contiguous()
        lib_ms = library(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                                attn_mask=tok), 2)
        del tok

        def mask_pairs(mask, bq_, bk_):
            q_rows = np.minimum(bq_, S - np.arange(mask.shape[0]) * bq_).clip(0)
            k_valid = np.minimum(bk_, S - np.arange(mask.shape[1]) * bk_).clip(0)
            return float(q_rows @ mask.astype(np.float64) @ k_valid)

        pairs = mask_pairs(fine, 128, 128)
        b_ms, b_by = bound(4.0 * HD * HEADS * pairs, 4 * S * HEADS * HD * 2 + idx.numel() * 4 + cnt.numel() * 4,
                           peak_bf16, peak_bw)
        rows.append(dict(name="block_sparse_attention_shared", route="cuda",
                         source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                         replaces="lightx2v_tpu/ops/pallas/block_sparse_attention.py:206",
                         shape=f"q,k,v (1,{S},{HEADS},{HD}) bf16; indices {tuple(idx.shape)}, counts {tuple(cnt.shape)} i32 "
                               f"shared by all heads; bq 128, bk 128; {int(fine.sum())} of {fine.size} blocks",
                         max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms,
                         library_call="F.scaled_dot_product_attention with the expanded boolean mask",
                         dense_fraction=pairs / (float(S) * S)))

        # ---- the radial comparison at the main shape ----
        idx2, cnt2 = mm.block_tables(S, 0.5, "wan", 256, 128, dev)
        coarse = radial.coarsen_block_mask(fine, 2, 1)
        before = fa.LAUNCHES["flash_attention_with_lse"]
        two = radial.radial_attention(q, k, v, mm, sparsity_type="two_pass", block_q=256, block_k=128)
        torch.cuda.synchronize()
        lse_calls = fa.LAUNCHES["flash_attention_with_lse"] - before
        if lse_calls != 1 + FRAMES or not torch.isfinite(two.float()).all():
            raise AssertionError(f"two_pass: {lse_calls} LSE launches (expected {1 + FRAMES}) or non-finite output")
        del two
        near_pairs = float(FRAMES) * tpf * 4 * tpf
        far_pairs = float(FRAMES) * nt * bq * nwin * bq
        comparison = {
            "shape": f"q,k,v (1,{S},{HEADS},{HD}) bf16, {FRAMES} frames, decay 0.5",
            "dense_flash_ms": cuda_ms(lambda: fa.flash_attention(q, k, v), reps),
            "bsr_128x128_ms": ms, "bsr_128x128_key_pair_fraction": pairs / (float(S) * S),
            "bsr_256x128_ms": cuda_ms(lambda: bsa.block_sparse_attention(q, k, v, idx2, cnt2, bq=256, bk=128), reps),
            "bsr_256x128_key_pair_fraction": mask_pairs(coarse, 256, 128) / (float(S) * S),
            "two_pass_ms": cuda_ms(lambda: radial.radial_attention(q, k, v, mm, sparsity_type="two_pass", block_q=256,
                                                                   block_k=128), reps),
            "two_pass_key_pair_fraction": (near_pairs + far_pairs) / (float(S) * S),
            "two_pass_lse_launches": lse_calls}
        print(json.dumps({"radial_comparison": comparison}), flush=True)

        # ---- merge_partials: two half-key partials merged vs one dense call ----
        half = S // 2
        oa, la = fa.flash_attention_with_lse(q, k[:, :half], v[:, :half])
        ob, lb = fa.flash_attention_with_lse(q, k[:, half:], v[:, half:])
        merged, lse_m = merge_partials(oa, la, ob, lb)
        dense, lse_d = fa.flash_attention_with_lse(q, k, v)
        torch.cuda.synchronize()
        # bar: each partial is rounded to bf16 before the fp32 merge, then once more
        check_close("merge_partials of two half-key partials vs one dense call", merged, dense, 2e-2, 1e-3)
        check_close("merged lse vs dense lse", lse_m, lse_d, 0.0, 1e-3)
        del q, k, v, oa, ob, merged, dense
    torch.cuda.empty_cache()
    return rows, extra


def kernel_phase_fp8(peaks, reps: int, want):
    """The fp8 (e4m3) kind of the three 8-bit kernels, at the fp8 distill
    path's shapes. fp8's dense peak on these cards equals int8's."""
    import torch

    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    _, peak_fp8, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    rows, extra = [], []

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    def fp8_w(n, k):  # synthetic e4m3 weights as the runner makes them
        w = (torch.randn((n, k), generator=g, device=dev) * 100).clamp_(-448, 448).to(torch.float8_e4m3fn)
        return w, torch.full((n,), 0.02 / 100, device=dev)

    def quant_lib(x2):
        s = torch.clamp_min(x2.float().abs().amax(-1), 1e-8) * (1.0 / 448.0)
        return (x2.float() / s[:, None]).to(torch.float8_e4m3fn), s

    def fp8_lib(x2, w, ws, b=None):
        """quantize in torch + torch._scaled_mm with row-wise scales, bf16 out"""
        xq, s = quant_lib(x2)
        return torch._scaled_mm(xq, w.t(), scale_a=s[:, None].contiguous(), scale_b=ws[None, :].contiguous(),
                                bias=None if b is None else b.to(torch.bfloat16), out_dtype=torch.bfloat16)

    lib_call = "torch quantize + torch._scaled_mm (row-wise scales, bf16 out)"

    # ---- w8a8_matmul_fullk, fp8 (q/k/v/o at M=32,760; cross k/v and the T5 at M=512) ----
    if want("w8a8_matmul_fullk_fp8"):
        w, ws = fp8_w(DIM, DIM)
        bvec = randn(DIM, dtype=torch.float32, std=0.02)
        for m in (S, TXT, 2 * S):  # 2S: tea_fp8's CFG batch of two
            x = randn(m, DIM)
            out = wm.w8a8_matmul_fullk(x, w, ws, bvec, kind="fp8")
            torch.cuda.synchronize()
            ref = wm.w8a8_matmul_fullk_plain(x, w, ws, bvec, kind="fp8")
            # bar: the same e4m3 codes and scales; exact products summed in
            # fp32 by the tensor cores against one rounding of the exact sum
            err = check_close(f"w8a8_matmul_fullk_fp8 M={m}", out, ref, 2 ** -7, 0.0)
            del ref, out
            one_signed = {}
            if m == S:
                # one-signed x and codes: truncated wgmma partial sums would
                # add up here (the source note's promotion interval); same bar
                xo, wo = x.abs(), w.view(torch.uint8).bitwise_and(0x7F).view(torch.float8_e4m3fn)
                out = wm.w8a8_matmul_fullk(xo, wo, ws, bvec, kind="fp8")
                torch.cuda.synchronize()
                ref = wm.w8a8_matmul_fullk_plain(xo, wo, ws, bvec, kind="fp8")
                one_signed["one_signed_max_abs_err"] = check_close(
                    f"w8a8_matmul_fullk_fp8 M={m} one-signed", out, ref, 2 ** -7, 0.0)
                del xo, wo, ref, out
            ms = cuda_ms(lambda: wm.w8a8_matmul_fullk(x, w, ws, bvec, kind="fp8"), reps * 2)
            plain_ms = cuda_ms(lambda: wm.w8a8_matmul_fullk_plain(x, w, ws, bvec, kind="fp8"), 2)
            lib_ms = library(lambda: fp8_lib(x, w, ws, bvec), reps * 2)
            b_ms, b_by = bound(2.0 * m * DIM * DIM, m * DIM * 2 + DIM * DIM + 2 * DIM * 4 + m * DIM * 2,
                               peak_fp8, peak_bw)
            (rows if m == S else extra).append(dict(
                name="w8a8_matmul_fullk_fp8", route="cuda", source="lightx2v_tpu_torch/csrc/w8a8_matmul.cu",
                replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:182", shape=f"x ({m},{DIM}) bf16; w ({DIM},{DIM}) e4m3",
                max_abs_err=err, bar="2^-7*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_call=lib_call, **one_signed,
                **fullk_parts(wm, x, w, ws, bvec, "fp8", reps * 2)))
            del x
        del w

    # ---- ffn_w8a8, fp8 (M = 32,760; 65,520, tea_fp8's CFG batch of two) ----
    if want("ffn_w8a8_fp8"):
        w0, s0 = fp8_w(FFN, DIM)
        w2, s2 = fp8_w(DIM, FFN)
        b0, b2 = randn(FFN, dtype=torch.float32, std=0.02), randn(DIM, dtype=torch.float32, std=0.02)
        for m in (S, 2 * S):
            x = randn(m, DIM)
            out = wm.ffn_w8a8(x, w0, s0, b0, w2, s2, b2, kind="fp8")
            torch.cuda.synchronize()
            ref = wm.ffn_w8a8_plain(x, w0, s0, b0, w2, s2, b2, kind="fp8")
            # bar: x codes exact; h is fp32 on both sides but tanh on the card and
            # in torch may differ by an ulp, moving a rare h code by one step
            err = check_close(f"ffn_w8a8_fp8 M={m}", out, ref, 2e-2, 0.0)
            del ref, out
            one_signed = {}
            if m == S:
                # one-signed x and w0 codes: GEMM1's truncated wgmma partial sums
                # would add up here (the source note's promotion interval); same bar
                xo, w0o = x.abs(), w0.view(torch.uint8).bitwise_and(0x7F).view(torch.float8_e4m3fn)
                out = wm.ffn_w8a8(xo, w0o, s0, b0, w2, s2, b2, kind="fp8")
                torch.cuda.synchronize()
                ref = wm.ffn_w8a8_plain(xo, w0o, s0, b0, w2, s2, b2, kind="fp8")
                one_signed["one_signed_max_abs_err"] = check_close("ffn_w8a8_fp8 one-signed", out, ref, 2e-2, 0.0)
                del xo, w0o, ref, out
            ms = cuda_ms(lambda: wm.ffn_w8a8(x, w0, s0, b0, w2, s2, b2, kind="fp8"), reps)
            plain_ms = cuda_ms(lambda: wm.ffn_w8a8_plain(x, w0, s0, b0, w2, s2, b2, kind="fp8"), 1)

            def ffn_lib():
                h = wm.gelu_tanh(fp8_lib(x, w0, s0, b0).float()).to(torch.bfloat16)
                return fp8_lib(h, w2, s2, b2)

            lib_ms = library(ffn_lib, reps)
            b_ms, b_by = bound(4.0 * m * DIM * FFN, m * DIM * 2 * 2 + 2 * DIM * FFN + (2 * FFN + 2 * DIM) * 4,
                               peak_fp8, peak_bw)
            (rows if m == S else extra).append(dict(
                name="ffn_w8a8_fp8", route="cuda", source="lightx2v_tpu_torch/csrc/w8a8_matmul.cu",
                replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:301",
                shape=f"x ({m},{DIM}) bf16; w0 ({FFN},{DIM}), w2 ({DIM},{FFN}) e4m3",
                max_abs_err=err, bar="2e-2*max|ref|", **one_signed, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_call="two (torch quantize + torch._scaled_mm) around a torch "
                                                "GELU, per-token h scales",
                **ffn_parts(wm, x, w0, s0, b0, w2, s2, b2, "fp8", reps)))
            del x
        del w0, w2

    # ---- w8a8_matmul (k-blocked), fp8 (UMT5-XXL fc2: K = 10,240 > 8192) ----
    if want("w8a8_matmul_fp8"):
        x = randn(TXT, T5_FFN)
        w, ws = fp8_w(T5_DIM, T5_FFN)
        out = wm.w8a8_matmul(x, w, ws, kind="fp8")
        torch.cuda.synchronize()
        ref = wm.w8a8_matmul_plain(x, w, ws, kind="fp8")
        err = check_close("w8a8_matmul_fp8 (k-blocked)", out, ref, 2 ** -7, 0.0)
        del ref, out
        ms = cuda_ms(lambda: wm.w8a8_matmul(x, w, ws, kind="fp8"), reps * 2)
        plain_ms = cuda_ms(lambda: wm.w8a8_matmul_plain(x, w, ws, kind="fp8"), 2)
        lib_ms = library(lambda: fp8_lib(x, w, ws), reps * 2)
        b_ms, b_by = bound(2.0 * TXT * T5_FFN * T5_DIM, TXT * T5_FFN * 2 + T5_DIM * T5_FFN + T5_DIM * 4 + TXT * T5_DIM * 2,
                           peak_fp8, peak_bw)
        rows.append(dict(name="w8a8_matmul_fp8", route="cuda", source="lightx2v_tpu_torch/csrc/w8a8_matmul.cu",
                         replaces="lightx2v_tpu/ops/pallas/w8a8_matmul.py:76",
                         shape=f"x ({TXT},{T5_FFN}) bf16; w ({T5_DIM},{T5_FFN}) e4m3; k-block 1024",
                         max_abs_err=err, bar="2^-7*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, library_call=lib_call + "; per-token scales, not per (token, k-block)"))
        del x, w
    torch.cuda.empty_cache()
    return rows, extra


def kernel_phase_cog(peaks, reps: int, want):
    """The dense flash kernel's 64-wide form at CogVideoX's joint-stream
    self-attention, q, k, v (2, 45,106, 48, 64): CFG's two rows, 226 text
    tokens + 44,880 video tokens, one call a block (its row); and at
    ``bench.py``'s 480p shape, (2, 17,386, 48, 64), the ``cogvideox_quant``
    phase's (an ``other_shapes`` entry)."""
    import torch
    import torch.nn.functional as F

    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    if not want("flash_attention_d64"):
        return [], []
    peak_bf16, _, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    out_rows = []
    for s_len, note in ((COG_S, "CogVideoX joint stream, CFG batch 2"),
                        (COG_Q_S, "CogVideoX at bench.py's 480p shape, CFG batch 2")):
        shape = (2, s_len, COG_HEADS, COG_HD)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        hs = slice(0, 2)  # the plain version materializes S x S per head
        ref = fa.flash_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs])
        # bar: as row 2 (bf16 P at other running maxima, another summation order)
        err = check_close(f"flash_attention_d64 {shape}", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref, out
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), reps)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 1, warmup=0)
        lib_ms = library(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                                v.transpose(1, 2)), reps)
        pairs = 2.0 * COG_HEADS * s_len * s_len  # (batch, head, query, key)
        tensor_ms, by = bound(4.0 * COG_HD * pairs, 4 * 2 * s_len * COG_HEADS * COG_HD * 2, peak_bf16, peak_bw)
        exp_ms = pairs / PEAK_EX2 * 1e3  # one exp2 a (query, key) pair on the special-function units
        out_rows.append(dict(name="flash_attention_d64", route="cuda",
                             source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                             replaces="lightx2v_tpu/ops/pallas/flash_attention.py:409",
                             shape=f"q,k,v {shape} bf16 ({note})",
                             max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=plain_ms,
                             bound_ms=max(tensor_ms, exp_ms),
                             bound_by="bytes" if by == "bytes" and tensor_ms > exp_ms else "operations",
                             bound_tensor_ms=tensor_ms, bound_exp2_ms=exp_ms, library_ms=lib_ms,
                             library_call="F.scaled_dot_product_attention"))
        print(f"[flash_attention_d64] {shape}: {ms:.3f} ms; bounds: tensor cores {tensor_ms:.2f} ms, exp2 "
              f"{exp_ms:.2f} ms; SDPA {lib_ms} ms", flush=True)
        del q, k, v
    torch.cuda.empty_cache()
    return out_rows[:1], out_rows[1:]


def hunyuan_text_len() -> int:
    """The valid text tokens of the path's prompt: what the runner's
    synthetic Llama tokenizer keeps past the template's crop."""
    from lightx2v_tpu_torch.encoders.llama import LLAVA_LLAMA3_8B, PROMPT_TEMPLATE
    from lightx2v_tpu_torch.runners.hunyuan_runner import _SyntheticLlamaTokenizer

    _, mask = _SyntheticLlamaTokenizer(LLAVA_LLAMA3_8B)([PROMPT_TEMPLATE.format(PROMPT)], return_mask=True)
    return int(mask[0, LLAVA_LLAMA3_8B.crop_start:].sum())


def kernel_phase_hunyuan(peaks, reps: int, want):
    """The dense flash kernel (row 2) at HunyuanVideo's joint stream: q, k, v
    (1, 79,456, 24, 128) for t2v at 720 x 1280, and (1, 76,696, 24, 128) for
    the i2v path at 193 frames of 480 x 832, keys at or past ``kv_len`` (the
    image tokens and the prompt's valid text tokens) masked. Neither length
    is a multiple of 128, so the last query tile is ragged and the last key
    tile partly masked. Returns ``other_shapes`` entries (row 2's main entry
    is the cross-attention's)."""
    import torch
    import torch.nn.functional as F

    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    if not want("flash_attention"):
        return []
    peak_bf16, _, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    out_rows = []
    for img, note in ((HY_IMG, "HunyuanVideo joint stream"), (HY_I2V_IMG, "HunyuanVideo i2v, 193 frames at 480p")):
        s, kv = img + HY_TXT, img + hunyuan_text_len()
        q, k, v = (torch.randn((1, s, HY_HEADS, HD), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
        v[:, kv:] = 1e4  # a kernel that reads a masked key fails by orders of magnitude, not by chance
        out = fa.flash_attention(q, k, v, kv_len=kv)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"flash_attention at {note}: non-finite output")
        hs = slice(0, 2)  # the plain version materializes rows x S per head
        ref = fa.flash_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs], kv)
        # bar: as row 2 (bf16 P at other running maxima, another summation order)
        err = check_close(f"flash_attention (1,{s},{HY_HEADS},{HD}) kv_len {kv}", out[:, :, hs], ref, 2e-2, 1e-3)
        del ref, out
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, kv_len=kv), reps)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, kv), 1, warmup=0)
        kt, vt = k[:, :kv].transpose(1, 2), v[:, :kv].transpose(1, 2)
        lib_ms = library(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kt, vt), reps)
        b_ms, b_by = bound(4.0 * HY_HEADS * s * kv * HD, (2 * s + 2 * kv) * HY_HEADS * HD * 2, peak_bf16, peak_bw)
        print(f"[flash_attention_hunyuan] {note}: {ms:.3f} ms ({b_ms / ms:.0%} of its {b_ms:.2f} ms bound); "
              f"SDPA {lib_ms} ms", flush=True)
        del q, k, v, kt, vt
        out_rows.append(dict(name="flash_attention", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                             replaces="lightx2v_tpu/ops/pallas/flash_attention.py:409",
                             shape=f"q,k,v (1,{s},{HY_HEADS},{HD}) bf16, kv_len {kv} ({note})",
                             max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             library_call="F.scaled_dot_product_attention on the valid keys"))
    torch.cuda.empty_cache()
    return out_rows


def quant_linear_shapes():
    """(M, K, N, where) of the quantized HunyuanVideo and CogVideoX linears
    at bench.py's shapes: Hunyuan's modulation projections at M = 1, its
    text stream at 256 tokens, its image stream at 32,760 and its single
    blocks' joint stream at 33,016; CogVideoX's joint stream at CFG's 2 x
    17,386 and its AdaLN projections at M = 2."""
    d, mlp, hy_j, cog = 3072, 12288, HY_Q_IMG + HY_Q_TXT, 2 * COG_Q_S
    return [(1, d, 6 * d, "hunyuan double-block modulation"), (1, d, 3 * d, "hunyuan single-block modulation"),
            (HY_Q_TXT, d, 3 * d, "hunyuan text qkv"), (HY_Q_TXT, mlp, d, "hunyuan text fc2"),
            (HY_Q_IMG, d, 3 * d, "hunyuan image qkv"), (HY_Q_IMG, d, d, "hunyuan image proj"),
            (HY_Q_IMG, d, mlp, "hunyuan image fc1"), (HY_Q_IMG, mlp, d, "hunyuan image fc2"),
            (hy_j, d, 3 * d + mlp, "hunyuan single linear1"), (hy_j, d + mlp, d, "hunyuan single linear2"),
            (cog, d, d, "cogvideox q/k/v/o"), (cog, d, mlp, "cogvideox ff_0"), (cog, mlp, d, "cogvideox ff_2"),
            (2, 512, 6 * d, "cogvideox AdaLN")]


def kernel_phase_quant_linears(peaks, reps: int, want):
    """Rows 3 and 3f (the full-K 8-bit GEMM, int8 and fp8) at every
    quantized HunyuanVideo and CogVideoX linear's shape, and rows 11
    (weight-only int4) and 8 (int4 x int8) at Hunyuan's, each held against
    its plain version on the same inputs and timed beside it, the library
    call and the bound. Widths of 3072 are below the JAX package's 4096
    threshold, so on the card these are new shapes for rows 3 and 3f (M = 1
    and 2, K = 12,288 and 15,360, N = 18,432 and 21,504). Returns
    ``other_shapes`` entries."""
    import torch

    from lightx2v_tpu_torch.ops.cuda import int4_matmul as i4
    from lightx2v_tpu_torch.ops.cuda import w4a8_matmul as w4
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm
    from lightx2v_tpu_torch.tools.convert import _pick_bk

    peak_bf16, peak_int8, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    out_rows = []

    def entry(name, src, rep, shape, err, bar, ms, plain_ms, flops, nbytes, peak, lib_ms, lib_call, note):
        b_ms, b_by = bound(flops, nbytes, peak, peak_bw)
        print(f"[{name}] {note} {shape}: {ms:.4f} ms ({b_ms / ms:.0%} of its {b_ms:.4f} ms bound); plain "
              f"{plain_ms:.3f} ms; library {lib_ms} ms", flush=True)
        out_rows.append(dict(name=name, route="cuda", source=f"lightx2v_tpu_torch/csrc/{src}", replaces=rep,
                             shape=f"{shape} ({note})", max_abs_err=err, bar=bar, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library_call=lib_call))

    def quant_lib(x2, kind):
        s = torch.clamp_min(x2.float().abs().amax(-1), 1e-8) * (1.0 / wm._QMAX[kind])
        q = x2.float() / s[:, None]
        return (torch.clamp(torch.round(q), -127, 127).to(torch.int8) if kind == "int8"
                else q.to(torch.float8_e4m3fn)), s

    def w8_lib(x2, w, ws, b, kind):
        xq, s = quant_lib(x2, kind)
        if kind == "int8":
            return (torch._int_mm(xq, w.t()).float() * s[:, None] * ws[None] + b[None]).to(torch.bfloat16)
        return torch._scaled_mm(xq, w.t(), scale_a=s[:, None].contiguous(), scale_b=ws[None, :].contiguous(),
                                bias=b.to(torch.bfloat16), out_dtype=torch.bfloat16)

    for m, k, n, note in quant_linear_shapes():
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        bvec = torch.randn((n,), generator=g, device=dev) * 0.02
        for kind, name in (("int8", "w8a8_matmul_fullk"), ("fp8", "w8a8_matmul_fullk_fp8")):
            if not want(name):
                continue
            if kind == "int8":
                w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
                ws = torch.full((n,), 0.02 / 127, device=dev)
            else:
                w = (torch.randn((n, k), generator=g, device=dev) * 100).clamp_(-448, 448).to(torch.float8_e4m3fn)
                ws = torch.full((n,), 0.02 / 100, device=dev)
            out = wm.w8a8_matmul_fullk(x, w, ws, bvec, kind=kind)
            torch.cuda.synchronize()
            ref = wm.w8a8_matmul_fullk_plain(x, w, ws, bvec, kind=kind)
            # bar: the same codes and scales; exact int32 sums (int8) or exact
            # products summed in fp32 (fp8) against one rounding of the exact
            # sum; bf16 ties aside (rows 3 and 3f's bar)
            err = check_close(f"{name} {note} M={m} K={k} N={n}", out, ref, 2 ** -7, 0.0)
            del out, ref
            ms = cuda_ms(lambda: wm.w8a8_matmul_fullk(x, w, ws, bvec, kind=kind), reps)
            plain_ms = cuda_ms(lambda: wm.w8a8_matmul_fullk_plain(x, w, ws, bvec, kind=kind), 1, warmup=0)
            lib_ms = library(lambda: w8_lib(x, w, ws, bvec, kind), reps)
            entry(name, "w8a8_matmul.cu", "lightx2v_tpu/ops/pallas/w8a8_matmul.py:182",
                  f"x ({m},{k}) bf16; w ({n},{k}) {kind}", err, "2^-7*max|ref|", ms, plain_ms, 2.0 * m * n * k,
                  m * k * 2 + n * k + n * 8 + m * n * 2, peak_int8, lib_ms,
                  "torch quantize + " + ("torch._int_mm + torch scaling" if kind == "int8"
                                         else "torch._scaled_mm (row-wise scales, bias, bf16 out)"), note)
            del w, ws
        if note.startswith("hunyuan") and (want("int4_matmul") or want("w4a8_matmul")):
            group = _pick_bk(k)
            w = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
            ws = (0.5 + torch.rand((n, k // group), generator=g, device=dev)) * (0.02 / 7)
            nbytes = m * k * 2 + n * k // 2 + ws.numel() * 4 + n * 4 + m * n * 2
            shape = f"x ({m},{k}) bf16; w ({n},{k // 2}) u8 + ({n},{k // group}) fp32"
            if want("int4_matmul"):
                out = i4.int4_matmul(x, w, ws, bvec)
                torch.cuda.synchronize()
                # bar: exact bf16 x int4 products, per-group fp32 rescale; sums
                # inside a group in another order (row 11's bar)
                err = check_close(f"int4_matmul {note} M={m}", out, i4.int4_matmul_plain(x, w, ws, bvec), 2 ** -7,
                                  0.0)
                del out
                lib_ms = library(lambda: torch.matmul(x, i4.unpack_int4(w, ws).to(torch.bfloat16).t()), reps)
                entry("int4_matmul", "int4_matmul.cu", "lightx2v_tpu/ops/pallas/int4_matmul.py:102", shape, err,
                      "2^-7*max|ref|", cuda_ms(lambda: i4.int4_matmul(x, w, ws, bvec), reps),
                      cuda_ms(lambda: i4.int4_matmul_plain(x, w, ws, bvec), 1, warmup=0), 2.0 * m * n * k, nbytes,
                      peak_bf16,
                      lib_ms, "dequantize to bf16 in torch + torch.matmul", note)
            if want("w4a8_matmul"):
                out = w4.w4a8_matmul(x, w, ws, bvec)
                torch.cuda.synchronize()
                # bar: identical int8 codes, exact int32 group sums, the same
                # fp32 order (row 8's bar)
                err = check_close(f"w4a8_matmul {note} M={m}", out, w4.w4a8_matmul_plain(x, w, ws, bvec), 2 ** -7,
                                  0.0)
                del out
                entry("w4a8_matmul", "w4a8_matmul.cu", "lightx2v_tpu/ops/pallas/w8a8_matmul.py:585", shape, err,
                      "2^-7*max|ref|", cuda_ms(lambda: w4.w4a8_matmul(x, w, ws, bvec), reps),
                      cuda_ms(lambda: w4.w4a8_matmul_plain(x, w, ws, bvec), 1, warmup=0), 2.0 * m * n * k, nbytes,
                      peak_int8,
                      None, "none (no single PyTorch call computes per-group-scaled int4 x int8)", note)
            del w, ws
        del x
        torch.cuda.empty_cache()
    return out_rows


def kernel_phase_wan_runners(peaks, reps: int, want):
    """The dense flash kernel (row 2) at the other Wan runners' shapes:
    CausVid's AR block, q (1, 10,920, 40, 128) against its 32,760-slot KV
    cache at kv_len 21,840 (the second block, V = 1e4 in the stale slots
    past it) and 32,760 (the last block); SkyReels-V2-DF's CFG batch, q, k,
    v (2, 51,000, 40, 128), a ragged last tile, checked on its first and
    last 2,048 query rows. Each beside SDPA on the same q and the valid
    keys; the plain versions are checked on 2 heads and not timed (their
    logits take 57 GB and 830 GB). Returns ``other_shapes`` entries."""
    import torch
    import torch.nn.functional as F

    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    if not want("flash_attention"):
        return []
    peak_bf16, _, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    hs, out_rows = slice(0, 2), []

    def entry(shape, err, ms, lib_ms, flops, nbytes, note):
        b_ms, b_by = bound(flops, nbytes, peak_bf16, peak_bw)
        print(f"[flash_attention_{note}] {ms:.3f} ms ({b_ms / ms:.0%} of its {b_ms:.2f} ms bound, {flops:.3e} "
              f"FLOP); SDPA {lib_ms} ms", flush=True)
        out_rows.append(dict(name="flash_attention", route="cuda", source="lightx2v_tpu_torch/csrc/flash_attention.cu",
                             replaces="lightx2v_tpu/ops/pallas/flash_attention.py:409", shape=shape + f" ({note})",
                             max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms, plain_ms=None,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             library_call="F.scaled_dot_product_attention on the valid keys"))

    # ---- CausVid: one AR block's queries against the KV cache ----
    blk, cache = CV_BLOCK_TOKENS, CV_WINDOW
    q, k, v = randn(1, blk, HEADS, HD), randn(1, cache, HEADS, HD), randn(1, cache, HEADS, HD)
    for kv in (2 * blk, cache):
        if kv < cache:
            v[:, kv:] = 1e4  # a re-anchored cache's stale slots: a kernel that reads one fails by orders of magnitude
        out = fa.flash_attention(q, k, v, kv_len=kv)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs], kv)
        err = check_close(f"flash_attention CausVid block kv_len {kv}", out[:, :, hs], ref, 2e-2, 1e-3)
        del out, ref
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, kv_len=kv), reps)
        kt, vt = k[:, :kv].transpose(1, 2), v[:, :kv].transpose(1, 2)
        lib_ms = library(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kt, vt), reps)
        del kt, vt
        entry(f"q (1,{blk},{HEADS},{HD}); k,v cache (1,{cache},{HEADS},{HD}) bf16, kv_len {kv}", err, ms, lib_ms,
              4.0 * HEADS * blk * kv * HD, (2 * blk + 2 * kv) * HEADS * HD * 2, f"causvid_kv{kv}")
        v.normal_(generator=g)
    del q, k, v

    # ---- SkyReels-V2-DF: CFG's batch of two at 544 x 960, 97 frames ----
    s_df = DF_TOKENS
    q, k, v = (randn(2, s_df, HEADS, HD) for _ in range(3))
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    err = 0.0
    for rows in (slice(0, 2048), slice(s_df - 2048, s_df)):  # the first tiles and the ragged last one
        ref = fa.flash_attention_plain(q[:, rows, hs], k[:, :, hs], v[:, :, hs])
        err = max(err, check_close(f"flash_attention DF rows {rows.start}-{rows.stop}", out[:, rows, hs], ref,
                                   2e-2, 1e-3))
        del ref
    del out
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), reps)
    lib_ms = library(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                            v.transpose(1, 2)), reps)
    entry(f"q,k,v (2,{s_df},{HEADS},{HD}) bf16", err, ms, lib_ms, 4.0 * 2 * HEADS * s_df * s_df * HD,
          4 * 2 * s_df * HEADS * HD * 2, "skyreels_df")
    del q, k, v
    torch.cuda.empty_cache()
    return out_rows


def kernel_phase_dist_ranks(peaks, reps: int, want):
    """One rank's kernel work in the dist configs' own sp = 4 layout at full
    width (S = 32,760 tokens, 40 heads of 128, a batch of 1 per dp rank).
    Ring: rank 0's queries, (1, 8,190, 40, 128), against the four 8,190-key
    chunks in the ring's order (its own, then 3, 2, 1), each a row-5 partial
    (flash with LSE); the last chunk masks a pad tail of ``DIST_PAD`` keys
    whose V is 1e4; the partials merged by ``merge_partials`` and held against
    row 2 over the whole key set at its kv_len, at row 2's bar. Ulysses: row
    2 at (1, 32,760, 10, 128), one rank's head slice after the all-to-all,
    held against its plain version on 2 heads. Each beside its library call
    (SDPA; for row 5 ``aten._scaled_dot_product_flash_attention`` with its
    logsumexp). Returns ``other_shapes`` entries."""
    import torch
    import torch.nn.functional as F

    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa
    from lightx2v_tpu_torch.parallel.ring import merge_partials

    if not (want("flash_attention") or want("flash_attention_with_lse")):
        return []
    peak_bf16, _, peak_bw = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    hs, out_rows, chunk = slice(0, 2), [], S // DIST_SP
    src = "lightx2v_tpu_torch/csrc/flash_attention.cu"

    # ---- ring: four row-5 partials of rank 0, merged, against row 2 over all keys ----
    q, k, v = randn(1, chunk, HEADS, HD), randn(1, S, HEADS, HD), randn(1, S, HEADS, HD)
    kv_len = S - DIST_PAD
    v[:, kv_len:] = 1e4  # the pad rows: a partial that reads one fails by orders of magnitude
    order = [(0 - t) % DIST_SP for t in range(DIST_SP)]  # the chunk rank 0 holds after t rotations

    def part(c):
        lim = chunk - DIST_PAD if c == DIST_SP - 1 else None
        return fa.flash_attention_with_lse(q, k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk],
                                           kv_len=lim)

    def ring():
        out, lse = part(order[0])
        for c in order[1:]:
            out, lse = merge_partials(out, lse, *part(c))
        return out

    merged = ring()
    ref = fa.flash_attention(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    # bar: row 2's; each partial is rounded to bf16 before the fp32 merge, then once more
    err = check_close("ring: 4 merged row-5 partials (pad tail masked) vs row 2 over all keys", merged, ref, 2e-2, 1e-3)
    last = DIST_SP - 1
    lo, ll = part(last)
    plo, pll = fa.flash_attention_with_lse_plain(q[:, :, hs], k[:, last * chunk:, hs], v[:, last * chunk:, hs],
                                                 kv_len=chunk - DIST_PAD)
    check_close("ring: the masked partial vs its plain version (out)", lo[:, :, hs], plo, 2e-2, 1e-3)
    check_close("ring: the masked partial vs its plain version (lse)", ll[:, :, hs], pll, 0.0, 1e-3)
    del merged, ref, lo, ll, plo, pll
    kc, vc = k[:, :chunk].contiguous(), v[:, :chunk].contiguous()
    ms = cuda_ms(lambda: fa.flash_attention_with_lse(q, kc, vc), reps)
    plain_ms = cuda_ms(lambda: fa.flash_attention_with_lse_plain(q, kc, vc), 1, warmup=0)
    lib_ms = library(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2))[:2], reps)
    ring_ms = cuda_ms(ring, reps)
    flops = 4.0 * HEADS * chunk * chunk * HD
    b_ms, b_by = bound(flops, (2 * q.numel() + 2 * kc.numel()) * 2 + q.numel() // HD * 4, peak_bf16, peak_bw)
    print(f"[dist_ranks ring] partial {ms:.3f} ms ({b_ms / ms:.0%} of its {b_ms:.2f} ms bound); 4 partials + 3 "
          f"merges {ring_ms:.3f} ms; aten flash with lse {lib_ms} ms", flush=True)
    out_rows.append(dict(name="flash_attention_with_lse", route="cuda", source=src,
                         replaces="lightx2v_tpu/ops/pallas/flash_attention.py:432",
                         shape=f"q,k,v ({1},{chunk},{HEADS},{HD}) bf16 (dist_ranks ring: one partial of rank 0 of "
                               f"sp {DIST_SP})",
                         max_abs_err=err, bar="merged vs row 2: 2e-2*max|ref| + 1e-3", ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_call="aten._scaled_dot_product_flash_attention (output and logsumexp)",
                         ring_step_ms=ring_ms, launches_per_forward=DIST_SP * 40))
    del q, k, v, kc, vc

    # ---- Ulysses: row 2 on one rank's head slice of the whole sequence ----
    hu = HEADS // DIST_SP
    q, k, v = randn(1, S, hu, HD), randn(1, S, hu, HD), randn(1, S, hu, HD)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs])
    err = check_close(f"flash_attention dist_ranks Ulysses (1,{S},{hu},{HD})", out[:, :, hs], ref, 2e-2, 1e-3)
    del out, ref
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), reps)
    lib_ms = library(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                            v.transpose(1, 2)), reps)
    flops = 4.0 * hu * S * S * HD
    b_ms, b_by = bound(flops, 4 * q.numel() * 2, peak_bf16, peak_bw)
    print(f"[dist_ranks ulysses] {ms:.3f} ms ({b_ms / ms:.0%} of its {b_ms:.2f} ms bound); SDPA {lib_ms} ms",
          flush=True)
    out_rows.append(dict(name="flash_attention", route="cuda", source=src,
                         replaces="lightx2v_tpu/ops/pallas/flash_attention.py:409",
                         shape=f"q,k,v (1,{S},{hu},{HD}) bf16 (dist_ranks Ulysses: one rank's heads of sp {DIST_SP})",
                         max_abs_err=err, bar="2e-2*max|ref| + 1e-3 (2 heads)", ms=ms,
                         plain_ms=None, plain_note="not timed: its logits take 43 GB", bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, library_call="F.scaled_dot_product_attention",
                         launches_per_forward=2 * 40))
    del q, k, v
    torch.cuda.empty_cache()
    return out_rows


def run_dist() -> dict:
    """``DIST_JSON`` at the 14B widths through the user's launcher and entry
    point: ``python -m torch.distributed.run --standalone --nproc_per_node 1
    -m lightx2v_tpu_torch.infer`` with the mesh cut to {"dp": 1, "sp": 1} and
    the schedule to its first ``DIST_STEPS`` steps (``step_window``), bf16
    UMT5-XXL on the prompt and the negative prompt, UniPC with CFG at batch 2,
    the untiled decode (``parallel_vae`` over a mesh of 1 is the plain one),
    the video written by rank 0. Then, in this process, the single-device
    runner on the same config without ``mesh_shape``, built from the same
    command line (``infer.build_parser``), through its encode and denoise.
    Both run under ``PYTHONHASHSEED=0`` (``main`` re-executes the script
    under it), so the synthetic tokenizer, which hashes words with Python's
    ``hash()``, gives both the same ids. Gates: the process exits 0; it saw
    rank 0 of a world of 1 on NCCL; its launch counts are exact (row 2: self
    and cross attention, 80 a forward); its latents equal the single-device
    run's bit for bit; rank 0 wrote the video. Returns the dist run's launch
    counts."""
    import gc

    import numpy as np
    import torch

    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.ops.cuda import launch_counts
    from lightx2v_tpu_torch.utils.config import set_config

    src = json.loads((ROOT / DIST_JSON).read_text())
    want = {k: 0 for k in launch_counts()}
    want["flash_attention"] = 2 * WAN14B["num_layers"] * DIST_STEPS  # RoPE in torch: self + cross a block
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        args = ["--model_cls", "wan2.1", "--synthetic_weights", "--prompt", PROMPT, "--negative_prompt", NEG]
        for name, mesh in (("dist", {"dp": 1, "sp": 1}), ("single", None)):
            cfg = dict(src, **WAN14B, step_window=[0, DIST_STEPS], mesh_shape=mesh)
            (tmp / f"{name}.json").write_text(json.dumps(cfg))
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                            "-m", "lightx2v_tpu_torch.infer", "--config_json", str(tmp / "dist.json"),
                            "--save_video_path", str(tmp / "dist.mp4"), "--save_latents_path", str(tmp / "dist.npy"),
                            *args], cwd=ROOT, env=dict(os.environ, PYTHONHASHSEED="0"), capture_output=True, text=True,
                           timeout=DIST_WAIT)
        dist_wall = time.perf_counter() - t0
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith('{"run": ')]
        print("\n".join(f"[dist] {ln}" for ln in (p.stdout + p.stderr).splitlines()
                        if "[Profile]" in ln or ln.startswith('{"run": ') or "rror" in ln), flush=True)
        if p.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"dist: the torchrun process exited {p.returncode}:\n{p.stderr[-4000:]}")
        dist_run = json.loads(lines[0])["run"]
        lat_d = np.load(tmp / "dist.npy")
        video_mb = (tmp / "dist.mp4").stat().st_size / 1e6 if (tmp / "dist.mp4").exists() else None

        t0 = time.perf_counter()
        runner = infer.init_runner(set_config(infer.build_parser().parse_args(
            ["--config_json", str(tmp / "single.json"), *args])))
        lat_s = runner.run_dit(runner.run_input_encoder()).float().cpu().numpy()
        single_s = time.perf_counter() - t0
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    if (dist_run["rank"], dist_run["world"], dist_run["backend"]) != (0, 1, "nccl"):
        raise AssertionError(f"dist: the rank saw {dist_run['rank']} of {dist_run['world']} on {dist_run['backend']}")
    if dist_run["launch_counts"] != want:
        raise AssertionError(f"dist: launch counts {dist_run['launch_counts']} != {want}")
    if lat_d.shape != (16, 21, 60, 104) or not np.isfinite(lat_d).all():
        raise AssertionError(f"dist: bad latents {lat_d.shape}")
    equal = bool(np.array_equal(lat_d, lat_s))
    if not equal:
        raise AssertionError(f"dist: latents differ from the single-device run's by up to "
                             f"{float(np.abs(lat_d - lat_s).max())}")
    if not video_mb:
        raise AssertionError("dist: rank 0 wrote no video")
    print(json.dumps({"path": "dist", "launch_counts": dist_run["launch_counts"], "expected": want}), flush=True)
    print(json.dumps({"dist": {"rank": dist_run["rank"], "world": dist_run["world"], "backend": dist_run["backend"],
                               "device": dist_run["device"], "mesh": dist_run["mesh"], "stage_s": dist_run["stage_s"],
                               "peak_mem_gb": dist_run["peak_mem_gb"],
                               "mem_gb_by_stage": dist_run["mem_gb_by_stage"], "process_s": dist_wall,
                               "single_load_encode_dit_s": single_s, "latents_bitwise_equal": equal,
                               "video_mb": video_mb, "steps": DIST_STEPS,
                               "cuts": {"mesh_shape": [src["mesh_shape"], {"dp": 1, "sp": 1}],
                                        "steps": [src["infer_steps"], DIST_STEPS]}}}), flush=True)
    return dist_run["launch_counts"]


# ---------------------------------------------------------------------------
# slice phase


def _to(tree, dev):
    """A params tree (dicts, lists, tensors) with every tensor on ``dev``."""
    import torch

    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def block_reference_check(scheme: str = "int8", mm_type: str = INT8, self_attn_type: str = "flash_attn3",
                          rtol: float = 3e-2, perturbation: bool = False, i2v: bool = False):
    """One full-width quantized DiT block (kernel thresholds engaged) on a
    small input: CUDA kernels vs the plain versions on the CPU, same
    weights, dense fused-RoPE flash self-attention (or ``self_attn_type``).
    With ``i2v`` the block is the i2v one: 36 input channels (``y``) and the
    image cross-attention over 257 CLIP tokens beside the text.
    With ``perturbation`` it also prints how far the CPU block moves when one
    bf16 ulp is added to 1% of the context entries: the block's sensitivity
    to bf16-level noise, which the card-vs-CPU difference is made of."""
    import dataclasses

    import torch

    from lightx2v_tpu_torch.models.wan.config import PRESETS, WanArch
    from lightx2v_tpu_torch.models.wan.model import wan_forward
    from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape
    from lightx2v_tpu_torch.models.wan.weights import init_random_params_on_device, permute_qk_half

    arch = dataclasses.replace(WanArch(**PRESETS["wan2.1_14b"]), num_layers=1, rope_fused=True,
                               **(dict(task="i2v", in_dim=36) if i2v else {}))
    params = permute_qk_half(init_random_params_on_device(arch, scheme, seed=3, device="cuda"), arch)
    g = torch.Generator(device="cuda").manual_seed(4)
    shape = (16, 2, 8, 12)  # 48 tokens
    lat = torch.randn((1, *shape), generator=g, device="cuda")
    ctx = (torch.randn((1, TXT, arch.text_dim), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    t = torch.tensor([750.0], device="cuda")
    cond = {}
    if i2v:
        cond = dict(y=torch.randn((1, 20, *shape[1:]), generator=g, device="cuda"),
                    clip_fea=torch.randn((1, IMG, arch.clip_dim), generator=g, device="cuda"))

    def run(dev):
        cos, sin, _ = rope_for_shape(arch, shape, device=dev)
        return wan_forward(_to(params, dev), lat.to(dev), t.to(dev), context.to(dev), cos, sin, arch,
                           mm_type=mm_type, self_attn_type=self_attn_type, **_to(cond, dev))

    context = ctx
    out = run("cuda")
    torch.cuda.synchronize()
    ref = run("cpu")
    if perturbation:
        flip = torch.rand(ctx.shape, generator=g, device="cuda") < 0.01
        context = torch.where(flip, (ctx.float() * (1 + 2 ** -7)).to(torch.bfloat16), ctx)
        moved = float((run("cpu") - ref).abs().max())
        print(json.dumps({"block_perturbation": {"scheme": scheme, "max_abs_moved": moved,
                                                 "share_of_max": moved / float(ref.abs().max())}}), flush=True)
    # bar: the DiT's bf16 activations pass two flash calls and the
    # quantized GEMMs; summation order and rare rounding flips stay at bf16
    # noise (rtol 3e-2), which each quantized GEMM then amplifies where it
    # moves an activation across a code boundary (see the fp8 call)
    kind = "i2v " if i2v else ""
    return check_close(f"one 14B {kind}{scheme} block ({mm_type}, {self_attn_type}), card vs CPU plain", out.cpu(),
                       ref, rtol, 1e-3)


def caching_reference_check():
    """The caching steps at the Wan2.1-1.3B width (2 of its 30 blocks, bf16
    linears, fused-RoPE flash) on a small latent (48 tokens) at CFG's batch
    of two: the card vs the plain versions on the CPU, same weights and
    inputs. TaylorSeer's calc step twice (unprimed, then at dt 4) and a skip
    step at dt 1, and a per-side Tea step where only the cond side computes
    (its forward at batch 1, the uncond side's residual replayed)."""
    import dataclasses
    from functools import partial

    import torch

    from lightx2v_tpu_torch.caching import taylorseer, teacache
    from lightx2v_tpu_torch.models.wan.config import PRESETS, WanArch
    from lightx2v_tpu_torch.models.wan.model import wan_transformer
    from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape
    from lightx2v_tpu_torch.models.wan.weights import init_random_params_on_device, permute_qk_half
    from lightx2v_tpu_torch.ops.attention import attention

    arch = dataclasses.replace(WanArch(**PRESETS["wan2.1_1.3b"]), num_layers=2, rope_fused=True)
    params = permute_qk_half(init_random_params_on_device(arch, "bf16", seed=3, device="cuda"), arch)
    g = torch.Generator(device="cuda").manual_seed(5)
    shape, s = (16, 2, 8, 12), 48
    xs = [torch.randn((2, s, arch.dim), generator=g, device="cuda").to(torch.bfloat16) for _ in range(3)]
    e0 = torch.randn((2, 6, arch.dim), generator=g, device="cuda") * 0.1
    ctx = (torch.randn((2, TXT, arch.dim), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    fns = dict(self_attn_fn=partial(attention, "flash_attn3"), cross_attn_fn=partial(attention, "flash_attn3"))

    def run(dev):
        p, (x0, x1, x2), e, c = _to(params, dev), [v.to(dev) for v in xs], e0.to(dev), ctx.to(dev)
        cos, sin, _ = rope_for_shape(arch, shape, device=dev)
        cache = taylorseer.init_taylor_cache(arch, 2, s, device=dev)
        taylorseer.taylor_calc_step(p, x0, e, c, None, cos, sin, arch, cache, 1.0, primed=False, **fns)
        calc, _ = taylorseer.taylor_calc_step(p, x1, e, c, None, cos, sin, arch, cache, 4.0, **fns)
        skip = taylorseer.taylor_skip_step(p, x2, e, arch, cache, 1.0)

        def tf(xx, side=None):
            rows = slice(None) if side is None else slice(side, side + 1)
            return wan_transformer(p["blocks"], xx, e[rows], c[rows], None, cos, sin, arch)

        state = teacache.init_tea_state((2, s, arch.dim), (2, arch.dim), device=dev)
        state["prev_residual"] = x2.clone()
        tea, _ = teacache.tea_transform_per_side(state, torch.tensor([True, False]), x0, tf, tf)
        return calc, skip, tea, cache["ffn"]["f1"]

    out = run("cuda")
    torch.cuda.synchronize()
    ref = run("cpu")
    # bar: as the full-width blocks', bf16 activations through flash calls
    # and bf16 GEMMs summed in another order
    return max(check_close(f"1.3B caching, card vs CPU plain: {what}", o.cpu(), r, 3e-2, 1e-3)
               for what, o, r in zip(("TaylorSeer calc", "TaylorSeer skip", "per-side Tea (cond only)",
                                      "TaylorSeer ffn f1"), out, ref))


def clip_reference_check():
    """The full-width CLIP ViT-H/14 tower (31 blocks, 257 tokens), bf16 and
    with ``quantize_clip_params`` int8, on the card vs the same arithmetic on
    the CPU, on one seeded 480 x 832 image: the embedding, then each block
    on the card's input to it. The blocks are held one by one because the
    random-weight tower amplifies bf16-level noise from block to block, so
    whole-tower outputs would differ by that amplified noise, not by a
    fault."""
    import numpy as np
    import torch

    from lightx2v_tpu_torch.encoders import clip

    arch = clip.ClipVisionArch()
    params = clip.init_random_clip_params_on_device(arch, seed=3, device="cuda")
    img = np.random.default_rng(5).uniform(-1, 1, (480, 832, 3)).astype(np.float32)
    px = torch.from_numpy(clip.preprocess_image(img, arch.image_size))
    rel = lambda a, b: float((a.cpu().float() - b.float()).norm() / b.float().norm())  # noqa: E731
    worst = {}
    for scheme in ("bf16", "int8"):
        p = params if scheme == "bf16" else clip.quantize_clip_params(params, "int8")
        cpu = _to(p, "cpu")
        x = clip.clip_embed(p, px, arch)
        errs = [rel(x, clip.clip_embed(cpu, px, arch))]
        for bp, cbp in zip(p["blocks"], cpu["blocks"]):
            y = clip.clip_block(bp, x, arch)
            errs.append(rel(y, clip.clip_block(cbp, x.cpu(), arch)))
            x = y
        torch.cuda.synchronize()
        worst[scheme] = max(errs)
        # bar: relative L2 1e-2 a stage, the tower's bar against the JAX
        # package on the CPU (bf16 activations; fp32 sums in another order)
        print(f"[check] CLIP ViT-H/14 tower {scheme}, card vs CPU, embedding and each of {len(p['blocks'])} blocks "
              f"on the card's input: worst rel_l2 {worst[scheme]:.3e} (bar 1e-2)", flush=True)
        if not (torch.isfinite(x.float()).all() and x.shape == (1, 257, arch.dim) and worst[scheme] <= 1e-2):
            raise AssertionError(f"CLIP tower {scheme}: worst rel_l2 {worst[scheme]}, shape {tuple(x.shape)}")
        del p, cpu
    return worst


def vae_encode_check():
    """The full Wan VAE's encode of a short clip (5 frames of 64 x 64) on the
    card (TF32 convolutions) vs the CPU (fp32)."""
    import numpy as np
    import torch

    from lightx2v_tpu_torch.vae import wan_vae

    cfg = wan_vae.WanVAEConfig()
    sd = wan_vae.init_random_vae_state_dict(cfg, seed=2)
    x = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (1, 5, 64, 64, 3)).astype(np.float32))
    out = wan_vae.vae_encode(wan_vae.load_wan_vae_params(sd, cfg, device="cuda"), x.to("cuda"), cfg)
    torch.cuda.synchronize()
    ref = wan_vae.vae_encode(wan_vae.load_wan_vae_params(sd, cfg), x, cfg)
    rel = float((out.cpu() - ref).norm() / ref.norm())
    print(json.dumps({"vae_encode_check": {"shape": list(out.shape), "rel_l2": rel}}), flush=True)
    # bar: TF32 rounds each conv's inputs to 10 mantissa bits (~5e-4
    # relative) on the card; the CPU convolves in fp32
    return check_close("Wan VAE encode 5x64x64, card (TF32) vs CPU (fp32)", out.cpu(), ref, 2e-2, 1e-3)


def cog_block_reference_check(scheme: str = "bf16", mm_type: str = "Default"):
    """One full-width CogVideoX1.5-5B block (48 heads of 64, dim 3072, the
    226-token text stream) on a small latent (16 x 3 x 8 x 12, padded to 4
    frames: 2 x 4 x 6 = 48 video tokens) at CFG's batch of 2: the card (the
    64-wide flash kernel; with ``scheme`` int8 or fp8 the full-K 8-bit GEMM
    for its 8 linears) vs the plain versions on the CPU, same weights."""
    import dataclasses

    import torch

    from lightx2v_tpu_torch.models.cogvideox.config import CogArch, build_cog_rope
    from lightx2v_tpu_torch.models.cogvideox.model import CogTransformer
    from lightx2v_tpu_torch.models.cogvideox.weights import init_random_cog_params_on_device
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa
    from lightx2v_tpu_torch.ops.cuda import launch_counts

    arch = dataclasses.replace(CogArch(), num_layers=1)
    params = init_random_cog_params_on_device(arch, scheme, seed=3, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    lat = torch.randn((2, 16, 3, 8, 12), generator=g, device="cuda").to(torch.bfloat16)
    ctx = (torch.randn((2, arch.text_len, arch.text_dim), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    t = torch.tensor([999.0, 999.0], device="cuda")
    cos, sin = (torch.from_numpy(a) for a in build_cog_rope(arch, 2, 4, 6))

    def run(dev):
        return CogTransformer(_to(params, dev), arch)(lat.to(dev), t.to(dev), ctx.to(dev), cos.to(dev), sin.to(dev),
                                                      mm_type=mm_type)

    before = launch_counts()
    out = run("cuda")
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    want = {"flash_attention_d64": 1, **({} if scheme == "bf16" else
                                         {"w8a8_matmul_fullk" + ("_fp8" if scheme == "fp8" else ""): 8})}
    if moved != want:
        raise AssertionError(f"the CogVideoX {scheme} block launched {moved}, not {want}")
    # bar: as the 14B int8 block's, bf16 activations through one flash call
    # and bf16 (or 8-bit) GEMMs summed in another order
    return check_close(f"one CogVideoX1.5-5B block ({scheme}, flash_attn3 at head dim 64), card vs CPU plain",
                       out.cpu(), run("cpu"), 3e-2, 1e-3)


def cog_vae_decode_check():
    """The full CogVideoX VAE's frame-batched decode of 3 x 4 x 6 latents
    (chunks [3]; the odd-T first-frame split) and of 5 (chunks [3, 2], the
    conv caches carried) on the card (TF32 convolutions) vs the CPU (fp32)."""
    import numpy as np
    import torch

    from lightx2v_tpu_torch.vae import cogvideox_vae as cv

    cfg = cv.CogVAEConfig()
    sd = cv.init_random_cog_vae_state_dict(cfg, seed=2)
    pc, pg = cv.load_cog_vae_params(sd, cfg), cv.load_cog_vae_params(sd, cfg, device="cuda")
    errs = []
    for t in (3, 5):
        z = torch.from_numpy(np.random.default_rng(t).standard_normal((1, t, 4, 6, 16)).astype(np.float32))
        out = cv.cog_vae_decode_chunked(pg, z.to("cuda"), cfg, scale=True)
        torch.cuda.synchronize()
        ref = cv.cog_vae_decode_chunked(pc, z, cfg, scale=True)
        if out.shape != (1, 4 * t - 3, 32, 48, 3):
            raise AssertionError(f"CogVideoX VAE decode: shape {tuple(out.shape)}")
        # bar: TF32 rounds each conv's inputs to 10 mantissa bits on the card
        errs.append(check_close(f"CogVideoX VAE decode {t}x4x6, card (TF32) vs CPU (fp32)", out.cpu(), ref, 2e-2,
                                1e-3))
    return max(errs)


def hunyuan_block_reference_check(scheme: str = "bf16", mm_type: str = "Default"):
    """One full-width HunyuanVideo double-stream and one single-stream block
    (hidden 3072, 24 heads of 128, with the text refiner and the head around
    them) on a small input (16 x 2 x 8 x 8 latents: 32 image tokens; 32
    text tokens, 20 valid, so kv_len 52 of 64 keys): the card (two flash
    calls; with ``scheme`` int8 the full-K 8-bit GEMM for the blocks' 13
    linears, the modulation projections at M = 1) vs the plain versions on
    the CPU, same weights."""
    import dataclasses

    import numpy as np
    import torch

    from lightx2v_tpu_torch.models.hunyuan.config import HunyuanArch
    from lightx2v_tpu_torch.models.hunyuan.model import HunyuanTransformer, build_hunyuan_rope, text_kv_len
    from lightx2v_tpu_torch.models.hunyuan.weights import init_random_hunyuan_params_on_device
    from lightx2v_tpu_torch.ops.cuda import launch_counts

    arch = dataclasses.replace(HunyuanArch(), double_blocks=1, single_blocks=1)
    params = init_random_hunyuan_params_on_device(arch, seed=3, device="cuda", scheme=scheme)
    g = torch.Generator(device="cuda").manual_seed(4)
    lat = torch.randn((1, 16, 2, 8, 8), generator=g, device="cuda").to(torch.bfloat16)
    states = (torch.randn((1, 32, arch.text_states_dim), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    pooled = torch.randn((1, arch.text_states_dim_2), generator=g, device="cuda") * 0.5
    mask = np.zeros((1, 32), np.int32)
    mask[0, :20] = 1
    t, guidance = torch.tensor([999.0]), torch.tensor([6000.0])
    cos, sin = (torch.from_numpy(a) for a in build_hunyuan_rope(arch, 2, 4, 4))

    def run(dev):
        return HunyuanTransformer(_to(params, dev), arch)(
            lat.to(dev), t.to(dev), states.to(dev), torch.from_numpy(mask).to(dev), pooled.to(dev), cos.to(dev),
            sin.to(dev), text_kv_len(32, mask), guidance.to(dev), mm_type=mm_type)

    before = launch_counts()
    out = run("cuda")
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    want = {"flash_attention": 2, **({"w8a8_matmul_fullk": 13} if scheme == "int8" else {})}
    if moved != want:
        raise AssertionError(f"the Hunyuan {scheme} blocks launched {moved}, not {want}")
    # bar: as the CogVideoX block's, bf16 activations through two flash calls
    # and bf16 GEMMs summed in another order; int8 as the 14B int8 block's
    return check_close(f"one HunyuanVideo double + single block ({scheme}, flash_attn3, kv_len 52 of 64), card vs "
                       "CPU plain", out.cpu(), run("cpu"), 3e-2, 1e-3)


def hunyuan_vae_decode_check():
    """The full HunyuanVideo VAE's decode of 3 x 4 x 6 latents (the mid
    block's frame-causal attention, the first frame upsampled in space only)
    on the card (TF32 convolutions) vs the CPU (fp32)."""
    import numpy as np
    import torch

    from lightx2v_tpu_torch.vae import hunyuan_vae as hv

    cfg = hv.HunyuanVAEConfig()
    sd = hv.init_random_hunyuan_vae_state_dict(cfg, seed=2)
    pc, pg = hv.load_hunyuan_vae_params(sd, cfg), hv.load_hunyuan_vae_params(sd, cfg, device="cuda")
    z = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 3, 4, 6, 16)).astype(np.float32))
    out = hv.hunyuan_vae_decode(pg, z.to("cuda"), cfg, scale=True)
    torch.cuda.synchronize()
    if out.shape != (1, 9, 32, 48, 3):
        raise AssertionError(f"Hunyuan VAE decode: shape {tuple(out.shape)}")
    # bar: TF32 rounds each conv's inputs to 10 mantissa bits on the card
    return check_close("Hunyuan VAE decode 3x4x6, card (TF32) vs CPU (fp32)", out.cpu(),
                       hv.hunyuan_vae_decode(pc, z, cfg, scale=True), 2e-2, 1e-3)


def tree_checksums(tree, prefix: str = "") -> dict:
    """{leaf path: [sum, position-weighted sum]} of a params tree's tensors,
    each over its elements' bits as integers (exact: a changed, moved or
    truncated element changes them), on the tensors' device."""
    import torch

    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in tree_checksums(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in tree_checksums(sub, f"{prefix}{i}.").items()}
    if tree is None:
        return {}
    bits = tree.detach().contiguous().reshape(-1).view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        tree.element_size()])
    total, weighted, off = 0, 0, 0
    for part in bits.split(1 << 26):
        x = part.to(torch.int64)
        pos = torch.arange(off, off + x.numel(), device=x.device) % 65_521 + 1
        total, weighted, off = total + int(x.sum()), weighted + int((x * pos).sum()), off + x.numel()
    return {prefix[:-1]: [total, weighted, str(tree.dtype), list(tree.shape)]}


def save_sharded(sd: dict, out: Path, shard_gb: float = HY_SHARD_GB) -> None:
    """``sd`` as HF's sharded safetensors: ``model-0000i-of-0000n.safetensors``
    of at most ``shard_gb`` each, in key order, and
    ``model.safetensors.index.json``."""
    from lightx2v_tpu_torch.utils.safetensors_io import save_file

    shards, size = [[]], 0
    for k, v in sd.items():
        nbytes = v.numel() * v.element_size()
        if shards[-1] and size + nbytes > shard_gb * 1e9:
            shards.append([])
            size = 0
        shards[-1].append(k)
        size += nbytes
    names = [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors" for i in range(len(shards))]
    for name, keys in zip(names, shards):
        save_file({k: sd[k] for k in keys}, str(out / name))
    total = sum(v.numel() * v.element_size() for v in sd.values())
    (out / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": {k: n for n, keys in zip(names, shards) for k in keys}}))


def pick_dir(need_gb: float, what: str) -> Path:
    """The system temp directory or the repo's git-ignored ``build/``,
    the first with ``need_gb`` free; fails loudly when neither has it."""
    import shutil

    cands = [Path(tempfile.gettempdir()), ROOT / "build"]
    (ROOT / "build").mkdir(exist_ok=True)
    free = {str(c): shutil.disk_usage(c).free / 1e9 for c in cands}
    print(json.dumps({f"{what}_disk_free_gb": free, "need_gb": need_gb}), flush=True)
    for c in cands:
        if free[str(c)] >= need_gb:
            return c
    raise AssertionError(f"{what}: no directory has the {need_gb} GB its files need: free {free}")


def write_hunyuan_model_dir(root: Path) -> dict:
    """The full-width HunyuanVideo model directory of the reference layout
    under ``root``, from the device synthesizers (the seeds the synthetic
    runner uses): ``hunyuan-video-t2v-720p/transformers/
    mp_rank_00_model_states.pt`` (the DiT, 25.4 GB bf16, under
    ``"module"``), ``.../vae/pytorch_model.pt`` (the VAE, fp32, under
    ``"state_dict"`` with ``vae.`` keys), ``text_encoder/`` (an HF
    ``LlamaForCausalLM`` directory: ``config.json`` and safetensors shards
    of at most ``HY_SHARD_GB`` with their index: the 30 blocks the encoder
    runs, then the two it skips, the final norm and ``lm_head``, zeros,
    which the reader must not read) and ``text_encoder_2/`` (an HF
    ``CLIPTextModel`` directory). Each component is made on the card,
    checksummed there (``tree_checksums`` of the params the runner should
    load), written one tensor at a time and released before the next.
    Returns the checksums, the write seconds and GB per component."""
    import numpy as np
    import torch

    from lightx2v_tpu_torch.encoders.clip import (ClipTextArch, clip_text_hf_config,
                                                  clip_text_params_to_hf_state_dict,
                                                  init_random_clip_text_params_on_device)
    from lightx2v_tpu_torch.encoders.llama import (LLAVA_LLAMA3_8B, init_random_llama_params_on_device,
                                                   llama_hf_config, llama_params_to_hf_state_dict)
    from lightx2v_tpu_torch.models.hunyuan.config import HunyuanArch
    from lightx2v_tpu_torch.models.hunyuan.weights import (hunyuan_params_to_state_dict,
                                                           init_random_hunyuan_params_on_device)
    from lightx2v_tpu_torch.utils.safetensors_io import save_file
    from lightx2v_tpu_torch.vae import hunyuan_vae as hv

    sums, times, sizes = {}, {}, {}
    base = root / "hunyuan-video-t2v-720p"

    def timed(name, write, files):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write()
        times[name] = time.perf_counter() - t0
        sizes[name] = sum(f.stat().st_size for d in files for f in (d.rglob("*") if d.is_dir() else [d])
                          if f.is_file()) / 1e9

    arch = HunyuanArch()
    params = init_random_hunyuan_params_on_device(arch, seed=0, device="cuda")
    sums["dit"] = tree_checksums(params)
    (base / "transformers").mkdir(parents=True)
    dit_pt = base / "transformers" / "mp_rank_00_model_states.pt"
    timed("dit", lambda: torch.save({"module": hunyuan_params_to_state_dict(params, arch)}, dit_pt), [dit_pt])
    del params
    torch.cuda.empty_cache()

    llama = LLAVA_LLAMA3_8B
    params = init_random_llama_params_on_device(llama, seed=1, device="cuda")
    sums["llama"] = tree_checksums(params)
    zero = {k: torch.zeros_like(v) for k, v in params["blocks"][0].items()}
    # the blocks past the crop layer, the final norm and lm_head: written, never read
    sd = llama_params_to_hf_state_dict({**params, "blocks": params["blocks"] + [zero] * llama.hidden_state_skip_layer})
    sd["model.norm.weight"] = torch.ones((llama.dim,), dtype=torch.bfloat16, device="cuda")
    sd["lm_head.weight"] = torch.zeros((llama.vocab_size, llama.dim), dtype=torch.bfloat16, device="cuda")
    te = root / "text_encoder"
    te.mkdir()
    (te / "config.json").write_text(json.dumps(llama_hf_config(llama)))
    timed("llama", lambda: save_sharded(sd, te), [te])
    del params, sd
    torch.cuda.empty_cache()

    clip = ClipTextArch()
    params = init_random_clip_text_params_on_device(clip, seed=3, device="cuda")
    sums["clip"] = tree_checksums(params)
    te2 = root / "text_encoder_2"
    te2.mkdir()
    (te2 / "config.json").write_text(json.dumps(clip_text_hf_config(clip)))
    timed("clip", lambda: save_file(clip_text_params_to_hf_state_dict(params), str(te2 / "model.safetensors")),
          [te2])
    del params

    cfg = hv.HunyuanVAEConfig()
    vsd = hv.init_random_hunyuan_vae_state_dict(cfg, seed=2)
    sums["vae"] = tree_checksums(hv.load_hunyuan_vae_params(vsd, cfg, device="cuda"))
    (base / "vae").mkdir()
    vae_pt = base / "vae" / "pytorch_model.pt"
    timed("vae", lambda: torch.save({"state_dict": {f"vae.{k}": torch.from_numpy(np.ascontiguousarray(v))
                                                    for k, v in vsd.items()}}, vae_pt), [vae_pt])
    del vsd
    torch.cuda.empty_cache()
    gb = sum(sizes.values())
    written = {"write_s": times, "files_gb": sizes, "write_gb_s": gb / sum(times.values()),
               "leaves": {k: len(v) for k, v in sums.items()}, "card": card_line()}
    print(json.dumps({"hunyuan_write": written}), flush=True)
    return {**written, "checksums": sums}


def run_hunyuan_from_files(profile_dir=None):
    """The HunyuanVideo path from files: ``write_hunyuan_model_dir`` into a
    temporary directory (deleted afterwards), then ``configs/hunyuan_t2v.json``
    through the runner with ``model_path`` and ``text_encoder_path`` on it and
    no ``synthetic_weights``, cut to its first ``HY_STEPS`` Euler steps. After
    loading, every tensor the runner holds must equal the synthesized one
    (``tree_checksums``), and the encoders get the synthetic tokenizers
    (difference ah: the card machine has no ``transformers``; a stated test
    double, set here and on every reload). The line adds the write seconds
    and GB/s per component, the load seconds and read GB/s per part."""
    import torch

    from lightx2v_tpu_torch.runners.hunyuan_runner import _SyntheticClipTokenizer, _SyntheticLlamaTokenizer
    from lightx2v_tpu_torch.utils.config import set_config

    with tempfile.TemporaryDirectory(dir=pick_dir(HY_FILES_GB, "hunyuan")) as tmp:
        crc32 = torch.serialization.get_crc32_options()
        torch.serialization.set_crc32_options(False)  # the .pt files without zip CRC32s: torch.load reads none
        try:
            written = write_hunyuan_model_dir(Path(tmp))
        finally:
            torch.serialization.set_crc32_options(crc32)
        cfg = set_config(dict(model_cls="hunyuan", task="t2v", device="cuda", config_json=str(ROOT / HY_JSON),
                              prompt=PROMPT, seed=42, release_modules=True, model_path=tmp,
                              text_encoder_path=tmp))

        def test_tokenizers(encoders):
            encoders["llama"].tokenizer = _SyntheticLlamaTokenizer(encoders["llama"].arch)
            encoders["clip"].tokenizer = _SyntheticClipTokenizer(encoders["clip"].arch)
            return encoders

        def before(runner):
            got = {"dit": tree_checksums(runner.model), "llama": tree_checksums(runner.text_encoder["llama"].params),
                   "clip": tree_checksums(runner.text_encoder["clip"].params), "vae": tree_checksums(runner.vae)}
            for part, want in written["checksums"].items():
                if got[part] != want:
                    bad = sorted(k for k in set(got[part]) | set(want) if got[part].get(k) != want.get(k))
                    raise AssertionError(f"hunyuan from files: {part} differs from the synthesized weights at "
                                         f"{len(bad)} leaves, e.g. {bad[:4]}")
            test_tokenizers(runner.text_encoder)
            load = runner.load_text_encoder
            runner.load_text_encoder = lambda: test_tokenizers(load())
            parts = runner.timings["load_parts_s"]
            files = written["files_gb"]
            read = {"model": files["dit"], "text_encoder": files["llama"] + files["clip"], "vae": files["vae"]}
            return {"write_s": written["write_s"], "files_gb": files, "write_gb_s": written["write_gb_s"],
                    "load_s": runner.timings["load_s"], "load_parts_s": parts,
                    "read_gb_s": {k: v / parts[k] for k, v in read.items()},
                    "loaded_equal_synthesized": {k: len(v) for k, v in got.items()}}

        return run_path("hunyuan", {}, profile_dir, model_cls="hunyuan", cfg=cfg, steps=HY_STEPS, before=before)


def write_image(path: str, seed: int = 0) -> str:
    """A seeded 480 x 832 RGB PNG (smooth colour ramps plus noise)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:480, 0:832] / np.array([480.0, 832.0])[:, None, None]
    ramp = np.stack([yy, xx, 1 - (yy + xx) / 2], axis=-1) * 200
    img = np.clip(ramp + rng.normal(0, 20, ramp.shape), 0, 255).astype(np.uint8)
    Image.fromarray(img).save(path)
    return path


def expected_launches(runner, cfg, forwards=None) -> dict:
    """The exact launch count of every kernel for one pipeline run;
    ``forwards``: the DiT forwards that ran the block stack (a cached or cut
    run; a one-sided per-side forward at batch 1 counts as one), else every
    step's."""
    from lightx2v_tpu_torch.encoders.t5 import T5_LINEARS
    from lightx2v_tpu_torch.ops import radial
    from lightx2v_tpu_torch.ops.cuda import launch_counts

    if cfg["model_cls"] == "cogvideox":  # one 64-wide flash call a block and step; its linears are bf16 torch.mm
        return {**{k: 0 for k in launch_counts()},
                "flash_attention_d64": runner.arch.num_layers * runner.init_scheduler().num_steps()}
    if cfg["model_cls"] == "hunyuan":  # one joint flash call a double or single block and forward; bf16 torch.mm
        blocks = runner.arch.double_blocks + runner.arch.single_blocks
        fwd = forwards if forwards is not None else runner.init_scheduler().num_steps()
        return {**{k: 0 for k in launch_counts()}, "flash_attention": blocks * fwd}
    L = runner.arch.num_layers
    if cfg["model_cls"] in ("wan2.1_causvid", "wan2.1_skyreels_v2_df", "wan2.1_audio"):
        # bf16 Default linears (torch.mm); self- and cross-attention through the dense kernel: the audio runner's
        # radial_attn has no mask map, so it is dense flash, and it feeds the DiT no image context
        return {**{k: 0 for k in launch_counts()}, "flash_attention": 2 * L * forwards}
    steps = len(cfg["denoising_step_list"]) if cfg["model_cls"] == "wan2.1_distill" else int(cfg["infer_steps"])
    if forwards is not None:
        steps = forwards
    elif runner.step_window is not None:
        steps = runner.step_window[1]
    out = {k: 0 for k in launch_counts()}
    calls = L * steps  # one per block and forward (CFG doubles the batch, not the calls)
    mm_type = (cfg.get("mm_config") or {}).get("mm_type", "Default")
    i2v = cfg.get("task") == "i2v"
    # per block: q/k/v/o of both attentions (and i2v's k_img / v_img at M = 257), and the FFN (fused,
    # or two GEMMs around a torch GELU)
    lin = (10 if i2v else 8) * calls
    if mm_type == INT4A8:
        out.update(w4a8_matmul=lin, ffn_w4a8=calls)
    elif mm_type == INT4W:
        out.update(int4_matmul=lin + 2 * calls)
    elif mm_type == FP8:
        out.update(w8a8_matmul_fullk_fp8=lin, ffn_w8a8_fp8=calls)
    elif mm_type == INT8:
        out.update(w8a8_matmul_fullk=lin, ffn_w8a8=calls)
    elif mm_type != "Default":  # Default: the bf16 linears are torch.mm, no kernel of the port
        raise AssertionError(f"no launch model for mm_type {mm_type}")
    if cfg.get("t5_quantized"):
        # T5: q/k/v/o/gate/fc1 full-K (K = 4096), fc2 k-blocked (K = 10,240), in the T5's kind; under CFG it
        # encodes the prompt and the negative prompt
        t5_layers = runner.text_encoder.cfg.num_layers * (2 if cfg.get("enable_cfg", True) else 1)
        sfx = "" if "int8" in str(cfg.get("t5_quant_scheme", "int8")) else "_fp8"
        out["w8a8_matmul_fullk" + sfx] += (len(T5_LINEARS) - 1) * t5_layers
        out["w8a8_matmul" + sfx] += t5_layers
    out["flash_attention"] = (2 if i2v else 1) * calls  # cross-attention (text, and the image for i2v)
    attn, _, kw = runner._self_attn_setup()
    if attn == "sparge":
        p = (kw or {}).get("dense_prefix", 0)
        out.update(block_sparse_attention=(L - p) * steps, flash_attention_fused_rope=p * steps)
    elif attn == "sage_attn2":
        out["sage_attention"] = calls
    elif attn == "radial_attn":
        if cfg.get("radial_sparsity_type") == "two_pass":
            plan = radial._two_pass_plan(S, S, FRAMES, float(cfg.get("decay_factor", 0.5)), "wan",
                                         min(int(cfg["sparse_block_q"]), 256))
            if plan is None:
                raise AssertionError("two_pass has no plan at this shape")
            out["flash_attention_with_lse"] = (1 + FRAMES) * calls  # the near pass, then one far call per frame
        else:
            out["block_sparse_attention_shared"] = calls
    elif runner.arch.rope_fused:
        out["flash_attention_fused_rope"] = calls
    else:  # RoPE in torch, then the dense kernel
        out["flash_attention"] += calls
    out["rope_rotate"] = out["flash_attention_fused_rope"]  # one RoPE pass a fused-RoPE call
    return out


def first_steps(runner, n: int):
    """Cut the runner's denoise to the first ``n`` steps of its schedule
    (the schedule itself, and so each step's timestep, stays the file's)."""
    make = runner.init_scheduler

    def init():
        sched = make()
        sched.num_steps = lambda: n
        return sched

    runner.init_scheduler = init


def tea_series(runner):
    """The host replay of Tea's decisions over the file's whole schedule,
    from the runner's weights on the card: (n,) bools, or (n, 2) per CFG side."""
    import torch

    from lightx2v_tpu_torch.caching.teacache import TeaCacheConfig, hunyuan_tea_plan, tea_decision_series
    from lightx2v_tpu_torch.models.wan.pipeline import tea_mod_series

    cfg = runner.config
    sched = runner.init_scheduler()
    sched.prepare(runner.set_target_shape(), torch.Generator(device="cuda").manual_seed(0), device="cuda")
    if cfg["model_cls"] == "hunyuan":  # the time embedding of each step's timestep
        return hunyuan_tea_plan(sched.timesteps, cfg)
    tc = TeaCacheConfig.from_config(cfg)
    cfg_on = bool(cfg.get("enable_cfg", True))
    mods = tea_mod_series(runner.model, runner.arch, sched, tc, 2 if cfg_on else 1, sched.num_steps(), device="cuda")
    return tea_decision_series(mods, tc, per_side=cfg["feature_caching"] == "Tea" and cfg_on and not runner._offload())


def _flag(c) -> bool:
    """Did a step's entry of ``calc_steps`` run the stack (either side for a per-side pair)?"""
    import numpy as np

    return bool(np.any(c))


def plan_cut(name: str, runner, spec=None):
    """(step window, the calc entries the window must record, or None where
    only the run can say) for a cached or changing-resolution path. Tea and
    Custom take the first window of their cut's length that starts at a calc
    step and holds a skip step of the full-schedule host series (printed
    with its calc count); TaylorSeer's and TaylorWS's pattern starts at 0;
    changing resolution crosses the switch: steps k - 1, k, k + 1.
    ``spec`` (kind, count) stands for a path that is not in ``CACHED``."""
    import numpy as np

    from lightx2v_tpu_torch.caching.taylorseer import taylor_schedule

    cfg = runner.config
    n = int(cfg["infer_steps"])
    if name == "changing_resolution":
        k = int(cfg.get("changing_resolution_steps", n // 2))
        return (k - 1, 3), [True] * 3
    kind, count = spec or CACHED[name][2:]
    if kind == "taylor":
        return (0, count), [bool(c) for c in taylor_schedule(n)[0][:count]]
    if kind == "ada":
        return (0, count), None
    series = tea_series(runner)
    flags = [_flag(c) for c in series]
    text = "".join("C" if f else "s" for f in flags)
    print(json.dumps({"tea_series": {"path": name, "steps": n, "series": text, "calc_steps": int(sum(flags)),
                                     "per_side": series.ndim == 2}}), flush=True)
    for first in range(n - count + 1):
        if flags[first] and not all(flags[first:first + count]):
            want = [tuple(bool(v) for v in c) if np.ndim(c) else bool(c) for c in series[first:first + count]]
            return (first, count), want
    raise AssertionError(f"{name}: the Tea series {text} has no {count}-step window with a calc and a skip step")


def host_memory() -> dict:
    """The host's available RAM and this process's peak resident set (GB):
    ``VmHWM`` of ``/proc/self/status``, or ``getrusage``'s ``ru_maxrss``
    where the kernel does not report it."""
    import resource

    info = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
    status = dict(line.split(":", 1) for line in Path("/proc/self/status").read_text().splitlines())
    kb, src = ((int(status["VmHWM"].split()[0]), "VmHWM") if "VmHWM" in status
               else (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss, "ru_maxrss"))
    return {"host_available_gb": int(info["MemAvailable"].split()[0]) / 1e6, "peak_rss_gb": kb / 1e6,
            "peak_rss_from": src}


def drop_pages(path) -> None:
    """fsync the script's own file and drop its pages from the page cache, so
    that the next read of it comes from the disk."""
    import os

    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def read_from_disk(store) -> None:
    """Drop each block file's pages after the disk tier's store reads it, so
    every read of it comes from the disk."""
    read = store.read_block

    def read_and_drop(i, buf):
        n = read(i, buf)
        drop_pages(store.paths[i])
        return n

    store.read_block = read_and_drop


def offload_stats(tm) -> dict:
    """Per step: stall ms (the compute stream waiting for a block),
    host-to-device GB/s over the copy stream's busy time, and for the disk
    tier the GB read, the workers' read rate and the rate the step
    sustained; the pinned host buffers."""
    steps = tm["offload"]
    out = {"stall_ms": [st["stall_ms"] for st in steps],
           "h2d_gb": [st["h2d_bytes"] / 1e9 for st in steps],
           "h2d_gb_s": [st["h2d_bytes"] / 1e6 / st["h2d_ms"] if st["h2d_ms"] else None for st in steps],
           "pinned_gb": tm["host_buffer_gb"]}
    if "cache_h2d_bytes" in steps[0]:  # feature caching under offload: its host-staged state
        out.update(cache_h2d_gb=[st["cache_h2d_bytes"] / 1e9 for st in steps],
                   cache_d2h_gb=[st["cache_d2h_bytes"] / 1e9 for st in steps])
    if "disk_bytes" in steps[0]:
        out.update(disk_gb=[st["disk_bytes"] / 1e9 for st in steps],
                   disk_worker_gb_s=[st["disk_bytes"] / 1e9 / st["disk_read_s"] if st["disk_read_s"] else None
                                     for st in steps],
                   disk_sustained_gb_s=[st["disk_bytes"] / 1e9 / s for st, s in zip(steps, tm["step_s"])],
                   fetch_wait_s=[st["fetch_wait_s"] for st in steps])
    return out


def offload_step0_check(runner) -> dict:
    """The step-0 prediction of the offloaded forward against the resident
    forward on the same weights and inputs (seeded latents, context, and
    for i2v y and CLIP tokens; CFG as the runner's batch 2): the same kernels
    in the same order, so bit for bit."""
    import torch

    from lightx2v_tpu_torch.models.wan.model import wan_forward
    from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape

    arch, cfg = runner.arch, runner.config
    shape = runner.set_target_shape()
    sched = runner.init_scheduler()
    g = torch.Generator(device="cuda").manual_seed(7)
    lat, t = sched.step_pre(sched.prepare(shape, g, device="cuda"))
    batch = 2 if cfg.get("enable_cfg", True) else 1
    lat, t = torch.cat([lat[None]] * batch), torch.cat([t] * batch)
    ctx = (torch.randn((batch, TXT, arch.text_dim), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    cond = {}
    if arch.task == "i2v":
        cond = dict(y=torch.randn((1, 20, *shape[1:]), generator=g, device="cuda").expand(batch, -1, -1, -1, -1),
                    clip_fea=torch.randn((1, IMG, arch.clip_dim), generator=g, device="cuda").expand(batch, -1, -1))
    cos, sin, _ = rope_for_shape(arch, shape, device="cuda")
    attn, cross, kw = runner._self_attn_setup()

    def forward(params):
        out = wan_forward(params, lat, t, ctx, cos, sin, arch, mm_type=runner.mm_type, self_attn_type=attn,
                          cross_attn_type=cross, self_attn_kwargs=kw, **cond)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    with runner.dit_params() as (params, streamer):
        streamed = forward(params)
        stats = streamer.take_stats()
    streamed_s = time.perf_counter() - t0
    resident = dict(runner.model, blocks=resident_blocks(runner.model["blocks"]))
    t0 = time.perf_counter()
    ref = forward(resident)
    resident_s = time.perf_counter() - t0
    del resident
    torch.cuda.empty_cache()
    diff = float((streamed - ref).abs().max())
    out = {"step0_bitwise_equal": bool(torch.equal(streamed, ref)), "step0_max_abs_diff": diff,
           "step0_streamed_s": streamed_s, "step0_resident_s": resident_s, "step0_stall_ms": stats["stall_ms"]}
    print(json.dumps({"offload_step0": out}), flush=True)
    if not out["step0_bitwise_equal"]:
        raise AssertionError(f"the offloaded step-0 prediction differs from the resident one by {diff}")
    return out


def resident_blocks(store) -> list:
    """Every block of an offload store resident on the card, each its own
    copy, built from the store's host buffers (the disk tier's read with
    ``read_block``)."""
    import torch

    out = []
    for i in range(store.num_blocks):
        if hasattr(store, "read_block"):
            buf = torch.empty(store.layout.nbytes, dtype=torch.uint8)
            store.read_block(i, buf)
        else:
            buf = store.fetch(i)
        out.append(store.block(i, store.layout.views(buf.to("cuda"))))
    return out


def t5_state_dict(params, cfg) -> dict:
    """UMT5 params -> the reference's T5 encoder keys, all bf16 on the host."""
    import torch

    sd = {"token_embedding.weight": params["token_embedding"], "norm.weight": params["norm"]}
    for i, b in enumerate(params["blocks"]):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": b["norm1"], f"{p}.norm2.weight": b["norm2"],
                   f"{p}.pos_embedding.embedding.weight": b["rel_emb"],
                   **{f"{p}.attn.{m}.weight": b[m] for m in "qkvo"},
                   f"{p}.ffn.gate.0.weight": b["gate"], f"{p}.ffn.fc1.weight": b["fc1"],
                   f"{p}.ffn.fc2.weight": b["fc2"]})
    return {k: v.to("cpu", torch.bfloat16) for k, v in sd.items()}


def clip_state_dict(params, arch) -> dict:
    """CLIP vision params -> the reference's ``visual.*`` keys, bf16 on the
    host, plus one ``textual`` key, which the loader must skip."""
    import torch

    d, p = arch.dim, arch.patch_size
    sd = {"visual.patch_embedding.weight": params["patch"].reshape(d, 3, p, p),
          "visual.cls_embedding": params["cls"].reshape(1, 1, d),
          "visual.pos_embedding": params["pos"].reshape(1, -1, d),
          "visual.pre_norm.weight": params["pre_norm"]["w"], "visual.pre_norm.bias": params["pre_norm"]["b"],
          "textual.token_embedding.weight": torch.zeros((8, d))}
    for i, b in enumerate(params["blocks"]):
        k = f"visual.transformer.{i}"
        sd.update({f"{k}.norm1.weight": b["norm1"]["w"], f"{k}.norm1.bias": b["norm1"]["b"],
                   f"{k}.attn.to_qkv.weight": b["qkv_w"], f"{k}.attn.to_qkv.bias": b["qkv_b"],
                   f"{k}.attn.proj.weight": b["proj_w"], f"{k}.attn.proj.bias": b["proj_b"],
                   f"{k}.norm2.weight": b["norm2"]["w"], f"{k}.norm2.bias": b["norm2"]["b"],
                   f"{k}.mlp.0.weight": b["fc1_w"], f"{k}.mlp.0.bias": b["fc1_b"],
                   f"{k}.mlp.2.weight": b["fc2_w"], f"{k}.mlp.2.bias": b["fc2_b"]})
    return {k: v.to("cpu", torch.bfloat16) for k, v in sd.items()}


def write_i2v_checkpoint(root: Path, layers: int) -> dict:
    """The lazy i2v path's files under ``root``: ``model/`` with the Wan i2v
    ``config.json`` and the T5 (bf16 UMT5-XXL), CLIP and VAE ``.pth`` files;
    ``dit_int8_blocks/`` from the converter: the full-width i2v DiT made as a
    reference-key bf16 dict on the card, a rank-32 LoRA over every block
    linear folded in, int8 on the card, the blocks layout. Every file is
    fsynced and its pages dropped; returns the write seconds and bytes."""
    import os

    import numpy as np
    import torch

    from lightx2v_tpu_torch.encoders.clip import ClipVisionArch, init_random_clip_params_on_device
    from lightx2v_tpu_torch.encoders.t5 import UMT5_XXL, init_random_t5_params_on_device
    from lightx2v_tpu_torch.models.wan.config import PRESETS, WanArch
    from lightx2v_tpu_torch.models.wan.weights import init_random_weight_dict_on_device
    from lightx2v_tpu_torch.tools.convert import apply_lora, quantize_model, save_quantized
    from lightx2v_tpu_torch.vae.wan_vae import WanVAEConfig, init_random_vae_state_dict

    model, dit = root / "model", root / "dit_int8_blocks"
    model.mkdir(parents=True)
    arch = WanArch(**dict(PRESETS["wan2.1_14b"], num_layers=layers), task="i2v", in_dim=36)
    times = {}
    t0 = time.perf_counter()
    wd = init_random_weight_dict_on_device(arch, seed=11, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(12)
    lora = {}
    for k, w in wd.items():
        if k.startswith("blocks.") and k.endswith(".weight") and w.ndim == 2:
            stem = "diffusion_model." + k[: -len(".weight")]
            lora[f"{stem}.lora_A.weight"] = torch.randn((LORA_RANK, w.shape[1]), generator=g, device="cuda") * 0.02
            lora[f"{stem}.lora_B.weight"] = torch.randn((w.shape[0], LORA_RANK), generator=g, device="cuda") * 0.02
    torch.cuda.synchronize()
    times["synthesize_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    applied = apply_lora(wd, lora, 1.0)
    if applied != 12 * layers:
        raise AssertionError(f"the LoRA folded into {applied} linears, not the {12 * layers} block linears")
    q = quantize_model(wd, "int8")
    del wd, lora
    torch.cuda.synchronize()
    times["lora_and_quantize_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_quantized(q, str(dit), "blocks", "int8")
    del q
    torch.cuda.empty_cache()
    times["dit_write_s"] = time.perf_counter() - t0
    (model / "config.json").write_text(json.dumps({
        "model_type": "i2v", "dim": arch.dim, "ffn_dim": arch.ffn_dim, "freq_dim": arch.freq_dim, "in_dim": 36,
        "num_heads": arch.num_heads, "num_layers": layers, "out_dim": arch.out_dim, "text_len": TXT,
        "eps": arch.eps}))
    t0 = time.perf_counter()
    torch.save(t5_state_dict(init_random_t5_params_on_device(UMT5_XXL, seed=1, device="cuda"), UMT5_XXL),
               model / "models_t5_umt5-xxl-enc-bf16.pth")
    times["t5_write_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    clip_arch = ClipVisionArch()
    torch.save(clip_state_dict(init_random_clip_params_on_device(clip_arch, seed=3, device="cuda"), clip_arch),
               model / "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                init_random_vae_state_dict(WanVAEConfig(), seed=2).items()}, model / "Wan2.1_VAE.pth")
    times["clip_vae_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    files = sorted(p for p in root.rglob("*") if p.is_file())
    for f in files:
        drop_pages(f)
    times["fsync_s"] = time.perf_counter() - t0
    sizes = {"dit_gb": sum(f.stat().st_size for f in dit.iterdir()) / 1e9,
             "block_gb": (dit / "block_0.safetensors").stat().st_size / 1e9,
             "t5_gb": (model / "models_t5_umt5-xxl-enc-bf16.pth").stat().st_size / 1e9,
             "files_gb": sum(f.stat().st_size for f in files) / 1e9}
    written = {**times, **sizes, "write_gb_s": sizes["files_gb"] / sum(times[k] for k in times if "write" in k
                                                                       or k == "fsync_s"),
               "lora_linears": applied, "layers": layers}
    print(json.dumps({"offload_lazy_i2v_write": written}), flush=True)
    return written


def validate_written(root: Path) -> None:
    """``tools/validate_ckpt`` on the lazy i2v path's files: the int8 DiT
    directory (two-sided key coverage, one 32-token forward on the card under
    its ``config.json``'s mm_type) and the Wan VAE ``.pth``. Fails unless
    every report passes."""
    import torch

    from lightx2v_tpu_torch.tools import validate_ckpt

    t0 = time.perf_counter()
    reports = []
    for argv in (["--model_cls", "wan2.1", "--ckpt", str(root / "dit_int8_blocks"), "--device", "cuda"],
                 ["--model_cls", "wan2.1", "--ckpt", str(root / "model" / "Wan2.1_VAE.pth"), "--component", "vae",
                  "--device", "cuda"]):
        reports += validate_ckpt.validate(validate_ckpt.build_parser().parse_args(argv))
        torch.cuda.empty_cache()
    line = {"validate_s": time.perf_counter() - t0,
            "reports": [{k: v for k, v in r.items() if k not in ("missing", "unused")} | {
                "missing": len(r.get("missing", [])), "unused": len(r.get("unused", []))} for r in reports]}
    print(json.dumps({"validate_ckpt": line}), flush=True)
    bad = [r for r in reports if not r.get("key_coverage_ok", r.get("ok", False))]
    if bad:
        raise AssertionError(f"validate_ckpt on the written checkpoint: {bad}")


def pick_checkpoint_dir():
    """(a directory for the lazy path's files, the DiT depth that fits it):
    the system temp directory, or the repo's git-ignored ``build/``, the
    first with room for the 40-block files; else the roomier one at the
    depth that fits (full width kept)."""
    import shutil

    block_gb, other_gb, margin_gb = 0.404, 11.4 + 1.3 + 0.6 + 0.2, 2.0
    need = lambda layers: (layers * block_gb + other_gb + margin_gb) * 1e9  # noqa: E731
    cands = [Path(tempfile.gettempdir()), ROOT / "build"]
    (ROOT / "build").mkdir(exist_ok=True)
    free = {str(c): shutil.disk_usage(c).free for c in cands}
    print(json.dumps({"disk_free_gb": {k: v / 1e9 for k, v in free.items()}, **host_memory(), "card": card_line()}),
          flush=True)
    for c in cands:
        if free[str(c)] >= need(40):
            return c, 40
    best = max(cands, key=lambda c: free[str(c)])
    layers = int((free[str(best)] / 1e9 - other_gb - margin_gb) // block_gb)
    if layers < 1:
        raise AssertionError(f"no directory holds the lazy path's files: {free}")
    print(json.dumps({"offload_lazy_depth_cut": layers}), flush=True)
    return best, layers


def tiny_vae_state_dict(params) -> dict:
    """Tiny-VAE params -> a taew2_1.pth's keys (the reference's
    ``encoder.N`` / ``decoder.N`` Sequential indices), fp32 on the host."""
    from lightx2v_tpu_torch.vae.tiny_vae import DEC_SEQ, ENC_SEQ

    sd = {}

    def put(key, w, b=None):
        sd[f"{key}.weight"] = w.cpu()
        if b is not None:
            sd[f"{key}.bias"] = b.cpu()

    def mem(key, mp):
        for n, (w, b) in enumerate(((mp["c0_w"], mp["c0_b"]), (mp["c1_w"], mp["c1_b"]), (mp["c2_w"], mp["c2_b"]))):
            put(f"{key}.conv.{2 * n}", w, b)
        if "skip_w" in mp:
            put(f"{key}.skip", mp["skip_w"])

    e, d = params["encoder"], params["decoder"]
    put("encoder.0", e["in_w"], e["in_b"])
    for i, (pool_i, down_i, mems) in enumerate(ENC_SEQ):
        put(f"encoder.{pool_i}.conv", e[f"s{i}_pool"]["w"])
        put(f"encoder.{down_i}", e[f"s{i}_down_w"])
        for j, m in enumerate(mems):
            mem(f"encoder.{m}", e[f"s{i}_mem{j}"])
    put("encoder.17", e["out_w"], e["out_b"])
    put("decoder.1", d["in_w"], d["in_b"])
    for i, (mems, grow_i, out_i) in enumerate(DEC_SEQ):
        for j, m in enumerate(mems):
            mem(f"decoder.{m}", d[f"s{i}_mem{j}"])
        put(f"decoder.{grow_i}.conv", d[f"s{i}_grow"]["w"])
        put(f"decoder.{out_i}", d[f"s{i}_out_w"])
    put("decoder.22", d["out_w"], d["out_b"])
    return sd


def write_t2v_checkpoint(root: Path, layers: int) -> dict:
    """The lazy t2v paths' files under ``root``: ``dit_int8_t2v/`` from the
    converter (the full-width t2v DiT made as a reference-key bf16 dict on
    the card, int8 on the card, the blocks layout), ``model_t2v/`` with the
    Wan t2v ``config.json``, the bf16 UMT5-XXL ``.pth`` (a link to the i2v
    path's file where it was written) and ``taew2_1.pth`` (the runner's
    seed-2 tiny VAE under the reference's keys). The new files are fsynced
    and their pages dropped; returns the write seconds and bytes."""
    import os

    import torch

    from lightx2v_tpu_torch.encoders.t5 import UMT5_XXL, init_random_t5_params_on_device
    from lightx2v_tpu_torch.models.wan.config import PRESETS, WanArch
    from lightx2v_tpu_torch.models.wan.weights import init_random_weight_dict_on_device
    from lightx2v_tpu_torch.tools.convert import quantize_model, save_quantized
    from lightx2v_tpu_torch.vae.tiny_vae import init_random_tiny_vae_params

    model, dit = root / "model_t2v", root / "dit_int8_t2v"
    model.mkdir(parents=True)
    arch = WanArch(**dict(PRESETS["wan2.1_14b"], num_layers=layers))
    times = {}
    t0 = time.perf_counter()
    q = quantize_model(init_random_weight_dict_on_device(arch, seed=13, device="cuda"), "int8")
    torch.cuda.synchronize()
    times["synthesize_and_quantize_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_quantized(q, str(dit), "blocks", "int8")
    del q
    torch.cuda.empty_cache()
    times["dit_write_s"] = time.perf_counter() - t0
    (model / "config.json").write_text(json.dumps({
        "model_type": "t2v", "dim": arch.dim, "ffn_dim": arch.ffn_dim, "freq_dim": arch.freq_dim, "in_dim": 16,
        "num_heads": arch.num_heads, "num_layers": layers, "out_dim": arch.out_dim, "text_len": TXT,
        "eps": arch.eps}))
    t5 = model / "models_t5_umt5-xxl-enc-bf16.pth"
    shared = root / "model" / t5.name
    t0 = time.perf_counter()
    if shared.is_file():
        os.symlink(shared, t5)
    else:
        torch.save(t5_state_dict(init_random_t5_params_on_device(UMT5_XXL, seed=1, device="cuda"), UMT5_XXL), t5)
        torch.cuda.empty_cache()
    times["t5_write_s"] = time.perf_counter() - t0
    torch.save(tiny_vae_state_dict(init_random_tiny_vae_params(seed=2)), model / "taew2_1.pth")
    t0 = time.perf_counter()
    files = sorted(p for d in (model, dit) for p in d.iterdir() if p.is_file() and not p.is_symlink())
    for f in files:
        drop_pages(f)
    times["fsync_s"] = time.perf_counter() - t0
    sizes = {"dit_gb": sum(f.stat().st_size for f in dit.iterdir()) / 1e9,
             "block_gb": (dit / "block_0.safetensors").stat().st_size / 1e9,
             "t5_gb": t5.stat().st_size / 1e9, "t5_shared": shared.is_file(),
             "tiny_vae_mb": (model / "taew2_1.pth").stat().st_size / 1e6,
             "files_gb": sum(f.stat().st_size for f in files) / 1e9}
    written = {**times, **sizes, "layers": layers,
               "write_gb_s": sizes["files_gb"] / sum(v for k, v in times.items() if "write" in k or k == "fsync_s")}
    print(json.dumps({"offload_lazy_t2v_write": written}), flush=True)
    return written


def tiny_decode_check(runner, latents) -> dict:
    """The tiny decode of the path's latents again, timed alone with its
    own device peak; then its first ``TINY_CHECK_FRAMES`` latent frames
    (a 30 x 52 latent corner, 240 x 416 pixels) on the card against the
    same decode on the CPU, before the clip."""
    import os

    import torch

    from lightx2v_tpu_torch.runners.wan_runner import TINY_VAE_CHUNK
    from lightx2v_tpu_torch.vae.tiny_vae import tiny_decode_wan_latents

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frames = tiny_decode_wan_latents(runner.vae, latents, chunk=TINY_VAE_CHUNK)
    torch.cuda.synchronize()
    out = {"tiny_decode_s": time.perf_counter() - t0, "tiny_decode_frames": list(frames.shape),
           "tiny_decode_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "tiny_decode_added_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "tiny_chunk": TINY_VAE_CHUNK}
    del frames
    part = latents[:, :TINY_CHECK_FRAMES, :30, :52]
    card = tiny_decode_wan_latents(runner.vae, part).cpu()
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    ref = tiny_decode_wan_latents(_to(runner.vae, "cpu"), part.cpu())
    out["tiny_cpu_check_s"] = time.perf_counter() - t0
    # bar: relative L2 1e-2, TF32 convolutions on the card against fp32 on the CPU
    rel = float((card - ref).norm() / ref.norm())
    out["tiny_decode_rel_l2"] = rel
    print(json.dumps({"tiny_decode_check": out}), flush=True)
    if not rel < 1e-2 or card.shape != (4 * TINY_CHECK_FRAMES - 3, 240, 416, 3):
        raise AssertionError(f"tiny decode on the card vs the CPU: relative L2 {rel}, shape {tuple(card.shape)}")
    return out


def run_lazy_t2v(name: str, root: Path, written: dict, profile_dir=None):
    """A lazy t2v path on ``LAZY_T2V[name]``'s config as it is, from the
    files ``write_t2v_checkpoint`` wrote (the DiT's block pages dropped
    after each read); lightx2v_6 cut through the step window. The distill
    path first holds its step-0 prediction bit for bit against the resident
    forward; both check the tiny decode afterwards."""
    import torch

    from lightx2v_tpu_torch.runners.wan_runner import _SyntheticTokenizer
    from lightx2v_tpu_torch.utils.config import set_config
    from lightx2v_tpu_torch.vae.tiny_vae import init_random_tiny_vae_params

    config_json, model_cls, steps = LAZY_T2V[name]
    model = root / "model_t2v"
    cfg = json.loads((ROOT / config_json).read_text())
    cfg.update(model_cls=model_cls, task="t2v", device="cuda", seed=42, release_modules=True, prompt=PROMPT,
               negative_prompt=NEG, dit_quantized_ckpt=str(root / "dit_int8_t2v"), model_path=str(model),
               tiny_vae_path=str(model / "taew2_1.pth"))
    cfg = set_config(cfg)
    captured = {}

    def before(runner):
        runner.text_encoder.tokenizer = _SyntheticTokenizer(TXT, runner.text_encoder.cfg.vocab_size)
        if steps:
            runner.step_window = (0, steps)
        want = init_random_tiny_vae_params(seed=2)
        if not all(torch.equal(runner.vae["decoder"][k].cpu(), want["decoder"][k]) for k in ("in_w", "out_w")):
            raise AssertionError("the tiny VAE read from taew2_1.pth is not the one written")
        read_from_disk(runner.model["blocks"])
        decode = runner.run_vae_decoder

        def keep(latents):
            captured["latents"] = latents
            return decode(latents)

        runner.run_vae_decoder = keep
        extra = {"write": written}
        if model_cls == "wan2.1_distill":
            extra.update(offload_step0_check(runner))
        return extra

    return run_path(name, {}, profile_dir, cfg=cfg, before=before,
                    after=lambda runner, _: tiny_decode_check(runner, captured.pop("latents")))


def run_offload_lazy(paths, profile_dir=None) -> dict:
    """The disk-tier paths, from files this script writes under one
    directory: ``offload_lazy_i2v`` on ``configs/offload/
    wan_i2v_disk_lazy_480p.json`` as it is (cut to the first ``LAZY_STEPS``
    steps through the runner's step window), its DiT deleted afterwards;
    then the ``LAZY_T2V`` paths on a t2v DiT, sharing the T5 file. The block
    files' pages are dropped after each read, so every step reads its blocks
    from the disk, as on a host that cannot cache the DiT."""
    import shutil

    from lightx2v_tpu_torch.runners.wan_runner import _SyntheticTokenizer
    from lightx2v_tpu_torch.utils.config import set_config

    base, layers = pick_checkpoint_dir()
    root = Path(tempfile.mkdtemp(prefix="lazy_", dir=base))
    out = {}
    try:
        if "offload_lazy_i2v" in paths:
            written = write_i2v_checkpoint(root, layers)
            cfg = json.loads((ROOT / LAZY_JSON).read_text())
            cfg.update(model_cls="wan2.1", task="i2v", device="cuda", seed=42, release_modules=True,
                       prompt=PROMPT,
                       dit_quantized_ckpt=str(root / "dit_int8_blocks"), model_path=str(root / "model"),
                       image_path=write_image(str(root / "i2v_input.png")))
            cfg = set_config(cfg)

            def before(runner):
                runner.text_encoder.tokenizer = _SyntheticTokenizer(TXT, runner.text_encoder.cfg.vocab_size)
                runner.step_window = (0, LAZY_STEPS)
                read_from_disk(runner.model["blocks"])
                check = offload_step0_check(runner)
                return {"write": written, **check}

            out["offload_lazy_i2v"] = run_path("offload_lazy_i2v", {}, profile_dir, cfg=cfg, before=before)
            validate_written(root)
            shutil.rmtree(root / "dit_int8_blocks")
        t2v = [p for p in LAZY_T2V if p in paths]
        if t2v:
            written = write_t2v_checkpoint(root, layers)
            for name in t2v:
                out[name] = run_lazy_t2v(name, root, written, profile_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def stream_tea(profile_dir=None):
    """``offload_stream_tea``: lightx2v_4 with ``cpu_offload`` and
    ``weight_streaming`` (the fp8 DiT packed into pinned host memory, Tea on
    the streamed stack), the ``STREAM_TEA`` window. Gates: the step-0
    prediction of the streamed forward is the resident one bit for bit (a
    calc step runs that forward), every skip step copies 0 block bytes and
    copies the staged residual in, every calc step copies all 40 blocks."""
    blocks = {}

    def before(runner):
        store = runner.model["blocks"]
        blocks["bytes"] = store.num_blocks * store.layout.nbytes
        return offload_step0_check(runner)

    def after(runner, _):
        tm = runner.timings
        for c, st in zip(tm["calc_steps"], tm["offload"]):
            if st["h2d_bytes"] != (blocks["bytes"] if c else 0) or not (c or st["cache_h2d_bytes"] > 0):
                raise AssertionError(f"offload_stream_tea: step {'calc' if c else 'skip'} moved {st}")
        return {"calc_h2d_gb": blocks["bytes"] / 1e9}

    return run_path("offload_stream_tea", dict(WAN14B, negative_prompt=NEG, cpu_offload=True, weight_streaming=True),
                    profile_dir, model_cls="wan2.1", config_json=STREAM_TEA[0], cut=STREAM_TEA[1:], before=before,
                    after=after)


def vae_int8_check():
    """``vae_int8``: the full Wan VAE's tiled decode of one 16 x 21 x 60 x
    104 latent (81 x 480 x 832 frames) with the int8 decoder
    (``quantize_vae_decoder_int8``) against the float decoder on the card,
    each timed once after a warm-up on the first 5 latent frames (every
    tile and chunk shape). Gate: SNR > 15 dB (the JAX package's bound,
    ``tests/test_vae.py``)."""
    import math

    import torch

    from lightx2v_tpu_torch.vae.wan_vae import (WanVAEConfig, init_random_vae_state_dict, load_wan_vae_params,
                                                quantize_vae_decoder_int8, vae_decode_tiled)

    cfg = WanVAEConfig()
    params = load_wan_vae_params(init_random_vae_state_dict(cfg, seed=2), cfg, device="cuda")
    del params["encoder"], params["conv1"]
    pairs = (("float", params), ("int8", quantize_vae_decoder_int8(params)))
    z = torch.randn((1, FRAMES, 60, 104, 16), generator=torch.Generator(device="cuda").manual_seed(9), device="cuda")

    def decode(p, zz):
        out = vae_decode_tiled(p, zz, cfg)
        torch.cuda.synchronize()
        return out

    for _, p in pairs:
        decode(p, z[:, :5])
    res, outs = {}, {}
    for name, p in pairs:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[name] = decode(p, z)
        res[f"{name}_decode_s"] = time.perf_counter() - t0
        res[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    ref, got = outs["float"].float(), outs["int8"].float()
    res["snr_db"] = 20 * math.log10(float(ref.pow(2).mean().sqrt()) / max(float((got - ref).pow(2).mean().sqrt()),
                                                                            1e-20))
    res["frames"] = list(got.shape)
    res["int8_convs"] = sum(1 for p in _conv_leaves(pairs[1][1]) if "w_scale" in p)
    print(json.dumps({"vae_int8": res}), flush=True)
    if not (res["snr_db"] > 15.0 and torch.isfinite(got).all() and got.shape == (1, 81, 480, 832, 3)):
        raise AssertionError(f"vae_int8: SNR {res['snr_db']} dB (bound 15), shape {tuple(got.shape)}")
    return res


def _conv_leaves(tree):
    if isinstance(tree, dict):
        if "w" in tree:
            yield tree
        for v in tree.values():
            yield from _conv_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _conv_leaves(v)


def run_path(name: str, overrides: dict, profile_dir=None, model_cls: str = "wan2.1_distill",
             config_json: str = DEPLOY_JSON, steps=None, cut=False, cfg=None, before=None, after=None,
             forwards=None, want_frames=None):
    """Synthesize the path's weights on the card (or load what ``cfg``, a
    prepared config, names), zero the counters, run the pipeline once (its
    first ``steps`` denoise steps where given; with ``cut``, the window of
    ``plan_cut``), and check the counts and the frames; a cut path also its
    calc and skip steps (``cut`` may be a ``plan_cut`` spec). ``forwards``:
    the DiT forwards the run makes, where the step count does not say;
    ``want_frames``: the frames it yields, where ``target_video_length`` does
    not.
    ``before(runner)`` runs after loading and ``after(runner, frames)`` after
    the run, both outside the counted run, and return entries for the path's
    line."""
    import gc

    import numpy as np
    import torch

    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.ops import sparge
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from lightx2v_tpu_torch.utils.config import set_config

    if cfg is None:
        cfg = set_config(dict(model_cls=model_cls, task="t2v", device="cuda", synthetic_weights=True,
                              config_json=str(ROOT / config_json),
                              prompt=PROMPT, seed=42,
                              release_modules=True))
        cfg.update(overrides)
    print(f"[{name}] device memory in use before loading: {torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = t_entry = time.perf_counter()
    runner = infer.init_runner(cfg)
    load_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{name}] loaded in {time.perf_counter() - t0:.1f} s, device peak while loading {load_peak:.2f} GB",
          flush=True)
    if steps is not None:
        first_steps(runner, steps)
    extra = before(runner) if before is not None else {}
    want_calc = None
    if cut:
        runner.step_window, want_calc = plan_cut(name, runner, None if cut is True else cut)
    expect = None if cut and want_calc is None else expected_launches(
        runner, cfg, sum(map(_flag, want_calc)) if cut else forwards)
    selected = []  # Sparge's per-call selected-block totals, summed on the device
    select = sparge.sparge_select_blocks

    def counting_select(*a, **kw):
        idx, cnt = select(*a, **kw)
        selected.append(cnt.sum())
        return idx, cnt

    sparge.sparge_select_blocks = counting_select
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        frames = runner.run_pipeline(save_video=False)
        total = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        sparge.sparge_select_blocks = select
    tm = runner.timings
    calc = tm.get("calc_steps")
    if cut:
        if want_calc is not None and [_flag(c) if isinstance(w, bool) else tuple(c) for c, w in
                                      zip(calc, want_calc)] != want_calc:
            raise AssertionError(f"{name}: calc steps {calc} != the plan's {want_calc}")
        if name != "changing_resolution" and not (any(map(_flag, calc)) and not all(map(_flag, calc))):
            raise AssertionError(f"{name}: the cut needs a calc and a skip step, ran {calc}")
        if tm["step_index"] != list(range(runner.step_window[0], sum(runner.step_window))):
            raise AssertionError(f"{name}: ran steps {tm['step_index']}, not the window {runner.step_window}")
        if expect is None:  # Ada: the forwards its codebook chose
            expect = expected_launches(runner, cfg, sum(map(_flag, calc)))
    print(json.dumps({"path": name, "launch_counts": counts, "expected": expect}), flush=True)
    if counts != expect:
        raise AssertionError(f"{name}: launch counts {counts} != {expect}")
    want_shape = (want_frames or int(cfg["target_video_length"]), int(cfg["target_height"]), int(cfg["target_width"]),
                  3)
    if frames.shape != want_shape or not np.isfinite(frames).all():
        raise AssertionError(f"{name}: bad frames: shape {frames.shape}, finite {np.isfinite(frames).all()}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    stats = {"encode_s": tm["encode_s"],
             **{k: tm[k] for k in ("t5_s", "llama_s", "clip_s", "vae_encode_s", "kv_len", "riflex_k", "tr_len")
                if k in tm},
             "denoise_step_s": [float(x) for x in tm["step_s"]],
             "dit_s": tm["dit_s"], "decode_s": tm["decode_s"], "e2e_s": total, "steps": len(tm["step_s"]),
             "load_peak_mem_gb": load_peak, "peak_mem_gb": peak,
             # the first stage (or encode part) after which the peak so far reached the run's peak
             "peak_stage": next((k for k, v in tm["mem_gb"].items() if v >= peak), None),
             "frames": list(frames.shape), "frames_mean_abs": float(np.abs(frames).mean())}
    if cut:
        step_s = [float(x) for x in tm["step_s"]]
        stats.update(step_index=tm["step_index"], calc_steps=calc,
                     calc_step_s=[t for t, c in zip(step_s, calc) if _flag(c)],
                     skip_step_s=[t for t, c in zip(step_s, calc) if not _flag(c)])
    if selected:
        stats["sparge_calls"] = len(selected)
        stats["sparge_selected_blocks"] = int(torch.stack(selected).sum())
    if "offload" in tm:
        stats.update(offload_stats(tm), **host_memory(), load_parts_s=tm["load_parts_s"],
                     load_mem_gb_by_part=tm["load_mem_gb"], mem_gb_by_stage=tm["mem_gb"])
    stats.update(extra)
    if after is not None:
        stats.update(after(runner, frames))
    stats["wall_s"] = time.perf_counter() - t_entry  # load, hooks, run and checks: what the path adds to the script
    print(json.dumps({name: stats}), flush=True)
    if profile_dir:
        profile_run(runner, profile_dir, name)
    del runner
    gc.collect()  # the runner's reference cycles hold its weights until collected
    torch.cuda.empty_cache()
    return counts


def check_hunyuan_i2v(runner, _):
    """The i2v path's RIFLEx index and token-replace length: k = 4 at 193
    frames, one latent frame of 30 x 52 tokens."""
    tm = runner.timings
    if tm["riflex_k"] != 4 or tm["tr_len"] != 30 * 52:
        raise AssertionError(f"hunyuan i2v: riflex_k {tm['riflex_k']}, tr_len {tm['tr_len']}")
    return {}


def run_hunyuan_quant() -> dict:
    """The quantized HunyuanVideo DiT (``HunyuanArch()``, every double and
    single block linear quantized) at bench.py's ``run_hunyuan`` shape: 16 x
    21 x 60 x 104 latents (32,760 image tokens), 256 text tokens all valid,
    embedded guidance 6. First one full-width double + single block at int8
    on the card against the CPU. Then each scheme's weights are made on the
    card, run and released before the next: int8 (bench.py's default) end to
    end, ``HY_Q_STEPS`` Euler steps of a schedule of as many at shift 7, the DiT released, and
    the full VAE's tiled decode to 81 x 480 x 832; fp8, weight-only int4
    (row 11) and int4 x int8 (row 8) one forward each at t = 500. Each
    scheme's launches are counted and must be exact: 320 quantized linears
    a forward (13 a double block, 3 a single block) on its kernel and 60
    flash calls. Returns the summed counts."""
    import gc

    import numpy as np
    import torch

    from lightx2v_tpu_torch.models.hunyuan.config import HunyuanArch
    from lightx2v_tpu_torch.models.hunyuan.model import HunyuanTransformer, build_hunyuan_rope
    from lightx2v_tpu_torch.models.hunyuan.weights import init_random_hunyuan_params_on_device
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from lightx2v_tpu_torch.schedulers.euler import FlowMatchEulerScheduler
    from lightx2v_tpu_torch.utils.config import set_config
    from lightx2v_tpu_torch.vae import hunyuan_vae as hv

    hunyuan_block_reference_check("int8", INT8)
    arch, dev = HunyuanArch(), "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    c, f, h, w = BENCH_LAT
    lat0 = (torch.randn((1, c, f, h, w), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    states = (torch.randn((1, HY_Q_TXT, arch.text_states_dim), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    mask = torch.ones((1, HY_Q_TXT), dtype=torch.int32, device=dev)
    pooled = (torch.randn((1, arch.text_states_dim_2), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    cos, sin = (torch.from_numpy(a).to(dev) for a in build_hunyuan_rope(arch, f, h // 2, w // 2))
    guidance = torch.tensor([6000.0], device=dev)
    kv_len = HY_Q_IMG + HY_Q_TXT
    per_forward = 10 * arch.double_blocks + 3 * arch.single_blocks
    keys = {"int8": "w8a8_matmul_fullk", "fp8": "w8a8_matmul_fullk_fp8", "int4": "int4_matmul",
            "int4a8": "w4a8_matmul"}
    total, line = {k: 0 for k in launch_counts()}, {}
    for scheme, mm_type in HY_SCHEMES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_random_hunyuan_params_on_device(arch, seed=0, device=dev, scheme=scheme.replace("a8", ""))
        torch.cuda.synchronize()
        rec = {"load_s": time.perf_counter() - t0, "weights_gb": torch.cuda.memory_allocated() / 1e9}
        model = HunyuanTransformer(params, arch)
        fwd = lambda lat, t: model(lat, t, states, mask, pooled, cos, sin, kv_len, guidance,  # noqa: E731
                                   mm_type=mm_type)
        steps = []
        reset_launch_counts()
        if scheme == "int8":
            sched = FlowMatchEulerScheduler(set_config(dict(infer_steps=HY_Q_STEPS, sample_shift=7.0)))
            state = sched.prepare((c, f, h, w), torch.Generator(device=dev).manual_seed(42), device=dev)
            for _ in range(HY_Q_STEPS):
                t0 = time.perf_counter()
                lat, t = sched.step_pre(state)
                state = sched.step_post(state, fwd(lat[None], t)[0])
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t0)
            out = state["latents"]
        else:
            t0 = time.perf_counter()
            out = fwd(lat0, torch.tensor([500.0], device=dev))[0]
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        counts = launch_counts()
        n = len(steps)
        expect = {**{k: 0 for k in counts}, keys[scheme]: per_forward * n,
                  "flash_attention": (arch.double_blocks + arch.single_blocks) * n}
        if counts != expect:
            raise AssertionError(f"hunyuan_quant {scheme}: launch counts {counts} != {expect}")
        if out.shape != (c, f, h, w) or not torch.isfinite(out).all():
            raise AssertionError(f"hunyuan_quant {scheme}: bad output: shape {tuple(out.shape)}")
        total = {k: total[k] + v for k, v in counts.items()}
        rec.update(forward_s=steps, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches={k: v for k, v in counts.items() if v}, out_mean_abs=float(out.abs().mean()))
        del model, params, fwd
        gc.collect()
        torch.cuda.empty_cache()
        if scheme == "int8":  # the DiT released, then the tiled decode of the 21 latent frames
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cfg = hv.HunyuanVAEConfig()
            vae = hv.load_hunyuan_vae_params(hv.init_random_hunyuan_vae_state_dict(cfg, seed=2), cfg, device=dev)
            rec["vae_load_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            frames = hv.hunyuan_vae_decode_tiled(vae, out.permute(1, 2, 3, 0)[None], cfg, scale=False)
            torch.cuda.synchronize()
            rec.update(decode_s=time.perf_counter() - t0, decode_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       frames=list(frames.shape[1:]))
            if frames.shape != (1, 81, 480, 832, 3) or not torch.isfinite(frames).all():
                raise AssertionError(f"hunyuan_quant int8 decode: shape {tuple(frames.shape)}")
            del vae, frames
            torch.cuda.empty_cache()
        line[scheme] = rec
        del out
    print(json.dumps({"hunyuan_quant": line}), flush=True)
    return total


def run_cogvideox_quant() -> dict:
    """The quantized CogVideoX1.5-5B DiT (``CogArch()``: 42 blocks, every
    block linear quantized) at bench.py's 480p shape: one CFG forward at
    batch 2 (16 x 21 x 60 x 104 latents, padded to 22 frames: 17,160 video
    + 226 text tokens) at int8 and at fp8, each scheme's weights made on the
    card and released before the next; one full-width int8 block on the
    card against the CPU first. Launches exact: 8 quantized linears a block
    (336) on the scheme's full-K kernel and 42 calls of the 64-wide flash
    kernel. Returns the summed counts."""
    import gc

    import torch

    from lightx2v_tpu_torch.models.cogvideox.config import CogArch, build_cog_rope
    from lightx2v_tpu_torch.models.cogvideox.model import CogTransformer
    from lightx2v_tpu_torch.models.cogvideox.weights import init_random_cog_params_on_device
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cog_block_reference_check("int8", INT8)
    arch, dev = CogArch(), "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    c, f, h, w = BENCH_LAT
    lat = (torch.randn((2, c, f, h, w), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    ctx = (torch.randn((2, arch.text_len, arch.text_dim), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    t = torch.tensor([500.0, 500.0], device=dev)
    cos, sin = (torch.from_numpy(a).to(dev) for a in build_cog_rope(arch, (f + 1) // 2, h // 2, w // 2))
    total, line = {k: 0 for k in launch_counts()}, {}
    for scheme, mm_type in (("int8", INT8), ("fp8", FP8)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_random_cog_params_on_device(arch, scheme, seed=0, device=dev)
        torch.cuda.synchronize()
        rec = {"load_s": time.perf_counter() - t0, "weights_gb": torch.cuda.memory_allocated() / 1e9}
        reset_launch_counts()
        t0 = time.perf_counter()
        out = CogTransformer(params, arch)(lat, t, ctx, cos, sin, mm_type=mm_type)
        torch.cuda.synchronize()
        rec["forward_s"] = time.perf_counter() - t0
        counts = launch_counts()
        key = "w8a8_matmul_fullk" + ("_fp8" if scheme == "fp8" else "")
        expect = {**{k: 0 for k in counts}, key: 8 * arch.num_layers, "flash_attention_d64": arch.num_layers}
        if counts != expect:
            raise AssertionError(f"cogvideox_quant {scheme}: launch counts {counts} != {expect}")
        if out.shape != (2, c, f, h, w) or not torch.isfinite(out).all():
            raise AssertionError(f"cogvideox_quant {scheme}: bad output: shape {tuple(out.shape)}")
        total = {k: total[k] + v for k, v in counts.items()}
        rec.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches={k: v for k, v in counts.items() if v},
                   out_mean_abs=float(out.abs().mean()))
        line[scheme] = rec
        del params, out
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"cogvideox_quant": line}), flush=True)
    return total


def run_vae_encoders() -> dict:
    """The HunyuanVideo and CogVideoX VAE encoders at their published
    configs (fp32, TF32 convolutions), each on a seeded clip of 17 frames of
    480 x 832 -> 5 x 60 x 104 latents at the posterior mean, timed with its
    device peak; then the same encode of the clip's first 5 frames' 64 x 64
    corner on the card against the CPU (fp32), relative L2 below 1e-2 (the
    tiny decode check's bar). Each VAE is released before the next."""
    import gc
    import os

    import torch

    from lightx2v_tpu_torch.vae import cogvideox_vae as cv
    from lightx2v_tpu_torch.vae import hunyuan_vae as hv

    g = torch.Generator(device="cuda").manual_seed(9)
    line = {}
    for name, mod, cfg in (("hunyuan", hv, hv.HunyuanVAEConfig()), ("cogvideox", cv, cv.CogVAEConfig())):
        init = hv.init_random_hunyuan_vae_state_dict if mod is hv else cv.init_random_cog_vae_state_dict
        load = hv.load_hunyuan_vae_params if mod is hv else cv.load_cog_vae_params
        encode = hv.hunyuan_vae_encode if mod is hv else cv.cog_vae_encode
        params = load(init(cfg, seed=2), cfg, device="cuda", encoder=True)
        x = torch.rand((1, ENC_FRAMES, 480, 832, 3), generator=g, device="cuda") * 2 - 1
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        z = encode(params, x, cfg)
        torch.cuda.synchronize()
        rec = {"encode_s": time.perf_counter() - t0, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "added_gb": (torch.cuda.max_memory_allocated() - base) / 1e9, "latents": list(z.shape[1:])}
        if z.shape != (1, 5, 60, 104, 16) or not torch.isfinite(z).all():
            raise AssertionError(f"{name} VAE encode: shape {tuple(z.shape)}")
        ft, fh, fw = ENC_CORNER
        part = x[:, :ft, :fh, :fw]
        card = encode(params, part, cfg).cpu()
        torch.set_num_threads(os.cpu_count() or 1)
        t0 = time.perf_counter()
        ref = encode(_to(params, "cpu"), part.cpu(), cfg)
        rec["cpu_check_s"] = time.perf_counter() - t0
        # bar: relative L2 1e-2, TF32 convolutions on the card against fp32 on the CPU
        rec["corner_rel_l2"] = rel = float((card - ref).norm() / ref.norm())
        if not rel < 1e-2 or card.shape != (1, 2, fh // 8, fw // 8, 16):
            raise AssertionError(f"{name} VAE encode corner, card vs CPU: relative L2 {rel}, shape {tuple(card.shape)}")
        line[name] = rec
        del params, x, z
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"vae_encoders": line}), flush=True)
    return line


@contextlib.contextmanager
def synthetic_dit_from(wd):
    """Within the block, a runner's synthetic DiT at a published width is
    ``wd`` (a reference-key dict on the card) loaded as a checkpoint is,
    in place of the synthesizer's own draws."""
    from lightx2v_tpu_torch.models.wan.weights import load_wan_params
    from lightx2v_tpu_torch.runners import wan_runner

    made = wan_runner.init_random_params_on_device
    wan_runner.init_random_params_on_device = lambda arch, scheme, **kw: load_wan_params(wd, arch, device="cuda")
    try:
        yield
    finally:
        wan_runner.init_random_params_on_device = made


def step0_prediction(runner, params, enc) -> "torch.Tensor":
    """The runner's step-0 DiT prediction (its seeded first latents and
    timestep, the prompt's context) on ``params``, with its mm_type."""
    import torch

    from lightx2v_tpu_torch.models.wan.model import wan_forward
    from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape

    shape = runner.set_target_shape()
    sched = runner.init_scheduler()
    lat, t = sched.step_pre(runner._prepare(sched, shape, runner._generators(1)[0], 0))
    cos, sin, _ = rope_for_shape(runner.arch, shape, device="cuda")
    out = wan_forward(params, lat[None], t, enc["text_encoder_output"]["context"], cos, sin, runner.arch,
                      mm_type=runner.mm_type)
    torch.cuda.synchronize()
    return out


def fold_transparency_check(wd, stats) -> float:
    """Block 0 of ``wd`` at full width, bf16 (Default), on a small input
    (48 tokens): folded (``apply_smooth_quant``: q/k/v and ffn.0 columns
    times s, the affine norms 1 / s) against unfolded, both on the card, at
    the bf16 bar of the block gates: the fold is transparent before
    quantization."""
    import dataclasses

    import torch

    from lightx2v_tpu_torch.models.wan.config import PRESETS, WanArch
    from lightx2v_tpu_torch.models.wan.model import wan_forward
    from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape
    from lightx2v_tpu_torch.models.wan.weights import build_block_params, build_non_block_params
    from lightx2v_tpu_torch.tools.convert import apply_smooth_quant

    arch = dataclasses.replace(WanArch(**PRESETS["wan2.1_14b"]), num_layers=1)
    small = build_non_block_params(wd, arch, device="cuda")
    block0 = {k: v for k, v in wd.items() if k.startswith("blocks.0.")}
    folded = dict(block0)
    if apply_smooth_quant(folded, stats) != 2:
        raise AssertionError("block 0 has two smoothable sites")
    g = torch.Generator(device="cuda").manual_seed(4)
    shape = (16, 2, 8, 12)
    lat = torch.randn((1, *shape), generator=g, device="cuda")
    ctx = (torch.randn((1, TXT, arch.text_dim), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    cos, sin, _ = rope_for_shape(arch, shape, device="cuda")

    def run(blk):
        params = dict(small, blocks=[build_block_params(blk, 0, arch, device="cuda")])
        return wan_forward(params, lat, torch.tensor([750.0], device="cuda"), ctx, cos, sin, arch)

    ref = run(block0)
    out = run(folded)
    if "smooth_norm1" not in build_block_params(folded, 0, arch, device="cuda"):
        raise AssertionError("the folded block carries no affine norm")
    return check_close("one 14B bf16 block, smooth-quant folded vs unfolded (card)", out, ref, 3e-2, 1e-3)


def run_ptq(profile_dir=None) -> dict:
    """The post-training-quantization loop at the 14B widths, every step on
    the card: ``configs/deploy/wan_t2v.json`` with mm_type Default and
    ``do_mm_calib`` on a reference-key bf16 dict made on the card (the
    runner's ``run_dit`` calibrates at the first timestep and runs no step:
    its window is empty), the fold-transparency gate on block 0, the fold and
    int8 block by block, then the config as it is (int8) on the smoothed
    dict, cut to ``PTQ_STEPS`` of its 4 distill steps and the tiled decode,
    with the PSNR of its step-0 prediction against the unsmoothed int8 one
    (printed, no bar: the weights are synthetic). Then ``tune_sparge``'s CLI
    on structured synthetic weights at 21 x 60 x 104 latents, 40 layers, keep
    0.3 and its default grid, and the table's invariants."""
    import gc

    import numpy as np
    import torch

    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.models.wan.config import PRESETS, WanArch
    from lightx2v_tpu_torch.models.wan.weights import init_random_weight_dict_on_device, load_wan_params, \
        permute_qk_half
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from lightx2v_tpu_torch.tools import psnr, tune_sparge
    from lightx2v_tpu_torch.tools.calibrate import load_stats
    from lightx2v_tpu_torch.tools.convert import _BLOCK_RE, apply_smooth_quant, quantize_model
    from lightx2v_tpu_torch.utils.config import set_config

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        arch = WanArch(**PRESETS["wan2.1_14b"])
        t0 = time.perf_counter()
        wd = init_random_weight_dict_on_device(arch, seed=21, device="cuda")
        cfg = set_config(dict(model_cls="wan2.1_distill", task="t2v", device="cuda", synthetic_weights=True,
                              config_json=str(ROOT / DEPLOY_JSON), prompt=PROMPT, seed=42))
        cfg.update(mm_config={"mm_type": "Default"}, do_mm_calib=True, calib_output_path=str(Path(tmp) / "stats.npz"))
        with synthetic_dit_from(wd):
            runner = infer.init_runner(cfg)
        enc = runner.run_input_encoder()
        runner.step_window = (0, 0)
        torch.cuda.synchronize()
        reset_launch_counts()
        t1 = time.perf_counter()
        runner.run_dit(enc)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t1
        calib_counts = launch_counts()
        L = arch.num_layers
        want = {**{k: 0 for k in calib_counts}, "flash_attention_fused_rope": L, "rope_rotate": L, "flash_attention": L}
        if calib_counts != want:
            raise AssertionError(f"ptq calibration: launch counts {calib_counts} != {want}")
        stats = load_stats(cfg["calib_output_path"])
        if len(stats) != 10 * L or any(not np.isfinite(v).all() for v in stats.values()):
            raise AssertionError(f"ptq calibration: {len(stats)} stats, not {10 * L} finite ones")
        del runner, enc
        gc.collect()
        torch.cuda.empty_cache()
        out["calibration"] = {"stats": len(stats), "calib_s": calib_s, "launch_counts": calib_counts,
                              "act_absmax_max": float(max(v.max() for v in stats.values()))}
        out["fold_gate_max_abs_err"] = fold_transparency_check(wd, stats)

        # int8 of the unsmoothed dict, then the fold and int8 block by block (the bf16 blocks freed as they go)
        t1 = time.perf_counter()
        q_plain = quantize_model(wd, "int8")
        q_smooth = {k: v for k, v in wd.items() if not _BLOCK_RE.match(k)}
        for i in range(L):
            sub = {k: wd.pop(k) for k in [k for k in wd if k.startswith(f"blocks.{i}.")]}
            apply_smooth_quant(sub, stats)
            q_smooth.update(quantize_model(sub, "int8"))
            del sub
        del wd
        torch.cuda.synchronize()
        out["fold_and_quantize_s"] = time.perf_counter() - t1
        n_affine = sum("affine_norm" in k for k in q_smooth)
        if n_affine != 4 * L:
            raise AssertionError(f"ptq: {n_affine} affine-norm tensors, not {4 * L}")

        psnr_db = {}

        def before(runner):
            enc = runner.run_input_encoder()
            smooth = step0_prediction(runner, runner.model, enc)
            plain = step0_prediction(runner, permute_qk_half(load_wan_params(q_plain, runner.arch, device="cuda"),
                                                             runner.arch), enc)
            q_plain.clear()
            psnr_db["step0_psnr_db"] = psnr.psnr(plain.float().cpu().numpy(), smooth.float().cpu().numpy())
            print(json.dumps({"ptq_step0": {**psnr_db, "note": "smoothed int8 vs unsmoothed int8, same weights; "
                                            "synthetic weights, no bar"}}), flush=True)
            torch.cuda.empty_cache()
            return dict(psnr_db)

        with synthetic_dit_from(q_smooth):
            out["run"] = run_path("ptq", {}, profile_dir, steps=PTQ_STEPS, forwards=PTQ_STEPS, before=before)
        del q_smooth
        gc.collect()
        torch.cuda.empty_cache()
        out["run_step0_psnr_db"] = psnr_db["step0_psnr_db"]

        # the per-layer Sparge table, through the tool's entry point
        table = str(Path(tmp) / "sparge_14b.npz")
        reset_launch_counts()
        t1 = time.perf_counter()
        tune_sparge.main(["--structured", "--preset", "14b", "--output", table, "--device", "cuda"])
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t1
        tune_counts = launch_counts()
        grid = len(set(tune_sparge.DEFAULT_L1_GRID) | {0.0})
        want = {**{k: 0 for k in tune_counts}, "block_sparse_attention": grid * L, "flash_attention": 2 * L}
        if tune_counts != want:
            raise AssertionError(f"ptq tune: launch counts {tune_counts} != {want}")
        d = np.load(table)
        l1, passed = d["l1"], d["passed"]
        # the invariants tests/test_tune_sparge.py::test_shipped_tuned_table_artifact pins, at 40 layers
        gate = (l1.shape == (L,) and float(d["bar_db"]) > 0 and 0 < float(d["keep_ratio"]) <= 1
                and bool(((l1 >= 0.0) & (l1 <= 0.3)).all()) and bool((l1[~passed] == 0.0).all())
                and int(passed.sum()) >= L // 2)
        out["tune"] = {"tune_s": tune_s, "launch_counts": tune_counts, "l1": [float(v) for v in l1],
                       "snr_db": [float(v) for v in d["snr_db"]], "passed": int(passed.sum()),
                       "bar_db": float(d["bar_db"]), "keep_ratio": float(d["keep_ratio"]), "gate": gate}
        print(json.dumps({"ptq_tune": out["tune"]}), flush=True)
        if not gate:
            raise AssertionError(f"ptq tune: the table breaks its invariants: {out['tune']}")
    out["ptq_s"] = time.perf_counter() - t0
    print(json.dumps({"ptq": {k: v for k, v in out.items() if k != "run"}}), flush=True)
    # the path's launches: the calibration's, the run's and the tune's, each held exact above
    return {k: out["run"][k] + calib_counts[k] + tune_counts[k] for k in out["run"]}


def run_quant_schemes() -> dict:
    """The fp8_block128, mxfp8 and mxfp6 schemes at the 14B widths: one
    full-width block each on the card against the CPU plain version (the
    block gates' bars: the e4m3-activation schemes at the fp8 block's 6e-2,
    mxfp6's bf16 activations at 3e-2), then each scheme's linear at (32,760,
    5120 -> 5120) timed beside row 3f (the per-channel fp8 kernel) on the same
    weights, CUDA-event medians."""
    import torch

    from lightx2v_tpu_torch.ops.linear import resolve_mm
    from lightx2v_tpu_torch.tools.convert import quantize_weight

    errs = {}
    for scheme, mm_type, rtol in SCHEMES_PHASE:
        errs[scheme] = block_reference_check(scheme, mm_type, rtol=rtol)
    g = torch.Generator(device="cuda").manual_seed(31)
    w = (torch.randn((DIM, DIM), generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    x = torch.randn((S, DIM), generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn((DIM,), generator=g, device="cuda") * 0.02
    ms = {}
    for scheme, mm_type in (("fp8", FP8),) + tuple((s, m) for s, m, _ in SCHEMES_PHASE):
        q, sc = quantize_weight(w, scheme)
        p = {"w": q, "w_scale": sc, "b": b}
        fn = resolve_mm(mm_type)
        ms[scheme] = cuda_ms(lambda: fn(p, x), REPS)
        del q, sc, p
        torch.cuda.empty_cache()
    line = {"card": card_line(), "shape": [S, DIM, DIM], "block_max_abs_err": errs, "linear_ms": ms,
            "row_3f_ms": ms["fp8"], "fp8_block128_route": "torch._scaled_mm a 128-column k-group, fp32 partial "
                                                          "rescaled and accumulated in place"}
    print(json.dumps({"quant_schemes": line}), flush=True)
    return line


def guard_exact_dot() -> None:
    """From here on, an 8-bit linear whose codes lie on the card and reach
    the float64 exact dot (``ops/linear.py``'s per-token path below the
    kernels) raises: on the card every 8-bit linear runs a kernel."""
    from lightx2v_tpu_torch.ops import linear

    exact = linear.int_dot_exact

    def guarded(q, w):
        if q.is_cuda:
            raise AssertionError(f"an 8-bit linear on the card reached int_dot_exact: {tuple(q.shape)} x "
                                 f"{tuple(w.shape)}")
        return exact(q, w)

    linear.int_dot_exact = guarded


def run_causvid(profile_dir=None):
    """``configs/wan_t2v_causvid.json`` at the 14B widths, cut to its first
    ``CV_FRAGMENTS`` fragments of 3 AR blocks of 7 latent frames (the second
    fragment's first block re-anchored) and to every ``CV_STEP_STRIDE``-th
    entry of its distill step list (1 of 9), a 21-frame KV cache."""
    cv = json.loads((ROOT / CV_JSON).read_text())
    step_list = cv["denoising_step_list"][::CV_STEP_STRIDE]
    nb, nf, fpb, steps = cv["num_blocks"], CV_FRAGMENTS, cv["num_frame_per_block"], len(step_list)
    blocks = nb + (nf - 1) * (nb - 1)

    def after(runner, _):
        tm = runner.timings
        if len(tm["step_s"]) != blocks * steps or len(tm["reanchor_s"]) != nf - 1:
            raise AssertionError(f"causvid: {len(tm['step_s'])} block forwards, {len(tm['reanchor_s'])} re-anchors")
        return {k: tm[k] for k in ("kv_cache_gb", "block_s", "reanchor_s", "dit_start_mem_gb") if k in tm} | {
            "t5_released": runner.text_encoder is None, "forwards": blocks * steps + nf - 1}

    # the file names no sample_shift, which the step-distill schedule needs (the JAX runner fails without it too):
    # 5, what every step-distill config in configs/ names
    return run_path("causvid", dict(WAN14B, sample_shift=5, num_fragments=nf, denoising_step_list=step_list),
                    profile_dir, model_cls="wan2.1_causvid",
                    config_json=CV_JSON, forwards=blocks * steps + nf - 1, want_frames=(blocks * fpb - 1) * 4 + 1,
                    after=after)


def write_wav(path: str, samples: int, sr: int = 16000, seed: int = 0) -> str:
    """A seeded mono 16-bit wav: a tone whose pitch and loudness wander,
    plus noise."""
    import wave

    import numpy as np

    t = np.arange(samples) / sr
    tone = np.sin(2 * np.pi * (180 + 40 * np.sin(2 * np.pi * 0.5 * t)) * t) * (0.55 + 0.45 * np.sin(2 * np.pi * 2 * t))
    pcm = np.clip(tone * 16000 + np.random.default_rng(seed).normal(0, 800, samples), -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return path


def parse_mjpeg_mp4(raw: bytes, want_boxes) -> tuple:
    """(the top-level boxes as (fourcc, offset, size), moov's bytes, the
    video track's sample count, the first sample's image size) of an MJPEG
    mp4 written by ``utils/media.write_mjpeg_mp4``; its first sample is
    decoded by PIL."""
    import io
    import struct

    from PIL import Image

    top, off = [], 0
    while off < len(raw):
        size, cc = struct.unpack(">I4s", raw[off:off + 8])
        top.append((cc, off, size))
        off += size
    if [c for c, _, _ in top] != want_boxes or off != len(raw):
        raise AssertionError(f"mp4: top-level boxes {top}")
    moov = raw[top[2][1]:]
    stsz = moov.index(b"stsz", moov.index(b"mp4v"))
    n_video, first = struct.unpack(">II", moov[stsz + 12:stsz + 20])
    img = Image.open(io.BytesIO(raw[top[1][1] + 8:top[1][1] + 8 + first]))
    img.load()
    return top, moov, n_video, img.size


def check_mux(path: str, frames: int, samples: int) -> dict:
    """Parse the ``.av.mp4``: ftyp, mdat and moov; an ``mp4v`` track of
    ``frames`` JPEG samples, the first of which PIL decodes at the video's
    size, and a ``sowt`` track of ``samples`` PCM16 samples."""
    import struct

    raw = Path(path).read_bytes()
    _, moov, n_video, size = parse_mjpeg_mp4(raw, [b"ftyp", b"mdat", b"moov"])
    stsz = moov.index(b"stsz", moov.index(b"sowt"))
    size_a, n_audio = struct.unpack(">II", moov[stsz + 8:stsz + 16])
    if (n_video, size_a, n_audio) != (frames, 2, samples):
        raise AssertionError(f"audio mux: {n_video} video samples, {n_audio} audio of size {size_a}")
    return {"mux_mb": len(raw) / 1e6, "mux_video_samples": n_video, "mux_audio_samples": n_audio,
            "mux_first_frame": list(size)}


def run_audio(profile_dir=None):
    """``configs/audio_driven/wan_i2v_audio.json`` at the i2v 14B widths,
    with a seeded PNG and a seeded 157,000-sample 16 kHz wav: 157 frames,
    two 81-frame segments, each cut to the first ``AUDIO_STEPS`` of its 4
    Euler steps, the second conditioned on the first's last 5 frames; the
    frames and the stitched audio muxed into an ``.av.mp4``, parsed back."""
    au = json.loads((ROOT / AUDIO_JSON).read_text())
    fps, window = int(au["target_fps"]), int(au["target_video_length"])
    frames = min(int(au["video_duration"] * fps), AUDIO_SAMPLES * fps // int(au["audio_sr"]))
    n_seg = 1 + -(-(frames - window) // (window - 5))
    with tempfile.TemporaryDirectory() as tmp:
        def after(runner, video):
            tm = runner.timings
            runner.config["save_video_path"] = str(Path(tmp) / "audio.mp4")
            t0 = time.perf_counter()
            path = runner._mux_av(video, *runner.audio_track)
            return {"segments": n_seg, "adapter_gb": tm["adapter_gb"], "mux_s": time.perf_counter() - t0,
                    **{f"{k}_by_segment": [tm[f"{k}_{i}"] for i in range(n_seg)]
                       for k in ("prev_cond_s", "dit_s", "decode_s")},
                    **check_mux(path, len(video), len(runner.audio_track[0]))}

        overrides = dict(WAN14B, image_path=write_image(str(Path(tmp) / "audio_input.png"), seed=1),
                         audio_path=write_wav(str(Path(tmp) / "audio_input.wav"), AUDIO_SAMPLES))
        return run_path("audio", overrides, profile_dir, model_cls="wan2.1_audio", config_json=AUDIO_JSON,
                        steps=AUDIO_STEPS, forwards=n_seg * AUDIO_STEPS, want_frames=frames, after=after)


def run_audio_encoder() -> dict:
    """The wav2vec-class audio encoder from HF directories
    (``encoders/wav2vec.py``): a wavlm-base-plus-width one (768 wide, 12
    post-LN layers, the gated relative position bias) and a
    hubert-large-width one (1024 wide, 24 pre-LN layers, LayerNorm conv
    features) in an ``audio_encoder/`` subfolder, written from the device
    synthesizer into a temporary directory; ``AudioEncoder(path)`` on the
    card (fp32, no TF32) on the audio config's 81-frame window of a seeded
    16 kHz wav, timed, then the same function on the CPU from the same files.
    Bar: max abs difference 1e-5 of the features' max abs (fp32 on both
    sides, the convolutions and sums in another order: the fp32 runs read
    about 2e-6 of it; TF32 left on in a matmul or convolution rounds its
    inputs to 10 mantissa bits, about 5e-4 relative each)."""
    import gc
    import os

    import numpy as np
    import torch

    from lightx2v_tpu_torch.encoders import wav2vec as w2v
    from lightx2v_tpu_torch.encoders.audio import AudioEncoder

    au = json.loads((ROOT / AUDIO_JSON).read_text())
    fps, frames = float(au["target_fps"]), int(au["target_video_length"])
    line = {}
    with tempfile.TemporaryDirectory() as tmp:
        wav = write_wav(str(Path(tmp) / "speech.wav"), int(frames / fps * au["audio_sr"]), sr=int(au["audio_sr"]),
                        seed=4)
        for name, arch, sub in (("wavlm_base_plus", w2v.WAVLM_BASE_PLUS, ""),
                                ("hubert_large", w2v.HUBERT_LARGE, "audio_encoder")):
            path = Path(tmp) / name
            t0 = time.perf_counter()
            w2v.write_random_wav2vec_dir(str(path / sub), arch, seed=6, device="cuda")
            rec = {"write_s": time.perf_counter() - t0,
                   "files_gb": sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 1e9}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            enc = AudioEncoder(str(path), device="cuda")
            torch.cuda.synchronize()
            rec["load_s"] = time.perf_counter() - t0
            card = enc.infer(wav, frames, fps=fps)  # first call: cuDNN's algorithm choice
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = enc.infer(wav, frames, fps=fps)
            torch.cuda.synchronize()
            rec.update(encode_s=time.perf_counter() - t0, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       encoder_frames=int(enc.model(np.zeros(int(frames / fps * 16000), np.float32)).shape[0]))
            del enc
            gc.collect()
            torch.cuda.empty_cache()
            torch.set_num_threads(os.cpu_count() or 1)
            t0 = time.perf_counter()
            ref = AudioEncoder(str(path), device="cpu").infer(wav, frames, fps=fps)
            rec["cpu_s"] = time.perf_counter() - t0
            rec["max_abs_err"] = err = float(np.abs(card - ref).max())
            rec["ref_max_abs"] = scale = float(np.abs(ref).max())
            if not (card.shape == ref.shape == (1, frames, 1024) and np.isfinite(card).all() and err < 1e-5 * scale):
                raise AssertionError(f"audio encoder {name}, card vs CPU: shape {card.shape}, max abs err {err} "
                                     f"against the bar {1e-5 * scale}")
            rec["hidden"] = arch.hidden_size
            line[name] = rec
    print(json.dumps({"audio_encoder": line}), flush=True)
    return line


def http_json(port: int, method: str, path: str, body=None, timeout: float = 60.0):
    """(status code, JSON body) of one request to the server on 127.0.0.1."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wait_task(port: int, task_id: str, until, timeout: float = SERVE_WAIT) -> str:
    """Poll the task's status every 20 ms until it is one of ``until``; the
    status. Raises after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        code, st = http_json(port, "GET", f"/v1/tasks/{task_id}/status")
        if code != 200:
            raise AssertionError(f"serve: status of {task_id}: {code} {st}")
        if st["status"] in until:
            return st["status"]
        if time.monotonic() > deadline:
            raise AssertionError(f"serve: task {task_id} still {st['status']} after {timeout} s")
        time.sleep(0.02)


def run_serve(ref: dict) -> dict:
    """The slice path's runner (``ref``: its runner, frames and launch
    counts) behind ``ApiServer`` on 127.0.0.1, driven over HTTP: request 1
    (the slice path's prompt and seed) completes with the slice path's
    frames bit for bit; request 2, submitted while request 1 runs, is stopped
    while pending; request 3 (another seed) is stopped once processing and
    ends at the next stage boundary with no decode and no file; request 4
    (another seed and prompt) completes, its file downloads byte for byte
    and its first frame decodes at 832 x 480; its frames are also written
    by the PIL MJPEG writer (timed) and parsed back. The launch counts over the
    four must be the slice path's times the runs that reached the DiT. The
    runner keeps its modules resident between requests, as ``api_server.py``
    runs it (request 1 loads the T5 and the DiT that the slice path
    released)."""
    import gc

    import numpy as np
    import torch

    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from lightx2v_tpu_torch.server.api import ApiServer
    from lightx2v_tpu_torch.server.service import VideoGenerationService
    from lightx2v_tpu_torch.utils.media import video_writer, write_mjpeg_mp4

    runner, cfg = ref["runner"], ref["runner"].config
    cfg["release_modules"] = False  # served as api_server.py serves: the modules stay resident between requests
    h, w = int(cfg["target_height"]), int(cfg["target_width"])
    saved = {}  # save path -> the frames the runner wrote there (the runner's own output, before the encoder)
    save = runner.save_video

    def capture(frames, path):
        saved[path] = frames
        save(frames, path)

    runner.save_video = capture
    with tempfile.TemporaryDirectory() as out:
        service = VideoGenerationService(lambda: runner, output_root=out, server_config=cfg)
        server = ApiServer(service, host="127.0.0.1", port=0, output_root=out)
        server.serve_background()
        port = server.port
        try:
            def submit(prompt, seed, name):
                code, body = http_json(port, "POST", "/v1/tasks",
                                       {"prompt": prompt, "seed": seed, "save_video_path": name})
                if code != 200:
                    raise AssertionError(f"serve: submit {name}: {code} {body}")
                return body["task_id"]

            reset_launch_counts()
            t0 = time.perf_counter()
            r1 = submit(PROMPT, 42, "r1.mp4")
            wait_task(port, r1, ("processing",))
            r2 = submit(PROMPT, 7, "r2.mp4")
            code, st = http_json(port, "DELETE", f"/v1/tasks/{r2}")
            if code != 200 or st["stop_status"] != "requested" or service.get(r2).status != "pending":
                raise AssertionError(f"serve: the pending stop of request 2: {code} {st}, {service.get(r2).status}")
            r3 = submit(PROMPT, 8, "r3.mp4")
            r4 = submit(SERVE_PROMPT, 9, "r4.mp4")
            finals = {r1: wait_task(port, r1, ("completed", "failed", "stopped")),
                      r2: wait_task(port, r2, ("completed", "failed", "stopped"))}
            wait_task(port, r3, ("processing", "completed", "failed", "stopped"))
            code, st = http_json(port, "DELETE", f"/v1/tasks/{r3}")
            t_stop = time.time()
            if code != 200 or st["stop_status"] != "requested":
                raise AssertionError(f"serve: the processing stop of request 3: {code} {st}")
            finals[r3] = wait_task(port, r3, ("completed", "failed", "stopped"))
            finals[r4] = wait_task(port, r4, ("completed", "failed", "stopped"))
            total = time.perf_counter() - t0
            counts = launch_counts()
            want = {r1: "completed", r2: "stopped", r3: "stopped", r4: "completed"}
            if finals != want:
                raise AssertionError(f"serve: final statuses {finals} != {want}; errors "
                                     f"{[service.get(t).error for t in finals]}")
            recs = {k: service.get(t) for k, t in (("r1", r1), ("r2", r2), ("r3", r3), ("r4", r4))}
            if recs["r2"].timings is not None:
                raise AssertionError("serve: request 2 ran")
            tm3 = recs["r3"].timings
            if "decode_s" in tm3 or os.path.exists(recs["r3"].request.save_video_path):
                raise AssertionError(f"serve: request 3 decoded or saved: timings {sorted(tm3)}")

            # request 1: the slice path's frames, bit for bit
            f1 = saved[recs["r1"].request.save_video_path]
            if f1.shape != ref["frames"].shape or not np.array_equal(f1, ref["frames"]):
                d = np.abs(f1.astype(np.float64) - ref["frames"]) if f1.shape == ref["frames"].shape else None
                raise AssertionError(f"serve: request 1's frames differ from the slice path's direct run: shape "
                                     f"{f1.shape}, max abs {None if d is None else float(d.max())}")
            # request 4: the result, the download, the first frame
            code, res = http_json(port, "GET", f"/v1/tasks/{r4}/result")
            if code != 200:
                raise AssertionError(f"serve: result of request 4: {code} {res}")
            import urllib.request

            with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/files/download/{res['download_path']}",
                                        timeout=60) as r:
                body = r.read()
            on_disk = Path(res["save_video_path"]).read_bytes()
            if body != on_disk:
                raise AssertionError(f"serve: download of {len(body)} bytes != the file's {len(on_disk)}")
            writer = video_writer()  # the module cache_video wrote with: None is the PIL writer
            if writer is None:  # an MJPEG mp4: parse it, decode its first JPEG
                _, _, n_frames, first = parse_mjpeg_mp4(on_disk, [b"ftyp", b"mdat", b"moov"])
            elif writer.__name__ == "cv2":
                cap = writer.VideoCapture(res["save_video_path"])
                ok, img = cap.read()
                n_frames, first = int(cap.get(writer.CAP_PROP_FRAME_COUNT)), img.shape[1::-1] if ok else None
                cap.release()
            else:
                video = writer.mimread(res["save_video_path"], memtest=False)
                n_frames, first = len(video), video[0].shape[1::-1]
            if tuple(first) != (w, h) or n_frames != int(cfg["target_video_length"]):
                raise AssertionError(f"serve: request 4's file holds {n_frames} frames, the first {first}")
            # the PIL writer, which cache_video takes where neither imageio nor cv2 imports, on request 4's frames
            t1 = time.perf_counter()
            mjpeg = write_mjpeg_mp4(saved[recs["r4"].request.save_video_path], str(Path(out) / "r4_mjpeg.mp4"),
                                    fps=int(cfg.get("fps", 16)))
            mjpeg_s, mjpeg_mb = time.perf_counter() - t1, os.path.getsize(mjpeg) / 1e6
            _, _, n_mjpeg, first_mjpeg = parse_mjpeg_mp4(Path(mjpeg).read_bytes(), [b"ftyp", b"mdat", b"moov"])
            if (n_mjpeg, tuple(first_mjpeg)) != (int(cfg["target_video_length"]), (w, h)):
                raise AssertionError(f"serve: the MJPEG file holds {n_mjpeg} frames, the first {first_mjpeg}")
            code, m = http_json(port, "GET", "/v1/service/metrics")
            if code != 200 or (m["tasks_completed"], m["tasks_stopped"], m["tasks_failed"]) != (2, 2, 0) or \
                    set(m["last_stage_seconds"]) != {"Run Encoders", "Run DiT", "Run VAE Decoder", "Save video"}:
                raise AssertionError(f"serve: metrics {m}")
        finally:
            server.shutdown()
            runner.save_video = save
            if not service.join(SERVE_WAIT):
                raise AssertionError("serve: the service's worker did not exit")

    # every kernel's launches: the slice path's for each run that ran the DiT (request 3's when it got there)
    dit_runs = 2 + ("dit_s" in tm3)
    expect = {k: v * dit_runs for k, v in ref["counts"].items()}
    print(json.dumps({"path": "serve", "launch_counts": counts, "expected": expect}), flush=True)
    if counts != expect:
        raise AssertionError(f"serve: launch counts {counts} != {expect}")

    def line(rec):
        tm = rec.timings or {}
        return {"submit_to_final_s": rec.finished - rec.created,
                "queue_wait_s": None if rec.started is None else rec.started - rec.created,
                **{k: tm[k] for k in ("encode_s", "dit_s", "decode_s", "save_s") if k in tm},
                "peak_mem_gb": max(tm["mem_gb"].values()) if tm.get("mem_gb") else None}

    stats = {name: line(rec) for name, rec in recs.items()}
    stats.update(stop_latency_s=recs["r3"].finished - t_stop, r3_stopped_after="dit" if "dit_s" in tm3 else "encode",
                 writer=getattr(writer, "__name__", "PIL"), file_mb=len(on_disk) / 1e6, first_frame=list(first),
                 mjpeg_s=mjpeg_s, mjpeg_mb=mjpeg_mb,
                 frames_equal_slice=True, e2e_s=total, last_stage_seconds=m["last_stage_seconds"])
    print(json.dumps({"serve": stats}), flush=True)
    del runner, ref["runner"], saved
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _category(name: str) -> str:
    n = name.lower()
    for key, cat in (("sparse_wgmma_kernel", "block_sparse_attention (ours)"),
                     ("flash_wgmma_kernel", "flash_attention (ours)"), ("rope_rotate_kernel", "flash_attention (ours)"),
                     ("sage_wgmma_kernel", "sage attention (ours)"),
                     ("sage_quant_rows", "sage row quantize (ours)"), ("int4_wgmma_kernel", "int4 GEMM (ours)"),
                     ("w8a8_wgmma_kernel<true", "fp8 GEMM (ours)"), ("w8a8_wgmma_kernel", "int8 GEMM (ours)"),
                     ("ffn_gemm1_wgmma_kernel<true", "fp8 FFN GEMM1 (ours)"),
                     ("ffn_gemm1", "ffn GEMM1 (ours)"), ("ffn_w4a8_gemm1", "ffn w4a8 GEMM1 (ours)"),
                     ("w4a8_gemm_kernel", "w4a8 GEMM (ours)"), ("quant_groups", "8-bit quantize (ours)"),
                     ("sort", "sort (torch)"), ("replication_pad", "replicate padding (torch)"),
                     ("nchwtonhwc", "layout transposes (cuDNN)"), ("nhwctonchw", "layout transposes (cuDNN)"),
                     ("nvjet", "matmul (cuBLAS)"),
                     ("conv", "convolution (cuDNN)"), ("fprop", "convolution (cuDNN)"),
                     ("dgrad", "convolution (cuDNN)"), ("gemm", "matmul (cuBLAS)"), ("sm90", "matmul (cuBLAS)"),
                     ("reduce", "reductions (torch)"), ("elementwise", "elementwise (torch)"),
                     ("copy", "copies/casts (torch)"), ("cat", "copies/casts (torch)")):
        if key in n:
            return cat
    return "other (torch)"


def profile_run(runner, out_dir: str, name: str):
    """One more run of the pipeline under torch.profiler: device time by
    kernel category and the device idle share, written to
    ``out_dir/profile_<name>.json`` (the profiler adds host overhead, so the
    measured run above is the one timed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if runner.text_encoder is None:  # released by the measured run: reload outside the window
        runner.text_encoder = runner.load_text_encoder()
        runner.image_encoder = runner.load_image_encoder()
    if runner.model is None:
        runner.model = runner.load_transformer()
    runner.config["release_modules"] = False
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run_pipeline(save_video=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3  # the pipeline only, not the trace processing
    cats, kernels = {}, []
    for e in prof.key_averages():
        dev_ms = (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0) or 0) / 1e3
        # host-side op and runtime rows would count their kernels twice;
        # "Command Buffer Full" marks launch-queue stalls, not device work
        if dev_ms <= 0 or e.key.startswith(("cuda", "aten::", "Memcpy", "Command Buffer")):
            continue
        cats[_category(e.key)] = cats.get(_category(e.key), 0.0) + dev_ms
        kernels.append({"kernel": e.key[:120], "device_ms": dev_ms, "count": e.count})
    busy = sum(cats.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms,
           "by_category_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
           "stage_s": {k: runner.timings[k] for k in ("encode_s", "dit_s", "decode_s")},
           "top_kernels": sorted(kernels, key=lambda r: -r["device_ms"])[:30]}
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    (Path(out_dir) / f"profile_{name}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({f"profile_{name}": {k: out[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                                      "by_category_ms", "stage_s")}}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--kernel", metavar="NAME", action="append", default=[],
                    help="run only this kernel's phase (repeatable; a launch-counter name, e.g. int4_matmul)")
    ap.add_argument("--path", action="append", default=[], choices=PATHS,
                    help="run only this path (repeatable)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="after each path, run it once more under torch.profiler; write DIR/profile_<path>.json")
    args = ap.parse_args()
    if os.environ.get("PYTHONHASHSEED") != "0":
        # one hash seed for this process and the dist path's torchrun one: the synthetic tokenizers hash words
        os.execve(sys.executable, [sys.executable, str(Path(__file__).resolve()), *sys.argv[1:]],
                  dict(os.environ, PYTHONHASHSEED="0"))

    if not (ROOT / "lightx2v_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: the lightx2v_tpu_torch package is not beside this script", file=sys.stderr)
        sys.exit(2)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from lightx2v_tpu_torch.infer import set_numerics
    from lightx2v_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts

    unknown = sorted(set(args.kernel) - set(launch_counts()))
    if unknown:
        ap.error(f"unknown kernel {unknown}; one of {sorted(launch_counts())}")
    set_numerics()
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda}))
    t_start = time.perf_counter()
    _build.build(verbose=True)
    print(json.dumps({"build_s": time.perf_counter() - t_start}), flush=True)

    def want(name: str) -> bool:
        return not args.kernel or name in args.kernel

    rows, extra = kernel_phase(peaks_for(card), REPS, want)
    rows2, extra2 = kernel_phase_flagship(peaks_for(card), REPS, want)
    rows3, extra3 = kernel_phase_base(peaks_for(card), REPS, want)
    rows4, extra4 = kernel_phase_fp8(peaks_for(card), REPS, want)
    rows5, extra5 = kernel_phase_cog(peaks_for(card), REPS, want)
    extra6 = kernel_phase_hunyuan(peaks_for(card), REPS, want)
    extra7 = kernel_phase_wan_runners(peaks_for(card), REPS, want)
    extra8 = kernel_phase_quant_linears(peaks_for(card), REPS, want)
    extra9 = kernel_phase_dist_ranks(peaks_for(card), REPS, want)
    print(json.dumps({"dist_ranks": extra9}), flush=True)
    rows += rows2 + rows3 + rows4 + rows5
    print(json.dumps({"other_shapes": extra + extra2 + extra3 + extra4 + extra5 + extra6 + extra7 + extra8 + extra9}),
          flush=True)
    kernel_phases_end = time.perf_counter() - t_start
    by_path = {}
    paths = [] if args.kernels_only else args.path or list(PATHS)
    guard_exact_dot()
    if "slice" in paths or "serve" in paths:  # the serve path serves the slice path's runner
        block_reference_check("int8", INT8, perturbation=True)
        ref = {}

        def keep(runner, frames):
            ref.update(runner=runner, frames=frames)
            return {}

        by_path["slice"] = ref["counts"] = run_path("slice", {}, args.profile, steps=SLICE_STEPS, forwards=SLICE_STEPS,
                                                    after=keep if "serve" in paths else None)
    if "serve" in paths:
        by_path["serve"] = run_serve(ref)
        del ref
    if "flagship" in paths:
        block_reference_check("int4", INT4A8)
        by_path["flagship"] = run_path("flagship", FLAGSHIP, args.profile, steps=SLICE_STEPS, forwards=SLICE_STEPS)
    if "base" in paths:
        block_reference_check("int4", INT4W, "sage_attn2")
        by_path["base"] = run_path("base", BASE, args.profile, model_cls="wan2.1", config_json=BASE_JSON)
    if "radial_bsr" in paths:
        by_path["radial_bsr"] = run_path("radial_bsr", RADIAL_BSR, args.profile)
    if "radial_two_pass" in paths:
        by_path["radial_two_pass"] = run_path("radial_two_pass", RADIAL_TWO_PASS, args.profile)
    if "fp8_distill" in paths:
        # bar 6e-2: a flip moves an e4m3 code by up to 1/8 of its value and an
        # int8 code by 1/127 of its row's max, so the fp8 block amplifies the
        # same bf16 noise ~3x the int8 block (the block_perturbation lines of
        # the two checks; PERF.md, PR 6)
        block_reference_check("fp8", FP8, rtol=6e-2, perturbation=True)
        by_path["fp8_distill"] = run_path("fp8_distill", FP8_DISTILL, args.profile, config_json=FP8_JSON,
                                          steps=FP8_STEPS, forwards=FP8_STEPS)
    if "i2v" in paths:
        block_reference_check("int8", INT8, i2v=True)
        clip_reference_check()
        vae_encode_check()
        with tempfile.TemporaryDirectory() as tmp:
            image = write_image(str(Path(tmp) / "i2v_input.png"))
            by_path["i2v"] = run_path("i2v", dict(task="i2v", image_path=image), args.profile, config_json=I2V_JSON,
                                      steps=I2V_STEPS, forwards=I2V_STEPS)
    if "cogvideox" in paths:
        cog_block_reference_check()
        cog_vae_decode_check()
        by_path["cogvideox"] = run_path("cogvideox", dict(negative_prompt="blurry, low quality, distorted"),
                                        args.profile, model_cls="cogvideox", config_json=COG_JSON, steps=COG_STEPS)
    if "hunyuan" in paths:
        hunyuan_block_reference_check()
        hunyuan_vae_decode_check()
        by_path["hunyuan"] = run_hunyuan_from_files(args.profile)
    if "hunyuan_i2v_tea" in paths:
        by_path["hunyuan_i2v_tea"] = run_path("hunyuan_i2v_tea", HY_I2V, args.profile, model_cls="hunyuan",
                                              config_json=HY_JSON, cut=HY_I2V_CUT, after=check_hunyuan_i2v)
    if "hunyuan_quant" in paths:
        by_path["hunyuan_quant"] = run_hunyuan_quant()
    if "cogvideox_quant" in paths:
        by_path["cogvideox_quant"] = run_cogvideox_quant()
    if "vae_encoders" in paths:
        run_vae_encoders()
    if any(p in paths for p in CACHED):
        caching_reference_check()
    for name in [p for p in PATHS if p in paths and (p in CACHED or p == "changing_resolution")]:
        config_json, widths = (CR_JSON, WAN14B) if name == "changing_resolution" else CACHED[name][:2]
        by_path[name] = run_path(name, dict(widths, negative_prompt=NEG), args.profile, model_cls="wan2.1",
                                 config_json=config_json, cut=True)
    if "offload_stream_fp8" in paths:
        by_path["offload_stream_fp8"] = run_path("offload_stream_fp8", WAN14B, args.profile, config_json=STREAM_JSON,
                                                 before=offload_step0_check, steps=SLICE_STEPS, forwards=SLICE_STEPS)
    if "offload_stream_tea" in paths:
        by_path["offload_stream_tea"] = stream_tea(args.profile)
    if "offload_lazy_t2v_tiny" in paths:
        vae_int8_check()
    if any(p in paths for p in ("offload_lazy_i2v", *LAZY_T2V)):
        by_path.update(run_offload_lazy(paths, args.profile))
    if "causvid" in paths:
        by_path["causvid"] = run_causvid(args.profile)
    if "skyreels_df" in paths:
        by_path["skyreels_df"] = run_path("skyreels_df", dict(WAN14B, negative_prompt=NEG), args.profile,
                                          model_cls="wan2.1_skyreels_v2_df", config_json=DF_JSON, steps=DF_ROWS,
                                          forwards=DF_ROWS)
    if "audio" in paths:
        by_path["audio"] = run_audio(args.profile)
    if "audio_encoder" in paths:
        run_audio_encoder()
    if "quant_schemes" in paths:
        run_quant_schemes()
    if "ptq" in paths:
        by_path["ptq"] = run_ptq(args.profile)
    if "dist" in paths:
        torch.cuda.empty_cache()
        by_path["dist"] = run_dist()
    for r in rows:
        r["launches_by_path"] = {p: c.get(r["name"], 0) for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        r["kernel_ms"] = r["ms"]
    reset_launch_counts()
    print(json.dumps({"elapsed_s": {"build_and_kernel_phases": kernel_phases_end,
                                    "total": time.perf_counter() - t_start}}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
