"""Per-layer Sparge l1 tuning (counterpart of ``lightx2v_tpu.tools.tune_sparge``),
the offline half of the ``sparge_ckpt`` workflow.

1. One calibration forward runs the block stack on the dense trajectory
   (every self- and cross-attention through the dense flash kernel),
   capturing each layer's post-RoPE q, k, v and its dense output.
2. Per layer, the l1 grid is evaluated in descending order (a larger l1
   skips more softmax mass) on the port's Sparge path: the block selection,
   then the per-head block-sparse kernel on the card (its plain version on
   the CPU). The first candidate whose output keeps SNR >= ``bar_db``
   against the dense output wins; if none does, the layer takes l1 = 0.0
   (the densest selection the keep cap allows) and is flagged.
3. The table is written as an ``.npz`` with ``l1`` (num_layers,),
   ``snr_db``, ``passed``, ``keep_ratio`` and ``bar_db``: what the runner's
   ``sparge_ckpt`` key reads.

The signal term of the SNR is computed once per layer, outside the grid; the
error is a mean over the elements (with ``eval_head_chunk``, summed over
head chunks and divided by the element count), floored at 1e-30. The
per-candidate SNRs stay on the device until the layer's grid is done.

    python -m lightx2v_tpu_torch.tools.tune_sparge --structured --preset 14b \
        [--trajectory N] [--eval_head_chunk 8] [--output table.npz] [--device cpu]

``--synthetic`` / ``--structured`` tables are protocol checks: synthetic
weights flatten block importance, structured ones only imitate it.
"""

from __future__ import annotations

import argparse
import json
from functools import partial
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.wan.config import PRESETS, WanArch
from ..models.wan.model import wan_block, wan_pre_process
from ..models.wan.pipeline import rope_for_shape
from ..ops.attention import attention
from ..ops.linear import resolve_mm
from ..ops.rope import apply_rope_half
from ..ops.sparge import sparge_attention

DEFAULT_L1_GRID = (0.30, 0.25, 0.20, 0.15, 0.10, 0.07, 0.05, 0.02)


def grid_snrs(q, k, v, dense_out, l1s: Sequence[float], keep_ratio: float, block_q: int, block_k: int,
              head_chunk: int = 0) -> torch.Tensor:
    """SNR (dB, fp32, on the device) of the Sparge output against the dense
    one for each l1 of ``l1s``; ``head_chunk`` > 0 evaluates that many heads
    at a time (Sparge's selection is per (batch, head), so the SNRs are the
    whole tensor's)."""
    n = q.shape[2]
    if head_chunk and n % head_chunk:
        raise ValueError(f"head_chunk={head_chunk} must divide num_heads={n}")
    chunk = head_chunk or n
    count = dense_out.numel()
    sig = sum((dense_out[:, :, h:h + chunk].float() ** 2).sum() for h in range(0, n, chunk)) / count
    out = []
    for l1 in l1s:
        err = 0.0
        for h in range(0, n, chunk):
            sl = slice(h, h + chunk)
            o = sparge_attention(q[:, :, sl], k[:, :, sl], v[:, :, sl], keep_ratio=keep_ratio, l1=float(l1),
                                 block_q=block_q, block_k=block_k)
            err = err + ((o.float() - dense_out[:, :, sl].float()) ** 2).sum()
        out.append(10.0 * torch.log10(sig / torch.clamp_min(err / count, 1e-30)))
    return torch.stack(out)


def tune_layer(q, k, v, dense_out, keep_ratio: float, l1_grid: Sequence[float], bar_db: float, block_q: int,
               block_k: int, head_chunk: int = 0) -> Tuple[float, float, bool]:
    """(l1, its SNR in dB, passed): the largest l1 of the grid (plus a
    terminal 0.0) whose SNR meets ``bar_db``, else 0.0 and the SNR there."""
    grid = sorted(set(l1_grid) | {0.0}, reverse=True)
    snrs = grid_snrs(q, k, v, dense_out, grid, keep_ratio, block_q, block_k, head_chunk).cpu().numpy()
    for l1, s in zip(grid, snrs):
        if s >= bar_db:
            return float(l1), float(s), True
    return 0.0, float(snrs[-1]), False


def tune_sparge(params, arch: WanArch, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor, *,
                y: Optional[torch.Tensor] = None, clip_fea: Optional[torch.Tensor] = None, mm_type: str = "Default",
                keep_ratio: float = 0.3, l1_grid: Sequence[float] = DEFAULT_L1_GRID, bar_db: float = 30.0,
                block_q: int = 2048, block_k: int = 1024, head_chunk: int = 0, verbose: bool = True):
    """A per-layer l1 table from one (latents, t, context) sample on the
    dense trajectory: every layer's input is the dense stack's activation.
    Returns (l1 (L,) fp32, snr_db (L,) fp32, passed (L,) bool)."""
    dev = latents.device
    rope_cos, rope_sin, _ = rope_for_shape(arch, tuple(latents.shape[1:]), device=dev)
    x, _embed, embed0, ctx, ctx_img, _grid, _s = wan_pre_process(params, latents, t, context, arch, y=y,
                                                                 clip_fea=clip_fea)
    mm_fn = resolve_mm(mm_type)
    cross_fn = partial(attention, "flash_attn3")
    l1s, snrs, passed = [], [], []
    for i, blk in enumerate(params["blocks"]):
        cap = []

        def cap_fn(q, k, v, **kw):
            if "rope_cos" in kw:  # rope_fused: rotate here, as every non-flash dispatch does
                q = apply_rope_half(q, kw["rope_cos"], kw["rope_sin"])
                k = apply_rope_half(k, kw["rope_cos"], kw["rope_sin"])
            out = attention("flash_attn3", q, k, v)
            cap.append((q, k, v, out))
            return out

        x = wan_block(blk, x, embed0, ctx, ctx_img, rope_cos, rope_sin, arch, mm_fn, cap_fn, cross_fn)
        (q, k, v, dense_out), = cap
        l1, s, ok = tune_layer(q, k, v, dense_out, keep_ratio, l1_grid, bar_db, block_q, block_k, head_chunk)
        del cap, q, k, v, dense_out
        l1s.append(l1)
        snrs.append(s)
        passed.append(ok)
        if verbose:
            from ..utils.logging_utils import logger

            flag = "" if ok else "  [no candidate met the bar: l1 = 0.0, the densest selection in the cap]"
            logger.info(f"layer {i:02d}: l1={l1:.3f} snr={s:.1f} dB{flag}")
    return np.asarray(l1s, np.float32), np.asarray(snrs, np.float32), np.asarray(passed, bool)


def save_table(path: str, l1s, snrs, passed, keep_ratio: float, bar_db: float) -> None:
    np.savez(path, l1=np.asarray(l1s, np.float32), snr_db=np.asarray(snrs, np.float32),
             passed=np.asarray(passed, bool), keep_ratio=np.float32(keep_ratio), bar_db=np.float32(bar_db))


def worst_case(per_sample):
    """Per layer over samples: the smallest l1, the lowest SNR, passed only
    where every sample passed."""
    return (np.min(np.stack([r[0] for r in per_sample]), axis=0), np.min(np.stack([r[1] for r in per_sample]), axis=0),
            np.all(np.stack([r[2] for r in per_sample]), axis=0))


def trajectory_samples(params, arch: WanArch, context: torch.Tensor, target, steps: int, fracs: Sequence[float],
                       seed: int, mm_type: str, device):
    """(latents, t) at the given fractions of a dense ``steps``-step UniPC
    trajectory (shift 5, no CFG, dense flash attention)."""
    from ..models.wan.pipeline import make_denoise_fn
    from ..schedulers.unipc import WanUniPCScheduler
    from ..utils.config import ConfigDict

    sched = WanUniPCScheduler(ConfigDict(infer_steps=steps, sample_shift=5.0))
    gen = torch.Generator(device=device).manual_seed(seed)
    state = sched.prepare(target, gen, device=device)
    step = make_denoise_fn(arch, sched, target, mm_type=mm_type, self_attn_type="flash_attn3",
                           cross_attn_type="flash_attn3", num_steps=1, device=device)
    cap = sorted({min(steps - 1, max(0, int(float(fr) * steps))) for fr in fracs})
    samples = []
    for i in range(steps):
        if i in cap:
            lat, t = sched.step_pre(state)
            samples.append((lat[None], t.reshape(1).float()))
        state = step(params, state, context, gen)
    return samples


def build_params(arch: WanArch, args, device):
    """The tune's params: a checkpoint, or synthetic ones made on the device
    (``--structured``: with the trained-like structure, quantized block by
    block after it for a quantized ``--scheme``)."""
    from ..models.wan import weights as wts

    if args.model_path:
        from ..utils.safetensors_io import load_sharded

        return wts.load_wan_params(load_sharded(args.model_path), arch, device=device)
    scheme = "bf16" if args.scheme in ("bf16", "Default") else args.scheme
    if not args.structured:
        return wts.init_random_params_on_device(arch, scheme, seed=args.seed, device=device)
    params = wts.init_random_params_on_device(arch, "bf16", seed=args.seed, device=device, iter_blocks=True)
    blocks = []
    for i, blk in enumerate(params["blocks"]):
        blk = wts.structure_block(blk, seed=args.seed + 1 + 7919 * i)
        blocks.append(blk if scheme == "bf16" else wts.quantize_block(blk, scheme))
    return dict(params, blocks=blocks)


def main(argv=None):
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model_path", help="safetensors checkpoint dir (real weights)")
    ap.add_argument("--synthetic", action="store_true", help="synthetic gaussian weights (protocol check only)")
    ap.add_argument("--structured", action="store_true",
                    help="synthetic weights with trained-like structure (channel outliers, shared low-rank q/k "
                         "spikes: models/wan/weights.structure_block)")
    ap.add_argument("--trajectory", type=int, default=0, metavar="N",
                    help="calibrate on latents captured at --capture_fracs of a dense N-step UniPC trajectory, "
                         "each layer taking its worst case over them")
    ap.add_argument("--capture_fracs", default="0.1,0.5,0.9")
    ap.add_argument("--preset", default="1.3b", choices=["tiny", "1.3b", "14b"])
    ap.add_argument("--frames", type=int, default=21, help="latent frames")
    ap.add_argument("--height", type=int, default=60, help="latent height")
    ap.add_argument("--width", type=int, default=104, help="latent width")
    ap.add_argument("--timestep", type=float, default=500.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keep_ratio", type=float, default=0.3)
    ap.add_argument("--l1_grid", default=",".join(str(v) for v in DEFAULT_L1_GRID))
    ap.add_argument("--bar_db", type=float, default=30.0)
    ap.add_argument("--block_q", type=int, default=2048)
    ap.add_argument("--block_k", type=int, default=1024)
    ap.add_argument("--eval_head_chunk", type=int, default=0,
                    help="evaluate the SNR grid this many heads at a time (must divide num_heads; 0: all)")
    ap.add_argument("--mm_type", default="Default", help="matmul scheme of the capture stack")
    ap.add_argument("--scheme", default="bf16", help="synthetic weight scheme (bf16, int8, fp8, int4, ...)")
    ap.add_argument("--output", default="sparge_tuned.npz")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the tune runs (default cuda; cuda without a GPU raises)")
    args = ap.parse_args(argv)
    if not (args.model_path or args.synthetic or args.structured):
        ap.error("one of --model_path / --synthetic / --structured is required")
    device = resolve_device(args.device)

    if args.preset == "tiny":
        arch = WanArch(dim=256, ffn_dim=512, num_heads=4, num_layers=4, in_dim=16, out_dim=16, text_len=64,
                       text_dim=256)
    else:
        kw = PRESETS["wan2.1_14b" if args.preset == "14b" else "wan2.1_1.3b"]
        arch = WanArch(**kw, in_dim=16, out_dim=16, freq_dim=256, text_len=512, text_dim=4096)
    params = build_params(arch, args, device)

    rng = np.random.default_rng(args.seed)
    context = torch.from_numpy((rng.standard_normal((1, arch.text_len, arch.text_dim)) * 0.1).astype(np.float32))
    context = context.to(device, torch.bfloat16)
    target = (arch.in_dim, args.frames, args.height, args.width)
    if args.trajectory:
        samples = trajectory_samples(params, arch, context, target, args.trajectory,
                                     [float(f) for f in args.capture_fracs.split(",")], args.seed, args.mm_type,
                                     device)
    else:
        lat = torch.from_numpy((rng.standard_normal((1, *target)) * 0.5).astype(np.float32))
        samples = [(lat.to(device, torch.bfloat16), torch.tensor([args.timestep], device=device))]
    l1_grid = tuple(float(v) for v in args.l1_grid.split(","))
    per_sample = [tune_sparge(params, arch, lat, tt, context, mm_type=args.mm_type, keep_ratio=args.keep_ratio,
                              l1_grid=l1_grid, bar_db=args.bar_db, block_q=args.block_q, block_k=args.block_k,
                              head_chunk=args.eval_head_chunk) for lat, tt in samples]
    l1s, snrs, passed = worst_case(per_sample)
    save_table(args.output, l1s, snrs, passed, args.keep_ratio, args.bar_db)
    print(json.dumps({"output": args.output, "layers": int(len(l1s)), "samples": len(samples),
                      "structured": bool(args.structured), "l1_mean": float(l1s.mean()), "l1_min": float(l1s.min()),
                      "l1_max": float(l1s.max()), "l1_distinct": int(len(np.unique(l1s))),
                      "all_passed": bool(passed.all()), "failed_layers": [int(i) for i in np.nonzero(~passed)[0]],
                      "snr_min_db": float(snrs.min()), "device": str(device)}))


if __name__ == "__main__":
    main()
