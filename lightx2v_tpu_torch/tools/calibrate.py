"""Activation calibration -> smooth-quant (advanced_ptq) production
(counterpart of ``lightx2v_tpu.tools.calibrate``).

* ``collect_block_stats``: one forward through the blocks with the Default
  GEMM, an mm wrapper naming each matmul input by the block's fixed call
  order (``blocks.{i}.{linear}``) and recording its per-in-channel absmax;
* ``smooth_factors``: SmoothQuant s = act^alpha / w^(1 - alpha), clipped to
  [1e-2, 1e2], for the two smoothable sites (the self-attention's input and
  the FFN's);
* ``tools/convert.py --calib_stats`` folds them: weight columns times s,
  ``affine_norm1`` / ``affine_norm3`` = 1 / s.

The absmax of each input is reduced where it lies and kept there; a block's
stats are read to the host once, when the block ends (one copy per block,
not one per linear).

    python -m lightx2v_tpu_torch.tools.calibrate --output calib_stats.npz \
        [--model_path CKPT_DIR] [--task t2v] [--frames 3 --height 32 --width 32] [--device cpu]

Without ``--model_path`` it calibrates the JAX tool's small synthetic DiT
(dim 64, 2 layers, the same numpy weights).
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from ..ops.calib import input_absmax
from ..utils.logging_utils import logger

# wan_block_parts calls its mm_fn in this fixed order (models/wan/model.py)
_T2V_ORDER = [
    "self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o",
    "cross_attn.q", "cross_attn.k", "cross_attn.v", "cross_attn.o",
    "ffn.0", "ffn.2",
]
_I2V_ORDER = [
    "self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o",
    "cross_attn.q", "cross_attn.k", "cross_attn.v",
    "cross_attn.k_img", "cross_attn.v_img", "cross_attn.o",
    "ffn.0", "ffn.2",
]


class _NamingCalibMM:
    """mm_fn wrapper that names each call (block, linear) by the block's
    fixed matmul order and records its input's absmax on the device;
    ``end_block`` reads the block's stats to the host in one copy and folds
    them into ``stats`` (numpy fp32, maximum over calls)."""

    def __init__(self, stats: Dict[str, np.ndarray], order: List[str]):
        self.stats = stats
        self.order = order
        self.block_idx = 0
        self.call_idx = 0
        self._pending: List = []

    def start_block(self, i: int):
        self.block_idx = i
        self.call_idx = 0

    def __call__(self, params, x):
        from ..ops.linear import mm_default

        name = f"blocks.{self.block_idx}.{self.order[self.call_idx]}"
        self.call_idx += 1
        self._pending.append((name, input_absmax(x)))
        return mm_default(params, x)

    def end_block(self):
        if not self._pending:
            return
        flat = torch.cat([a for _, a in self._pending]).cpu().numpy()
        off = 0
        for name, a in self._pending:
            v = flat[off:off + a.numel()]
            off += a.numel()
            prev = self.stats.get(name)
            self.stats[name] = v if prev is None else np.maximum(prev, v)
        self._pending = []


def collect_block_stats(params, arch, latents, t, context, rope_cos, rope_sin, y=None, clip_fea=None,
                        self_attn_type: str = "xla") -> Dict[str, np.ndarray]:
    """One forward through the blocks (``params["blocks"]``: a list, or the
    offload tiers' streamer), every linear the Default GEMM, self- and
    cross-attention ``self_attn_type``; returns {"blocks.{i}.{linear}":
    per-in-channel absmax} (numpy fp32)."""
    from functools import partial

    from ..models.wan.model import wan_block, wan_pre_process
    from ..ops.attention import attention

    stats: Dict[str, np.ndarray] = {}
    i2v = arch.task == "i2v" and clip_fea is not None and "img_emb" in params
    mm = _NamingCalibMM(stats, _I2V_ORDER if i2v else _T2V_ORDER)
    attn_fn = partial(attention, self_attn_type)
    x, _embed, embed0, ctx_e, ctx_img, _grid, _s = wan_pre_process(params, latents, t, context, arch, y=y,
                                                                   clip_fea=clip_fea)
    n = 0
    for i, blk in enumerate(params["blocks"]):
        mm.start_block(i)
        x = wan_block(blk, x, embed0, ctx_e, ctx_img, rope_cos, rope_sin, arch, mm, attn_fn, attn_fn)
        mm.end_block()
        n += 1
    logger.info(f"calibrated {len(stats)} matmul inputs over {n} blocks")
    return stats


def smooth_factors(w_cols_absmax: np.ndarray, act_absmax: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """SmoothQuant per-in-channel factor s = act^a / w^(1-a), clipped to
    [1e-2, 1e2] (numpy fp32 on the host, as the JAX tool computes it)."""
    s = np.power(np.maximum(act_absmax, 1e-5), alpha) / np.power(np.maximum(w_cols_absmax, 1e-5), 1.0 - alpha)
    return np.clip(s, 1e-2, 1e2).astype(np.float32)


def save_stats(stats: Dict[str, np.ndarray], path: str) -> None:
    np.savez(path, **stats)


def load_stats(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def main(argv=None):
    from ..models.wan.config import WanArch, arch_from_config
    from ..models.wan.pipeline import rope_for_shape
    from ..models.wan.weights import init_random_weight_dict, load_wan_params
    from ..utils.device import resolve_device
    from ..utils.safetensors_io import load_sharded

    p = argparse.ArgumentParser(description="collect PTQ activation stats")
    p.add_argument("--model_path", default=None, help="checkpoint dir (omit for the small synthetic DiT)")
    p.add_argument("--output", required=True, help="output .npz stats file")
    p.add_argument("--task", default="t2v")
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--height", type=int, default=32)
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the forward runs (default cuda; cuda without a GPU raises)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.model_path:
        wd = load_sharded(args.model_path)
        n_layers = 1 + max(int(k.split(".")[1]) for k in wd if k.startswith("blocks."))
        dim = wd["patch_embedding.bias"].shape[0]
        arch = arch_from_config({"dim": dim, "num_layers": n_layers, "ffn_dim": wd["blocks.0.ffn.0.bias"].shape[0],
                                 "num_heads": max(2, dim // 128), "task": args.task})
    else:
        arch = WanArch(dim=64, ffn_dim=128, num_heads=2, num_layers=2, text_dim=32)
        wd = init_random_weight_dict(arch, seed=1)
    params = load_wan_params(wd, arch, device=device)

    rng = np.random.default_rng(args.seed)
    target = (arch.in_dim if args.task != "i2v" else 16, args.frames, args.height // 8, args.width // 8)
    lat = torch.from_numpy(rng.standard_normal((1, *target)).astype(np.float32)).to(device)
    t = torch.tensor([800.0], dtype=torch.float32, device=device)
    ctx = torch.from_numpy((rng.standard_normal((1, arch.text_len, arch.text_dim)) * 0.3).astype(np.float32))
    cos, sin, _ = rope_for_shape(arch, target, device=device)
    stats = collect_block_stats(params, arch, lat, t, ctx.to(device), cos, sin)
    save_stats(stats, args.output)
    logger.info(f"wrote {args.output}")


if __name__ == "__main__":
    main()
