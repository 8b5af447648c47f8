"""TeaCache: timestep-embedding-aware whole-stack skipping (counterpart of
``lightx2v_tpu.caching.teacache``).

A polynomial-rescaled relative L1 distance between consecutive timestep
embeddings accumulates; while the accumulator stays under
``teacache_thresh`` the block stack is skipped and the cached residual
re-applied (``x + prev_residual``). Warm-up (``ret_steps``) and tail
(``cutoff_steps``) always compute.

The decision depends only on the timestep-embedding series, never on the
latents, so the port decides on the host: ``tea_decision_series`` replays
the whole run's decisions before the first step, and the denoise loop reads
no device value per step. ``tea_decide`` / ``tea_decide_per_side`` are the
step-by-step forms (same arithmetic, on tensors) that the replay equals.
With batched CFG the shared decision computes if either side's accumulator
crosses the threshold; the per-side form decides each row alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

FP8_MAX = 448.0


@dataclass(frozen=True)
class TeaCacheConfig:
    thresh: float = 0.26
    coefficients: Tuple[float, ...] = (2.39676752e03, -1.31110545e03, 2.01331979e02, -8.29855975e00, 1.37887774e-01)
    use_ret_steps: bool = False
    ret_steps: int = 1  # in denoise steps
    cutoff_steps: int = 10**9

    @staticmethod
    def from_config(config) -> "TeaCacheConfig":
        use_ret = bool(config.get("use_ret_steps", False))
        coeffs = config.get("coefficients")
        c = tuple(coeffs[0] if use_ret else coeffs[1]) if coeffs else TeaCacheConfig.coefficients
        steps = int(config.infer_steps)
        return TeaCacheConfig(thresh=float(config.get("teacache_thresh", 0.26)), coefficients=c,
                              use_ret_steps=use_ret, ret_steps=5 if use_ret else 1,
                              cutoff_steps=steps if use_ret else steps - 1)


def store(res: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast a cached tensor to its cache dtype; e4m3 is clipped to +-448
    first, so an outlier saturates as the JAX package's clip does."""
    if dtype == torch.float8_e4m3fn:
        res = res.float().clamp(-FP8_MAX, FP8_MAX)
    return res.to(dtype)


def init_tea_state(x_shape, modulated_shape, dtype=torch.bfloat16, device="cpu") -> Dict:
    b = modulated_shape[0]
    return {"prev_mod": torch.zeros(modulated_shape, dtype=torch.float32, device=device),
            "prev_residual": torch.zeros(x_shape, dtype=dtype, device=device),
            "accum": torch.zeros((b,), dtype=torch.float32, device=device)}


def _polyval(coeffs, x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    for c in coeffs:
        out = out * x + torch.tensor(c, dtype=torch.float32)
    return out


def _accumulate(state: Dict, embed, embed0, cfg: TeaCacheConfig):
    modulated = (embed0 if cfg.use_ret_steps else embed).float()
    flat = modulated.reshape(modulated.shape[0], -1)
    prev = state["prev_mod"].reshape(flat.shape)
    rel = (flat - prev).abs().mean(1) / torch.clamp_min(prev.abs().mean(1), 1e-8)
    return modulated, state["accum"] + _polyval(cfg.coefficients, rel)


def tea_decide(state: Dict, embed, embed0, step_index: int, cfg: TeaCacheConfig):
    """-> (should_calc, new_state): one decision shared by the batch rows."""
    modulated, accum = _accumulate(state, embed, embed0, cfg)
    warmup = step_index < cfg.ret_steps or step_index >= cfg.cutoff_steps
    should = warmup or bool((accum >= cfg.thresh).any())
    if should:
        accum = torch.zeros_like(accum)
    return should, {**state, "prev_mod": modulated, "accum": accum}


def tea_decide_per_side(state: Dict, embed, embed0, step_index: int, cfg: TeaCacheConfig):
    """-> (should (B,) bool tensor, new_state): each batch row (CFG side)
    decides alone and resets only its own accumulator."""
    modulated, accum = _accumulate(state, embed, embed0, cfg)
    warmup = step_index < cfg.ret_steps or step_index >= cfg.cutoff_steps
    should = torch.full_like(accum, True, dtype=torch.bool) if warmup else accum >= cfg.thresh
    accum = torch.where(should, torch.zeros_like(accum), accum)
    return should, {**state, "prev_mod": modulated, "accum": accum}


def tea_decision_series(mod_series, cfg: TeaCacheConfig, per_side: bool = False,
                        first_step: int = 0) -> np.ndarray:
    """Host replay of ``tea_decide`` (or, with ``per_side``,
    ``tea_decide_per_side``) over a run: ``mod_series`` is the per-step
    modulated input (``embed``, or ``embed0`` under ``use_ret_steps``)
    stacked to (S, B, ...), or (S, D) for one row. Step ``j`` of the series
    is denoise step ``first_step + j``. -> (S,) bools, or (S, B) per side."""
    mods = np.asarray(mod_series, np.float32)
    s = len(mods)
    mods = mods.reshape(s, mods.shape[1], -1) if mods.ndim >= 3 else mods.reshape(s, 1, -1)
    coeffs = np.asarray(cfg.coefficients, np.float32)
    prev = np.zeros_like(mods[0])
    accum = np.zeros(mods.shape[1], np.float32)
    out = np.zeros((s, mods.shape[1]) if per_side else s, bool)
    for j in range(s):
        i = first_step + j
        rel = np.abs(mods[j] - prev).mean(axis=1) / np.maximum(np.abs(prev).mean(axis=1), 1e-8)
        accum = accum + np.polyval(coeffs, rel).astype(np.float32)
        warmup = i < cfg.ret_steps or i >= cfg.cutoff_steps
        if per_side:
            should = np.full(accum.shape, True) if warmup else accum >= cfg.thresh
            accum[should] = 0.0
        else:
            should = warmup or bool(np.any(accum >= cfg.thresh))
            if should:
                accum[:] = 0.0
        out[j] = should
        prev = mods[j]
    return out


def tea_transform(state: Dict, should_calc: bool, x: torch.Tensor, transformer_fn: Callable):
    """Run the block stack and cache its residual, or skip it and re-apply
    the cached residual. The residual is taken in x's dtype, as in JAX."""
    if not should_calc:
        return x + state["prev_residual"].to(x.dtype), state
    x_out = transformer_fn(x)
    state = {**state, "prev_residual": store(x_out - x, state["prev_residual"].dtype)}
    return x_out, state


def tea_transform_per_side(state: Dict, should, x: torch.Tensor, transformer_fn: Callable,
                           transformer_fn_single: Optional[Callable] = None):
    """Per-side run-or-skip for the CFG pair x = [cond, uncond]: both
    compute (one batch-2 forward), one computes (a batch-1 forward on that
    side's conditioning, the cached residual for the other), or neither.
    ``transformer_fn_single(x_one, side)`` runs the batch-1 forward. A
    one-sided step writes its side's residual in place."""
    single = transformer_fn_single or (lambda x_one, side: transformer_fn(x_one))
    cond, uncond = bool(should[0]), bool(should[1])
    res = state["prev_residual"]
    if cond and uncond:
        x_out = transformer_fn(x)
        return x_out, {**state, "prev_residual": store(x_out - x, res.dtype)}
    if not (cond or uncond):
        return x + res.to(x.dtype), state
    side = 0 if cond else 1
    skipped = 1 - side
    xi = x[side:side + 1]
    xo = single(xi, side)
    xs = x[skipped:skipped + 1] + res[skipped:skipped + 1].to(x.dtype)
    res[side] = store(xo[0] - xi[0], res.dtype)
    return torch.cat([xo, xs] if side == 0 else [xs, xo]), state
