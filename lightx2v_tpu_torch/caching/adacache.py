"""AdaCache: adaptive whole-stack skipping with a rate codebook (counterpart
of ``lightx2v_tpu.caching.adacache``).

A compute step records the middle block's gated self-attention output. The
L1 ratio between consecutive recordings, times a motion regulariser
("moreg") over one-frame token strides, indexes a codebook
{0.03: 12, 0.05: 10, 0.07: 8, 0.09: 6, 0.11: 4, else 3} that says how many
steps to skip; a skipped step replays the cached whole-stack residual.

The metric is reduced on the device. Only the step after a compute step
needs the new ``skip_until``, so ``ada_skip_length`` reads the metric to the
host once per compute step (one sync per compute step, none on a skip).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

CODEBOOK_THRESH = (0.03, 0.05, 0.07, 0.09, 0.11)
CODEBOOK_RATES = (12.0, 10.0, 8.0, 6.0, 4.0, 3.0)
MOREG_HYP = (0.385, 8.0, 1.0)
MOGRAD_MUL = 10.0


def init_ada_state(x_shape, dtype=torch.bfloat16, metric_scale: float = 1.0, device="cpu") -> Dict:
    return {"prev_residual": torch.zeros(x_shape, dtype=dtype, device=device),
            "prev_tiny": torch.zeros(x_shape, dtype=torch.float32, device=device),
            "has_tiny": False,
            "prev_moreg": torch.tensor(1.0, dtype=torch.float32, device=device),
            "skipped_len": 1.0,
            "skip_until": 0,
            "calc_count": 0,
            "metric_scale": float(metric_scale)}


def codebook_rate(metric: float) -> float:
    """The codebook's skip length for a metric, its thresholds compared in
    fp32 as the JAX package compares them."""
    for t, r in zip(CODEBOOK_THRESH, CODEBOOK_RATES):
        if metric < float(np.float32(t)):
            return r
    return CODEBOOK_RATES[-1]


def ada_skip_length(state: Dict, now_tiny: torch.Tensor, step_index: int, n_steps: int,
                    tokens_per_frame: int) -> Tuple[float, Dict]:
    """-> (rate, new_state). now_tiny: (B, S, D). The metric is the one
    value read to the host."""
    res = now_tiny.float()
    l1 = lambda t: t.abs().sum()  # noqa: E731
    cache = state["prev_tiny"]
    cache_diff = l1(cache - res) / torch.clamp_min(l1(cache), 1e-8) / state["skipped_len"]

    sd = tokens_per_frame
    a, b = res[:, sd:], res[:, :-sd]
    moreg_raw = l1(a - b) / torch.clamp_min(l1(a) + l1(b), 1e-8)
    moreg_on = int(0.1 * n_steps) <= step_index <= int(0.9 * n_steps)
    if moreg_on:
        moreg = ((moreg_raw / MOREG_HYP[0]) ** MOREG_HYP[1]) / MOREG_HYP[2]
    else:
        moreg = torch.ones_like(moreg_raw)
    mograd = MOGRAD_MUL * (moreg - state["prev_moreg"]) / state["skipped_len"]
    metric = cache_diff * (moreg + mograd.abs()) * state["metric_scale"]

    # first recording: rate 1
    rate = codebook_rate(float(metric)) if state["has_tiny"] else 1.0
    new = dict(state, prev_tiny=res, has_tiny=True, prev_moreg=moreg if moreg_on else state["prev_moreg"],
               skipped_len=rate, skip_until=step_index + int(rate))
    return rate, new
