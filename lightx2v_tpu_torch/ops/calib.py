"""Activation calibration for PTQ (counterpart of ``lightx2v_tpu.ops.calib``).

The ``Calib`` mm type runs the Default GEMM and records the per-in-channel
absmax of its input in a collector, keyed by the weight tensor's identity.
The reduction runs where x lies and the running maximum stays there: no
read to the host per call (``named_stats`` reads them all once)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils.registry import MM_REGISTER


class CalibCollector:
    """Per-tensor activation stats: the absmax over every axis but the
    channel axis, maximum over calls."""

    def __init__(self):
        self.stats: Dict[int, torch.Tensor] = {}
        self._names: Dict[int, str] = {}

    def reset(self):
        self.stats.clear()
        self._names.clear()

    def update(self, key: int, absmax: torch.Tensor):
        prev = self.stats.get(key)
        self.stats[key] = absmax if prev is None else torch.maximum(prev, absmax)

    def named_stats(self) -> Dict[str, np.ndarray]:
        return {self._names.get(k, str(k)): v.cpu().numpy() for k, v in self.stats.items()}


COLLECTOR = CalibCollector()


def input_absmax(x: torch.Tensor) -> torch.Tensor:
    """(..., C) -> (C,) fp32 max |x| over every axis but the last."""
    return x.float().abs().reshape(-1, x.shape[-1]).amax(dim=0)


@MM_REGISTER.register("Calib")
def mm_calib(params: Dict, x: torch.Tensor) -> torch.Tensor:
    from .linear import mm_default

    COLLECTOR.update(id(params.get("w")), input_absmax(x))
    return mm_default(params, x)
