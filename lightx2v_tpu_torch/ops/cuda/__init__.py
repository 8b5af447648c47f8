"""Hand-written CUDA kernels (``lightx2v_tpu_torch/csrc``) and their wrappers.

Each wrapper counts its launches in its module's ``LAUNCHES`` dict; the
helpers here read and reset all of them together."""

from __future__ import annotations

from typing import Dict

from . import flash_attention, w8a8_matmul

_COUNTERS = (flash_attention.LAUNCHES, w8a8_matmul.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
