"""Device resolution for the port's entry points: CUDA unless the caller
asks for the CPU, and never a silent drop to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available "
                           "(pass device='cpu' / --device cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
