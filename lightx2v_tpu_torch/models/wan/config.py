"""Wan2.1 DiT architecture description (counterpart of
``lightx2v_tpu.models.wan.config``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class WanArch:
    dim: int = 1536
    ffn_dim: int = 8960
    num_heads: int = 12
    num_layers: int = 30
    in_dim: int = 16
    out_dim: int = 16
    freq_dim: int = 256
    text_len: int = 512
    text_dim: int = 4096
    clip_dim: int = 1280
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    eps: float = 1e-6
    task: str = "t2v"
    enable_dynamic_cfg: bool = False
    # q/k in half-split rope-pair layout (weights permuted at load) and RoPE
    # applied inside the flash kernel (weights.permute_qk_half)
    rope_fused: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


PRESETS = {
    "wan2.1_1.3b": dict(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30),
    "wan2.1_14b": dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40),
}


def is_published_width(arch: WanArch) -> bool:
    """True when the arch has the widths of a published Wan2.1 model."""
    return any(arch.dim == p["dim"] and arch.ffn_dim == p["ffn_dim"] and arch.num_heads == p["num_heads"]
               for p in PRESETS.values())


def arch_from_config(config) -> WanArch:
    """Build a WanArch from the merged run config (dict-like)."""
    kw = {}
    for f_ in WanArch.__dataclass_fields__:
        if f_ == "task":
            kw[f_] = config.get("task", "t2v")
        elif f_ == "patch_size":
            kw[f_] = tuple(config.get("patch_size", (1, 2, 2)))
        elif f_ in config:
            kw[f_] = config[f_]
    if config.get("task") == "i2v" and "in_dim" not in config:
        kw["in_dim"] = 36
    kw["enable_dynamic_cfg"] = bool(config.get("enable_dynamic_cfg", False))
    kw["rope_fused"] = bool(config.get("rope_fused", False))
    return WanArch(**kw)
