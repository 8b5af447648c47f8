"""CogVideoX1.5 DiT architecture and its 3D RoPE tables (counterpart of
``lightx2v_tpu.models.cogvideox.model``'s ``CogArch`` and
``build_cog_rope``). Host numpy, as in the JAX package."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class CogArch:
    num_layers: int = 42
    num_heads: int = 48
    head_dim: int = 64
    text_len: int = 226
    text_dim: int = 4096
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    patch_size_t: int = 2
    time_embed_dim: int = 512

    @property
    def dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def ffn_dim(self) -> int:
        return 4 * self.dim


def build_cog_rope(arch: CogArch, f: int, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """3D RoPE over the (f, h, w) token grid, head_dim split t : h : w =
    1/4 : 3/8 : 3/8, theta 10000, in the interleaved pair form. Returns
    cos, sin (f*h*w, head_dim//2) fp32."""
    d = arch.head_dim
    dim_t, dim_h = d // 4, d * 3 // 8
    dim_w = d - dim_t - dim_h
    cos_p, sin_p = [], []
    for i, (dim, size) in enumerate(((dim_t, f), (dim_h, h), (dim_w, w))):
        freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        ang = np.outer(np.arange(size, dtype=np.float64), freqs)
        shape = [1, 1, 1, ang.shape[1]]
        shape[i] = size
        ang = np.broadcast_to(ang.reshape(shape), (f, h, w, ang.shape[1]))
        cos_p.append(np.cos(ang))
        sin_p.append(np.sin(ang))
    cos = np.concatenate(cos_p, -1).reshape(f * h * w, -1).astype(np.float32)
    sin = np.concatenate(sin_p, -1).reshape(f * h * w, -1).astype(np.float32)
    return cos, sin
