"""3D rotary position embeddings (counterpart of ``lightx2v_tpu.ops.rope``).

Tables are host numpy (fp32), built exactly as in the JAX package; the
rotation runs in fp32 and casts back per half, as there."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def rope_params_1d(max_len: int, dim: int, theta: float = 10000.0) -> np.ndarray:
    """Per-axis rope angles: (max_len, dim//2) fp32."""
    assert dim % 2 == 0
    inv = 1.0 / np.power(theta, np.arange(0, dim, 2, dtype=np.float64) / dim)
    angles = np.outer(np.arange(max_len, dtype=np.float64), inv)
    return angles.astype(np.float32)


def build_wan_rope_grid(head_dim: int, f: int, h: int, w: int, max_len: int = 1024,
                        start_frame: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables over the flattened (f*h*w) token grid, each
    (f*h*w, head_dim//2) fp32."""
    c = head_dim // 2
    d_t = head_dim - 4 * (head_dim // 6)
    d_hw = 2 * (head_dim // 6)
    ang_t = rope_params_1d(max_len, d_t)
    ang_h = rope_params_1d(max_len, d_hw)
    ang_w = rope_params_1d(max_len, d_hw)
    a_t = ang_t[start_frame:start_frame + f][:, None, None, :]
    a_h = ang_h[:h][None, :, None, :]
    a_w = ang_w[:w][None, None, :, :]
    grid = np.concatenate(
        [
            np.broadcast_to(a_t, (f, h, w, a_t.shape[-1])),
            np.broadcast_to(a_h, (f, h, w, a_h.shape[-1])),
            np.broadcast_to(a_w, (f, h, w, a_w.shape[-1])),
        ],
        axis=-1,
    ).reshape(f * h * w, c)
    return np.cos(grid), np.sin(grid)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs. x: (..., S, N, D); cos/sin: (S_rope, D//2).
    Tokens past the table pass through unchanged."""
    s_rope = cos.shape[0]
    seq = x.shape[-3]
    xr = x[..., :s_rope, :, :]
    even = xr[..., 0::2].float()
    odd = xr[..., 1::2].float()
    c = cos[:, None, :].float()
    s = sin[:, None, :].float()
    out_even = (even * c - odd * s).to(x.dtype)
    out_odd = (even * s + odd * c).to(x.dtype)
    rotated = torch.stack([out_even, out_odd], dim=-1).reshape(xr.shape)
    if s_rope < seq:
        rotated = torch.cat([rotated, x[..., s_rope:, :, :]], dim=-3)
    return rotated


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotation in half-split pair layout (feature i pairs with i + D/2),
    for q/k projections permuted by ``models.wan.weights.permute_qk_half``."""
    s_rope = cos.shape[0]
    seq = x.shape[-3]
    d2 = x.shape[-1] // 2
    xr = x[..., :s_rope, :, :]
    x1 = xr[..., :d2].float()
    x2 = xr[..., d2:].float()
    c = cos[:, None, :].float()
    s = sin[:, None, :].float()
    lo = (x1 * c - x2 * s).to(x.dtype)
    hi = (x1 * s + x2 * c).to(x.dtype)
    rotated = torch.cat([lo, hi], dim=-1)
    if s_rope < seq:
        rotated = torch.cat([rotated, x[..., s_rope:, :, :]], dim=-3)
    return rotated


def rope_tables_full(cos: torch.Tensor, sin: torch.Tensor):
    """(S, D/2) pair tables -> full-width (S, D) tables for the half-split
    rotation rot(x) = x*[c|c] + roll_half(x)*[-s|s]."""
    cos_full = torch.cat([cos, cos], dim=-1)
    sin_full = torch.cat([-sin, sin], dim=-1)
    return cos_full.float(), sin_full.float()


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """Timestep embedding: [cos | sin] halves."""
    assert dim % 2 == 0
    half = dim // 2
    pos = position.float()
    freqs = torch.pow(torch.tensor(10000.0, dtype=torch.float32, device=pos.device),
                      -torch.arange(half, dtype=torch.float32, device=pos.device) / half)
    sinusoid = pos[..., None] * freqs
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)


def guidance_scale_embedding(w: torch.Tensor, embedding_dim: int = 256, cfg_range=(1.0, 8.0),
                             target_range: float = 1000.0) -> torch.Tensor:
    """CFG-scale conditioning embedding of dynamic-CFG distilled models:
    w (B,) -> (B, embedding_dim) fp32, [sin | cos] halves of w mapped from
    ``cfg_range`` onto [0, ``target_range``]."""
    cfg_min, cfg_max = cfg_range
    wn = (w.float() - cfg_min) / (cfg_max - cfg_min) * target_range
    half = embedding_dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=w.device) * (-math.log(10000.0) / (half - 1)))
    emb = wn[:, None] * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)

