"""Spatially parallel Wan VAE decode (counterpart of
``lightx2v_tpu.parallel.vae_parallel``; the reference's
``models/video_encoders/hf/wan/vae.py:883-947``).

The latent W axis splits over ``sp`` with a 1-latent halo: each rank decodes
its chunk plus the halo (zero latents past the true edges), trims 8x the halo
and the chunks are all-gathered along W. With a ``tp`` axis that divides the
latent H, the decode runs on a 2-D grid, H over tp and W over sp, with the
halo on both axes, so an sp x tp mesh decodes on every rank; a tp that does
not divide H falls back to the 1-D split (``:37-40`` there). Interior seams
carry the 1-pixel-halo approximation the reference accepts. Every dp row of
the mesh decodes the same frames.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..vae.wan_vae import WanVAEConfig, vae_decode
from .mesh import Mesh, all_gather_cat, mesh_axis_size

HALO = 1


def halo_chunk(z: torch.Tensor, i_w: int, n_w: int, i_h: int = 0, n_h: int = 1) -> torch.Tensor:
    """The latent chunk (row ``i_h`` of ``n_h``, column ``i_w`` of ``n_w``)
    with its halo: z (B, T, h, w, C) zero-padded by ``HALO`` on the split
    axes, then sliced."""
    b, t, h, w, c = z.shape
    ph = HALO if n_h > 1 else 0
    zp = F.pad(z, (0, 0, HALO, HALO, ph, ph))
    ch, cw = h // n_h, w // n_w
    return zp[:, :, i_h * ch:i_h * ch + ch + 2 * ph, i_w * cw:i_w * cw + cw + 2 * HALO]


def trim(frames: torch.Tensor, two_d: bool) -> torch.Tensor:
    """Drop the 8x-halo pixel border of a decoded chunk (B, T', H, W, 3)."""
    e = 8 * HALO
    frames = frames[:, :, :, e:-e]
    return frames[:, :, e:-e] if two_d else frames


def parallel_vae_decode(params, z: torch.Tensor, cfg: WanVAEConfig, mesh: Mesh, scale: bool = True,
                        chunk: int = 4) -> torch.Tensor:
    """z (B, T, h, w, C), the same on every rank -> frames (B, T', 8h, 8w,
    3), the same on every rank. w must divide sp."""
    n_w, n_h = mesh_axis_size(mesh, "sp"), mesh_axis_size(mesh, "tp")
    h, w = z.shape[2], z.shape[3]
    two_d = n_h > 1 and h % n_h == 0
    if not two_d and n_w == 1:
        return vae_decode(params, z, cfg, scale=scale, chunk=chunk)
    if w % n_w:
        raise ValueError(f"latent width {w} does not divide sp = {n_w}")
    zc = halo_chunk(z, mesh.index("sp"), n_w, mesh.index("tp") if two_d else 0, n_h if two_d else 1)
    out = trim(vae_decode(params, zc, cfg, scale=scale, chunk=chunk), two_d)
    out = all_gather_cat(out, mesh, "sp", 3)
    return all_gather_cat(out, mesh, "tp", 2) if two_d else out
