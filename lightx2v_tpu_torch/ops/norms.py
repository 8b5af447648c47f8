"""Normalization ops (counterpart of ``lightx2v_tpu.ops.norms``).

Statistics in fp32, results cast back to the input dtype. Plain torch: the
JAX package has no Pallas kernel here."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis; the scale multiply stays in x's dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return x * inv.to(x.dtype) * weight.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    out = centered * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def modulated_layer_norm(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """AdaLN: LayerNorm(x) * (1 + scale) + shift in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    normed = centered * torch.rsqrt(var + eps)
    out = normed * (1.0 + scale.float()) + shift.float()
    return out.to(x.dtype)
