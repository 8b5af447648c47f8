"""Wan2.1 causal 3D video VAE in PyTorch (counterpart of
``lightx2v_tpu.vae.wan_vae``): the encoder (i2v conditioning) and the
decoder.

Public functions keep the JAX layout: pixels (B, T, H, W, 3) and latents
(B, T, h, w, z). Inside, activations are channels-first (B, C, T, H, W) for
``F.conv3d`` (the JAX package has no Pallas kernel here); every 2D conv
runs as a conv3d with a temporal kernel of 1. The streams are the JAX ones:
the first frame encodes or decodes alone (it bypasses the temporal
resampling), then ``chunk`` latent frames at a time (4 * ``chunk`` pixel
frames when encoding), every causal conv carrying a 2-frame cache through a
``CacheTape``. The VAE runs in fp32; on CUDA the caller chooses TF32 for the
convolutions (``torch.backends.cudnn.allow_tf32``)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.wan.weights import to_tensor

CACHE_T = 2

WAN_LATENT_MEAN = [
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
]
WAN_LATENT_STD = [
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
]


@dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temperal_downsample: Tuple[bool, ...] = (False, True, True)

    @property
    def temperal_upsample(self):
        return tuple(reversed(self.temperal_downsample))


# --------------------------------------------------------------------------
# primitives (channels-first)


def cconv3d(p: Dict, x: torch.Tensor, cache: Optional[torch.Tensor], t_stride: int = 1,
            causal_pad: bool = True) -> torch.Tensor:
    """Causal 3D conv; weight (O, I, kt, kh, kw). ``cache`` supplies the
    temporal left context (else zero-pad by kt-1); spatial padding kh//2.
    ``causal_pad=False`` gives a temporally valid conv (the encoder's
    stride-2 time conv)."""
    w = p["w"]
    kt, kh, kw = w.shape[2:]
    pad_t = kt - 1 if causal_pad else 0
    if cache is not None:
        x = torch.cat([cache.to(x.dtype), x], dim=2)
        pad_t = max(pad_t - cache.shape[2], 0)
    if pad_t > 0:
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
    return F.conv3d(x, w.to(x.dtype), p.get("b"), stride=(t_stride, 1, 1), padding=(0, kh // 2, kw // 2))


def conv2d_down(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Per-frame stride-2 conv padded on the right and bottom only (the
    encoder's spatial downsample)."""
    return F.conv3d(F.pad(x, (0, 1, 0, 1)), p["w"].to(x.dtype), p.get("b"), stride=(1, 2, 2))


def rms_norm_ch(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """F.normalize over channels * sqrt(C) * gamma."""
    xf = x.float()
    norm = torch.sqrt((xf * xf).sum(dim=1, keepdim=True) + 1e-12)
    c = x.shape[1]
    g = p["g"].float().reshape(1, c, *([1] * (x.dim() - 2)))
    return (xf / norm * math.sqrt(c) * g).to(x.dtype)


def spatial_attention(p: Dict, x: torch.Tensor, q_chunk: int = 4096) -> torch.Tensor:
    """Single-head per-frame spatial self-attention (the softmax runs over
    query chunks to bound the logits' memory; same math)."""
    b, c, t, h, w = x.shape
    identity = x
    qkv = cconv3d(p["to_qkv"], rms_norm_ch(p["norm"], x), None)  # (B, 3C, T, H, W)
    qkv = qkv.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, 3 * c)
    q, k, v = qkv.split(c, dim=-1)
    out = torch.empty_like(q)
    inv = 1.0 / np.sqrt(c)
    for r0 in range(0, h * w, q_chunk):
        logits = torch.matmul(q[:, r0:r0 + q_chunk].float(), k.float().transpose(1, 2)) * inv
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out[:, r0:r0 + q_chunk] = torch.matmul(probs, v).to(out.dtype)
    out = out.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
    return identity + cconv3d(p["proj"], out, None)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)


class CacheTape:
    """Reads the previous chunk's conv caches and records this chunk's, in
    traversal order."""

    def __init__(self, prev: Optional[List]):
        self.prev = prev
        self.idx = 0
        self.new: List = []

    def pull(self):
        c = None if self.prev is None else self.prev[self.idx]
        self.idx += 1
        return c

    def push(self, new_cache):
        self.new.append(new_cache)


def _tail(x: torch.Tensor, n: int = CACHE_T) -> torch.Tensor:
    """Last n frames of x, left-padded with zeros if x is shorter. A copy:
    a view would keep all of x (a conv's whole input stream) alive in the
    tape until the next chunk."""
    t = x.shape[2]
    if t >= n:
        return x[:, :, t - n:].clone()
    return F.pad(x, (0, 0, 0, 0, n - t, 0))


def cconv3d_cached(p: Dict, x: torch.Tensor, tape: CacheTape) -> torch.Tensor:
    """The next chunk's cache is the last CACHE_T frames of the stream
    (cache, x); the two are joined only when x alone is shorter."""
    cache = tape.pull()
    stream = x if cache is None or x.shape[2] >= CACHE_T else torch.cat([cache.to(x.dtype), x], dim=2)
    tape.push(_tail(stream))
    return cconv3d(p, x, cache)


def residual_block(p: Dict, x: torch.Tensor, tape: CacheTape) -> torch.Tensor:
    h = cconv3d(p["shortcut"], x, None) if "shortcut" in p else x
    y = F.silu(rms_norm_ch(p["norm1"], x).float()).to(x.dtype)
    y = cconv3d_cached(p["conv1"], y, tape)
    y = F.silu(rms_norm_ch(p["norm2"], y).float()).to(x.dtype)
    y = cconv3d_cached(p["conv2"], y, tape)
    return y + h


def upsample3d_time(p: Dict, x: torch.Tensor, tape: CacheTape, first: bool) -> torch.Tensor:
    """Temporal 2x: the first chunk bypasses (a zero cache is recorded);
    later chunks run the causal time_conv and interleave the doubled
    channels into doubled time."""
    if first:
        tape.push(x.new_zeros((x.shape[0], x.shape[1], CACHE_T, *x.shape[3:])))
        return x
    cache = tape.pull()
    tape.push(_tail(torch.cat([cache.to(x.dtype), x], dim=2)))
    y = cconv3d(p["time_conv"], x, cache)  # (B, 2C, T, H, W)
    b, c2, t, h, w = y.shape
    c = c2 // 2
    return y.reshape(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, t * 2, h, w)


def downsample3d_time(p: Dict, x: torch.Tensor, tape: CacheTape, first: bool) -> torch.Tensor:
    """Temporal stride 2 for the encoder: the first chunk bypasses; later
    chunks run the time conv (no causal pad) over the previous chunk's last
    frame and this chunk. Each chunk's last frame is the next one's cache."""
    if first:
        tape.push(x[:, :, -1:].clone())
        return x
    cache = tape.pull()
    tape.push(x[:, :, -1:].clone())
    return cconv3d(p["time_conv"], torch.cat([cache.to(x.dtype), x], dim=2), None, t_stride=2, causal_pad=False)


def encoder_chunk(params: Dict, cfg: WanVAEConfig, x: torch.Tensor, tape: CacheTape, first: bool) -> torch.Tensor:
    """x: (B, 3, t, H, W) pixel frames -> (B, 2z, t', H/8, W/8)."""
    x = cconv3d_cached(params["conv1"], x, tape)
    for stage in params["down"]:
        for rb in stage["blocks"]:
            x = residual_block(rb, x, tape)
        if "resample" in stage:
            r = stage["resample"]
            x = conv2d_down(r["conv"], x)
            if r["mode"] == "downsample3d":
                x = downsample3d_time(r, x, tape, first)
    x = residual_block(params["mid_res1"], x, tape)
    x = spatial_attention(params["mid_attn"], x)
    x = residual_block(params["mid_res2"], x, tape)
    x = F.silu(rms_norm_ch(params["head_norm"], x).float()).to(x.dtype)
    return cconv3d_cached(params["head_conv"], x, tape)


def decoder_chunk(params: Dict, cfg: WanVAEConfig, x: torch.Tensor, tape: CacheTape, first: bool) -> torch.Tensor:
    """x: (B, z, k, h, w) latent frames -> (B, 3, 1 or 4k, 8h, 8w)."""
    x = cconv3d_cached(params["conv1"], x, tape)
    x = residual_block(params["mid_res1"], x, tape)
    x = spatial_attention(params["mid_attn"], x)
    x = residual_block(params["mid_res2"], x, tape)
    for stage in params["up"]:
        for rb in stage["blocks"]:
            x = residual_block(rb, x, tape)
        if "resample" in stage:
            r = stage["resample"]
            if r["mode"] == "upsample3d":
                x = upsample3d_time(r, x, tape, first)
            x = cconv3d(r["conv"], upsample_nearest2x(x), None)
    x = F.silu(rms_norm_ch(params["head_norm"], x).float()).to(x.dtype)
    return cconv3d_cached(params["head_conv"], x, tape)


def vae_decode(params: Dict, z: torch.Tensor, cfg: WanVAEConfig = WanVAEConfig(), scale: bool = True,
               dtype=torch.float32, chunk: int = 4) -> torch.Tensor:
    """z: (B, T, h, w, z_dim) normalized latents -> (B, (T-1)*4+1, 8h, 8w, 3)
    fp32. ``chunk`` latent frames decode per step (the largest divisor of
    T-1 that is <= chunk)."""
    if scale:
        mean = torch.tensor(WAN_LATENT_MEAN, dtype=torch.float32, device=z.device)
        std = torch.tensor(WAN_LATENT_STD, dtype=torch.float32, device=z.device)
        z = z.float() * std + mean
    z = z.to(dtype).permute(0, 4, 1, 2, 3)  # (B, C, T, h, w)
    z = cconv3d(params["conv2"], z, None)
    tape = CacheTape(None)
    outs = [decoder_chunk(params["decoder"], cfg, z[:, :, :1], tape, first=True)]
    cache = tape.new
    t1 = z.shape[2] - 1
    if t1 > 0:
        k = max(d for d in range(1, max(1, min(chunk, t1)) + 1) if t1 % d == 0)
        for i in range(t1 // k):
            tape = CacheTape(cache)
            outs.append(decoder_chunk(params["decoder"], cfg, z[:, :, 1 + i * k:1 + (i + 1) * k], tape, first=False))
            cache = tape.new
    return torch.cat(outs, dim=2).permute(0, 2, 3, 4, 1).float()


def vae_encode(params: Dict, x: torch.Tensor, cfg: WanVAEConfig = WanVAEConfig(), scale: bool = True,
               dtype=torch.float32, chunk: int = 4) -> torch.Tensor:
    """x: (B, T, H, W, 3) pixels, T = 4n + 1 -> (B, n + 1, H/8, W/8, z) mu
    fp32, normalized by the latent statistics when ``scale``. After the
    first frame, 4k pixel frames encode per step (k the largest divisor of
    n that is <= ``chunk``); the causal convs' windows are the same for
    any k."""
    t = x.shape[1]
    if (t - 1) % 4:
        raise ValueError(f"vae_encode takes 4n + 1 frames, got {t}")
    x = x.to(dtype).permute(0, 4, 1, 2, 3)  # (B, 3, T, H, W)
    tape = CacheTape(None)
    outs = [encoder_chunk(params["encoder"], cfg, x[:, :, :1], tape, first=True)]
    cache = tape.new
    n = (t - 1) // 4
    if n:
        k = max(d for d in range(1, min(chunk, n) + 1) if n % d == 0)
        for i in range(n // k):
            tape = CacheTape(cache)
            outs.append(encoder_chunk(params["encoder"], cfg, x[:, :, 1 + 4 * k * i:1 + 4 * k * (i + 1)], tape,
                                      first=False))
            cache = tape.new
    mu = cconv3d(params["conv1"], torch.cat(outs, dim=2), None)[:, :cfg.z_dim].float()
    if scale:
        mean = torch.tensor(WAN_LATENT_MEAN, dtype=torch.float32, device=mu.device).reshape(-1, 1, 1, 1)
        std = torch.tensor(WAN_LATENT_STD, dtype=torch.float32, device=mu.device).reshape(-1, 1, 1, 1)
        mu = (mu - mean) / std
    return mu.permute(0, 2, 3, 4, 1)


def _blend_h(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """Blend tile b's left edge with tile a's right edge along W (axis 3)."""
    e = min(a.shape[3], b.shape[3], extent)
    if e <= 0:
        return b
    w = (torch.arange(e, dtype=torch.float32, device=b.device) / e).reshape(1, 1, 1, e, 1)
    mixed = a[:, :, :, -e:].float() * (1 - w) + b[:, :, :, :e].float() * w
    return torch.cat([mixed.to(b.dtype), b[:, :, :, e:]], dim=3)


def _blend_v(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """Blend tile b's top edge with tile a's bottom edge along H (axis 2)."""
    e = min(a.shape[2], b.shape[2], extent)
    if e <= 0:
        return b
    w = (torch.arange(e, dtype=torch.float32, device=b.device) / e).reshape(1, 1, e, 1, 1)
    mixed = a[:, :, -e:].float() * (1 - w) + b[:, :, :e].float() * w
    return torch.cat([mixed.to(b.dtype), b[:, :, e:]], dim=2)


def vae_decode_tiled(params: Dict, z: torch.Tensor, cfg: WanVAEConfig = WanVAEConfig(), scale: bool = True,
                     dtype=torch.float32, tile_latent: int = 32, stride_latent: int = 24,
                     chunk: int = 4) -> torch.Tensor:
    """Tiled decode: 256 px tiles at a 192 px stride, overlaps blended by a
    linear ramp (later blends see already-blended neighbours, as in the
    reference). z: (B, T, h, w, C)."""
    b, t, h, w, c = z.shape
    blend = (tile_latent - stride_latent) * 8
    rows = []
    for i in range(0, h, stride_latent):
        rows.append([vae_decode(params, z[:, :, i:i + tile_latent, j:j + tile_latent], cfg, scale=scale,
                                dtype=dtype, chunk=chunk)
                     for j in range(0, w, stride_latent)])
    out_rows = []
    for i, row in enumerate(rows):
        merged = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_v(rows[i - 1][j], tile, blend)
            if j > 0:
                tile = _blend_h(row[j - 1], tile, blend)
            row[j] = tile
            merged.append(tile[:, :, :stride_latent * 8, :stride_latent * 8])
        out_rows.append(torch.cat(merged, dim=3))
    return torch.cat(out_rows, dim=2)[:, :, :h * 8, :w * 8]


def vae_encode_tiled(params: Dict, x: torch.Tensor, cfg: WanVAEConfig = WanVAEConfig(), scale: bool = True,
                     dtype=torch.float32, tile_px: int = 256, stride_px: int = 192) -> torch.Tensor:
    """Tiled encode: ``tile_px`` tiles at a ``stride_px`` stride, the
    latent overlaps blended by a linear ramp as in ``vae_decode_tiled``.
    x: (B, T, H, W, 3)."""
    b, t, h, w, _ = x.shape
    tl, sl = tile_px // 8, stride_px // 8
    rows = []
    for i in range(0, h, stride_px):
        rows.append([vae_encode(params, x[:, :, i:i + tile_px, j:j + tile_px], cfg, scale=scale, dtype=dtype)
                     for j in range(0, w, stride_px)])
    out_rows = []
    for i, row in enumerate(rows):
        merged = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_v(rows[i - 1][j], tile, tl - sl)
            if j > 0:
                tile = _blend_h(row[j - 1], tile, tl - sl)
            row[j] = tile
            merged.append(tile[:, :, :sl, :sl])
        out_rows.append(torch.cat(merged, dim=3))
    return torch.cat(out_rows, dim=2)[:, :, :h // 8, :w // 8]


# --------------------------------------------------------------------------
# weights


def _conv_p(sd, key, dtype, device) -> Dict:
    w = to_tensor(sd[f"{key}.weight"], dtype, device)
    if w.dim() == 4:  # (O, I, kh, kw) -> (O, I, 1, kh, kw)
        w = w[:, :, None]
    p = {"w": w.contiguous()}
    if f"{key}.bias" in sd:
        p["b"] = to_tensor(sd[f"{key}.bias"], dtype, device)
    return p


def _norm_p(sd, key, device) -> Dict:
    return {"g": to_tensor(sd[f"{key}.gamma"], torch.float32, device).reshape(-1)}


def _res_p(sd, key, has_shortcut, dtype, device) -> Dict:
    p = {
        "norm1": _norm_p(sd, f"{key}.residual.0", device),
        "conv1": _conv_p(sd, f"{key}.residual.2", dtype, device),
        "norm2": _norm_p(sd, f"{key}.residual.3", device),
        "conv2": _conv_p(sd, f"{key}.residual.6", dtype, device),
    }
    if has_shortcut:
        p["shortcut"] = _conv_p(sd, f"{key}.shortcut", dtype, device)
    return p


def _attn_p(sd, key, dtype, device) -> Dict:
    return {
        "norm": _norm_p(sd, f"{key}.norm", device),
        "to_qkv": _conv_p(sd, f"{key}.to_qkv", dtype, device),
        "proj": _conv_p(sd, f"{key}.proj", dtype, device),
    }


def _encoder_p(sd, cfg: WanVAEConfig, dtype, device) -> Dict:
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    stages, li = [], 0
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        blocks, d = [], din
        for _ in range(cfg.num_res_blocks):
            blocks.append(_res_p(sd, f"encoder.downsamples.{li}", d != dout, dtype, device))
            li += 1
            d = dout
        st: Dict[str, Any] = {"blocks": blocks}
        if i != len(cfg.dim_mult) - 1:
            mode = "downsample3d" if cfg.temperal_downsample[i] else "downsample2d"
            st["resample"] = {"mode": mode,
                              "conv": _conv_p(sd, f"encoder.downsamples.{li}.resample.1", dtype, device)}
            if mode == "downsample3d":
                st["resample"]["time_conv"] = _conv_p(sd, f"encoder.downsamples.{li}.time_conv", dtype, device)
            li += 1
        stages.append(st)
    return {
        "conv1": _conv_p(sd, "encoder.conv1", dtype, device),
        "down": stages,
        "mid_res1": _res_p(sd, "encoder.middle.0", False, dtype, device),
        "mid_attn": _attn_p(sd, "encoder.middle.1", dtype, device),
        "mid_res2": _res_p(sd, "encoder.middle.2", False, dtype, device),
        "head_norm": _norm_p(sd, "encoder.head.0", device),
        "head_conv": _conv_p(sd, "encoder.head.2", dtype, device),
    }


def load_wan_vae_params(state_dict: Dict[str, Any], cfg: WanVAEConfig = WanVAEConfig(), dtype=torch.float32,
                        device="cpu") -> Dict:
    """Reference-layout VAE state dict -> params: the encoder with its
    moments conv ``conv1``, the decoder with its post-quant ``conv2``."""
    sd = state_dict
    dims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    stages, li = [], 0
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        if i in (1, 2, 3):
            din = din // 2
        blocks, d = [], din
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_res_p(sd, f"decoder.upsamples.{li}", d != dout, dtype, device))
            li += 1
            d = dout
        st: Dict[str, Any] = {"blocks": blocks}
        if i != len(cfg.dim_mult) - 1:
            mode = "upsample3d" if cfg.temperal_upsample[i] else "upsample2d"
            st["resample"] = {"mode": mode, "conv": _conv_p(sd, f"decoder.upsamples.{li}.resample.1", dtype, device)}
            if mode == "upsample3d":
                st["resample"]["time_conv"] = _conv_p(sd, f"decoder.upsamples.{li}.time_conv", dtype, device)
            li += 1
        stages.append(st)
    return {
        "conv1": _conv_p(sd, "conv1", dtype, device),
        "conv2": _conv_p(sd, "conv2", dtype, device),
        "encoder": _encoder_p(sd, cfg, dtype, device),
        "decoder": {
            "conv1": _conv_p(sd, "decoder.conv1", dtype, device),
            "mid_res1": _res_p(sd, "decoder.middle.0", False, dtype, device),
            "mid_attn": _attn_p(sd, "decoder.middle.1", dtype, device),
            "mid_res2": _res_p(sd, "decoder.middle.2", False, dtype, device),
            "up": stages,
            "head_norm": _norm_p(sd, "decoder.head.0", device),
            "head_conv": _conv_p(sd, "decoder.head.2", dtype, device),
        },
    }


def init_random_vae_state_dict(cfg: WanVAEConfig, seed: int = 0, scale: float = 0.1) -> Dict[str, np.ndarray]:
    """Random state dict with the reference's keys (encoder and decoder);
    the same values as the JAX package's function of the same name."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv3(key, i, o, k=(3, 3, 3)):
        sd[f"{key}.weight"] = rng.standard_normal((o, i, *k), dtype=np.float32) * scale / np.sqrt(i * np.prod(k))
        sd[f"{key}.bias"] = rng.standard_normal(o).astype(np.float32) * 0.01

    def conv2(key, i, o, k=(3, 3)):
        sd[f"{key}.weight"] = rng.standard_normal((o, i, *k), dtype=np.float32) * scale / np.sqrt(i * np.prod(k))
        sd[f"{key}.bias"] = rng.standard_normal(o).astype(np.float32) * 0.01

    def norm(key, d):
        sd[f"{key}.gamma"] = np.ones((d, 1, 1, 1), np.float32)

    def res(key, i, o):
        norm(f"{key}.residual.0", i)
        conv3(f"{key}.residual.2", i, o)
        norm(f"{key}.residual.3", o)
        conv3(f"{key}.residual.6", o, o)
        if i != o:
            conv3(f"{key}.shortcut", i, o, k=(1, 1, 1))

    def attn(key, d):
        sd[f"{key}.norm.gamma"] = np.ones((d, 1, 1), np.float32)
        conv2(f"{key}.to_qkv", d, d * 3, k=(1, 1))
        conv2(f"{key}.proj", d, d, k=(1, 1))

    z2 = cfg.z_dim * 2
    conv3("conv1", z2, z2, k=(1, 1, 1))
    conv3("conv2", cfg.z_dim, cfg.z_dim, k=(1, 1, 1))

    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    conv3("encoder.conv1", 3, dims[0])
    li = 0
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        d = din
        for _ in range(cfg.num_res_blocks):
            res(f"encoder.downsamples.{li}", d, dout)
            li += 1
            d = dout
        if i != len(cfg.dim_mult) - 1:
            conv2(f"encoder.downsamples.{li}.resample.1", dout, dout)
            if cfg.temperal_downsample[i]:
                conv3(f"encoder.downsamples.{li}.time_conv", dout, dout, k=(3, 1, 1))
            li += 1
    res("encoder.middle.0", dims[-1], dims[-1])
    attn("encoder.middle.1", dims[-1])
    res("encoder.middle.2", dims[-1], dims[-1])
    norm("encoder.head.0", dims[-1])
    conv3("encoder.head.2", dims[-1], z2)

    ddims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    conv3("decoder.conv1", cfg.z_dim, ddims[0])
    res("decoder.middle.0", ddims[0], ddims[0])
    attn("decoder.middle.1", ddims[0])
    res("decoder.middle.2", ddims[0], ddims[0])
    li = 0
    for i, (din, dout) in enumerate(zip(ddims[:-1], ddims[1:])):
        if i in (1, 2, 3):
            din = din // 2
        d = din
        for _ in range(cfg.num_res_blocks + 1):
            res(f"decoder.upsamples.{li}", d, dout)
            li += 1
            d = dout
        if i != len(cfg.dim_mult) - 1:
            conv2(f"decoder.upsamples.{li}.resample.1", dout, dout // 2)
            if cfg.temperal_upsample[i]:
                conv3(f"decoder.upsamples.{li}.time_conv", dout, dout * 2, k=(3, 1, 1))
            li += 1
    norm("decoder.head.0", ddims[-1])
    conv3("decoder.head.2", ddims[-1], 3)
    return sd
