"""CogVideoX causal 3D VAE decoder in PyTorch (counterpart of the decoder in
``lightx2v_tpu.vae.cogvideox_vae``): block channels (128, 256, 256, 512)
reversed, 4 resnets a decoder block, 16 latent channels, SpatialNorm3D
(GroupNorm modulated by 1x1x1 convs of the latents zq, nearest-resized to
each feature map), "first"-pad causal convs (the temporal left pad repeats
the first frame, or comes from the previous chunk's cache), nearest
upsampling that keeps the first frame apart at odd T.

Public functions keep the JAX layout: latents (B, T, h, w, z), pixels
(B, T, H, W, 3). Inside, activations are channels-first (B, C, T, H, W) for
``F.conv3d`` (the JAX package has no Pallas kernel here); the 2D upsample
conv runs as a conv3d with a temporal kernel of 1. The VAE runs in fp32; on
CUDA the caller chooses TF32 for the convolutions
(``torch.backends.cudnn.allow_tf32``).

The nearest resize is pinned to ``jax.image.resize(..., "nearest")``, which
samples at half-pixel centres, floor((i + 0.5) * m / n) in fp32;
``F.interpolate(mode="nearest")`` samples at floor(i * m / n), and the two
agree only at integer factors. The decoder's own resizes are integer
factors, but nothing here relies on it. The encoder is not ported (the t2v
path never encodes)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.wan.weights import to_tensor

Params = Dict[str, Any]

COGVIDEOX_SCALING = 0.7
FRAME_BATCH = 2  # latent frames a decode chunk (the reference's num_latent_frames_batch_size)


@dataclass(frozen=True)
class CogVAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_num_groups: int = 32
    temporal_compress_level: int = 2  # log2(temporal_compression_ratio)


# ---------------------------------------------------------------- primitives (channels-first)


class ConvCacheCtx:
    """The conv caches of a chunked decode, by execution order: the
    temporal left pad of chunk i + 1 is the last kt - 1 frames that chunk i
    fed the same conv (the decoder's conv sequence is fixed, so index j is
    always the same conv). ``old`` None: the first chunk, first-frame pad."""

    def __init__(self, caches: Optional[List[torch.Tensor]] = None):
        self.old = caches
        self.new: List[torch.Tensor] = []
        self.i = 0

    def pad(self, x: torch.Tensor, kt: int) -> torch.Tensor:
        if self.old is not None:
            xp = torch.cat([self.old[self.i].to(x.dtype), x], dim=2)
        else:
            xp = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], dim=2)
        self.i += 1
        self.new.append(xp[:, :, -(kt - 1):].clone())  # a copy: a view would keep xp alive
        return xp


def causal_conv3d(p: Params, x: torch.Tensor, ctx: Optional[ConvCacheCtx] = None) -> torch.Tensor:
    """'first'-pad causal conv, weight (O, I, kt, kh, kw): the temporal left
    pad repeats the first frame, or with ``ctx`` comes from the previous
    chunk's cache; spatial padding (k - 1) // 2."""
    w = p["w"]
    kt, kh, kw = w.shape[2:]
    if kt > 1:
        x = ctx.pad(x, kt) if ctx is not None else torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], dim=2)
    return F.conv3d(x, w.to(x.dtype), p.get("b"), padding=(0, (kh - 1) // 2, (kw - 1) // 2))


def group_norm(p: Params, x: torch.Tensor, groups: int, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm with fp32 statistics over (C/groups, T, H, W)."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return (xf * p["w"].float().reshape(shape) + p["b"].float().reshape(shape)).to(x.dtype)


def _nearest_index(m: int, n: int) -> np.ndarray:
    """The source index of each of n outputs resized from m, as
    ``jax.image.resize(..., "nearest")`` takes it: floor((i + 0.5) * m / n)
    in fp32 (half-pixel centres)."""
    return np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m) / np.float32(n)).astype(np.int64)


def _resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize of the (T, H, W) axes of (B, C, T, H, W) to ``size``."""
    for axis, n in zip((2, 3, 4), size):
        m = x.shape[axis]
        if m != n:
            x = x.index_select(axis, torch.from_numpy(_nearest_index(m, n)).to(x.device))
    return x


def _resize_zq(zq: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """The latents resized to a feature map's (t, h, w); at odd t > 1 the
    first frame is resized alone and the rest to t - 1 frames."""
    if t > 1 and t % 2 == 1:
        return torch.cat([_resize_nearest(zq[:, :, :1], (1, h, w)), _resize_nearest(zq[:, :, 1:], (t - 1, h, w))],
                         dim=2)
    return _resize_nearest(zq, (t, h, w))


def spatial_norm(p: Params, f: torch.Tensor, zq: torch.Tensor, groups: int,
                 ctx: Optional[ConvCacheCtx] = None) -> torch.Tensor:
    """GroupNorm(f) * conv_y(zq) + conv_b(zq)."""
    z = _resize_zq(zq, *f.shape[2:])
    y = causal_conv3d(p["conv_y"], z, ctx)
    bb = causal_conv3d(p["conv_b"], z, ctx)
    return group_norm(p["norm"], f, groups) * y + bb


def resnet_block(p: Params, x: torch.Tensor, groups: int, zq: torch.Tensor,
                 ctx: Optional[ConvCacheCtx] = None) -> torch.Tensor:
    h = F.silu(spatial_norm(p["norm1"], x, zq, groups, ctx).float()).to(x.dtype)
    h = causal_conv3d(p["conv1"], h, ctx)
    h = F.silu(spatial_norm(p["norm2"], h, zq, groups, ctx).float()).to(x.dtype)
    h = causal_conv3d(p["conv2"], h, ctx)
    if "shortcut" in p:
        x = causal_conv3d(p["shortcut"], x, ctx)  # 1x1x1
    return x + h


def upsample3d(p: Params, x: torch.Tensor, compress_time: bool) -> torch.Tensor:
    """Nearest 2x upsampling (with ``compress_time`` also 2x in time, the
    first frame kept single at odd T > 1), then a 3x3 conv per frame."""
    up_hw = lambda v: v.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)  # noqa: E731
    t = x.shape[2]
    if compress_time and t > 1 and t % 2 == 1:
        x = torch.cat([up_hw(x[:, :, :1]), up_hw(x[:, :, 1:].repeat_interleave(2, dim=2))], dim=2)
    elif compress_time and t > 1:
        x = up_hw(x.repeat_interleave(2, dim=2))
    else:
        x = up_hw(x)
    return F.conv3d(x, p["w"].to(x.dtype), p.get("b"), padding=(0, 1, 1))


# ---------------------------------------------------------------- decode


def cog_vae_decode(params: Params, z: torch.Tensor, cfg: CogVAEConfig = CogVAEConfig(), scale: bool = True,
                   ctx: Optional[ConvCacheCtx] = None) -> torch.Tensor:
    """Latents (B, T, h, w, z) -> pixels (B, T', 8h, 8w, 3) fp32."""
    g = cfg.norm_num_groups
    if scale:
        z = z / COGVIDEOX_SCALING
    zq = z.float().permute(0, 4, 1, 2, 3)
    dec = params["decoder"]
    h = causal_conv3d(dec["conv_in"], zq, ctx)
    for rb in dec["mid"]:
        h = resnet_block(rb, h, g, zq, ctx)
    for i, stage in enumerate(dec["up"]):
        for rb in stage["resnets"]:
            h = resnet_block(rb, h, g, zq, ctx)
        if "upsample" in stage:
            h = upsample3d(stage["upsample"], h, compress_time=i < cfg.temporal_compress_level)
    h = F.silu(spatial_norm(dec["norm_out"], h, zq, g, ctx).float())
    return causal_conv3d(dec["conv_out"], h, ctx).permute(0, 2, 3, 4, 1)


def cog_vae_decode_chunked(params: Params, z: torch.Tensor, cfg: CogVAEConfig = CogVAEConfig(),
                           scale: bool = True) -> torch.Tensor:
    """Frame-batched decode: chunk i > 0 covers latent frames
    [fb*i + rem, fb*(i+1) + rem) with fb = ``FRAME_BATCH``, so the first
    chunk takes the remainder (21 latent frames -> [3, 2, 2, ...]); each
    causal conv's left pad comes from the previous chunk's cache. Peak
    memory is one chunk's activations."""
    t, fb = z.shape[1], FRAME_BATCH
    nb = max(t // fb, 1)
    rem = t % fb
    out, caches = [], None
    for i in range(nb):
        start = fb * i + (0 if i == 0 else rem)
        end = min(fb * (i + 1) + rem, t)
        ctx = ConvCacheCtx(caches)
        out.append(cog_vae_decode(params, z[:, start:end], cfg, scale=scale, ctx=ctx))
        caches = ctx.new
    return torch.cat(out, dim=1)


def _blend_dim(a: torch.Tensor, b: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Linear-ramp blend of b's leading ``n`` slices with a's trailing ``n``
    along ``axis`` (a copy of the JAX package's ``hunyuan_vae._blend_dim``)."""
    n = min(a.shape[axis], b.shape[axis], n)
    if n <= 0:
        return b
    shape = [1] * b.dim()
    shape[axis] = n
    w = (torch.arange(n, dtype=torch.float32, device=b.device) / n).reshape(shape)
    a_t = a.narrow(axis, a.shape[axis] - n, n).float()
    b_h = b.narrow(axis, 0, n).float()
    mixed = (a_t * (1 - w) + b_h * w).to(b.dtype)
    return torch.cat([mixed, b.narrow(axis, n, b.shape[axis] - n)], dim=axis)


def cog_vae_decode_tiled(params: Params, z: torch.Tensor, cfg: CogVAEConfig = CogVAEConfig(), scale: bool = True,
                         tile_latent: int = 32) -> torch.Tensor:
    """Spatially tiled decode: latent tiles of ``tile_latent`` overlapping
    by a quarter, each with its own zq slice, frame-batched through
    ``cog_vae_decode_chunked``, blended with linear ramps in pixel space,
    each blended tile replacing its original before the next blend (the
    reference's cascade)."""
    b, t, h, w, c = z.shape
    dec = lambda z_: cog_vae_decode_chunked(params, z_, cfg, scale=scale)  # noqa: E731
    if max(h, w) <= tile_latent:
        return dec(z)
    step = max(1, int(tile_latent * 0.75))
    up = 2 ** (len(cfg.block_out_channels) - 1)
    blend = (tile_latent - step) * up
    limit = step * up
    rows = [[dec(z[:, :, i:i + tile_latent, j:j + tile_latent]) for j in range(0, w, step)]
            for i in range(0, h, step)]
    out_rows = []
    for i, row in enumerate(rows):
        merged = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_dim(rows[i - 1][j], tile, blend, axis=2)
            if j > 0:
                tile = _blend_dim(row[j - 1], tile, blend, axis=3)
            row[j] = tile
            merged.append(tile[:, :, :limit, :limit])
        out_rows.append(torch.cat(merged, dim=3))
    out = torch.cat(out_rows, dim=2)
    return out[:, :, :h * up, :w * up]


# ---------------------------------------------------------------- weights


def load_cog_vae_params(sd: Dict[str, Any], cfg: CogVAEConfig = CogVAEConfig(), device="cpu") -> Params:
    """The decoder's params (fp32, torch conv layouts; the 2D upsample convs
    as (O, I, 1, 3, 3)) from a state dict with the diffusers keys."""
    rev = list(reversed(cfg.block_out_channels))

    def conv(key, two_d=False):
        w = to_tensor(sd[f"{key}.weight"], torch.float32, device)
        p = {"w": (w[:, :, None] if two_d else w).contiguous()}
        if f"{key}.bias" in sd:
            p["b"] = to_tensor(sd[f"{key}.bias"], torch.float32, device)
        return p

    def norm(key):
        return {"w": to_tensor(sd[f"{key}.weight"], torch.float32, device),
                "b": to_tensor(sd[f"{key}.bias"], torch.float32, device)}

    def spat_norm(prefix):
        return {"norm": norm(f"{prefix}.norm_layer"), "conv_y": conv(f"{prefix}.conv_y.conv"),
                "conv_b": conv(f"{prefix}.conv_b.conv")}

    def resnet(prefix, cin, cout):
        p = {"norm1": spat_norm(f"{prefix}.norm1"), "conv1": conv(f"{prefix}.conv1.conv"),
             "norm2": spat_norm(f"{prefix}.norm2"), "conv2": conv(f"{prefix}.conv2.conv")}
        if cin != cout:
            p["shortcut"] = conv(f"{prefix}.conv_shortcut")
        return p

    dec = {
        "conv_in": conv("decoder.conv_in.conv"),
        "mid": [resnet(f"decoder.mid_block.resnets.{j}", rev[0], rev[0]) for j in range(2)],
        "up": [],
        "norm_out": spat_norm("decoder.norm_out"),
        "conv_out": conv("decoder.conv_out.conv"),
    }
    for i in range(len(rev)):
        cin = rev[0] if i == 0 else rev[i - 1]
        st = {"resnets": [resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else rev[i], rev[i])
                          for j in range(cfg.layers_per_block + 1)]}
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            st["upsample"] = conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", two_d=True)
        dec["up"].append(st)
    return {"decoder": dec}


def init_random_cog_vae_state_dict(cfg: CogVAEConfig, seed: int = 0, scale: float = 0.1) -> Dict[str, np.ndarray]:
    """Random encoder + decoder state dict with the diffusers keys; the same
    values as the JAX package's function of the same name for the same seed
    (the encoder is drawn first, so it is drawn here too)."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv3(key, i, o, k=3):
        fan = i * k ** 3
        sd[f"{key}.weight"] = rng.standard_normal((o, i, k, k, k), dtype=np.float32) * scale / np.sqrt(fan)
        sd[f"{key}.bias"] = np.zeros(o, np.float32)

    def conv2(key, i, o, k=3):
        sd[f"{key}.weight"] = rng.standard_normal((o, i, k, k), dtype=np.float32) * scale / np.sqrt(i * k * k)
        sd[f"{key}.bias"] = np.zeros(o, np.float32)

    def norm(key, c):
        sd[f"{key}.weight"] = np.ones(c, np.float32)
        sd[f"{key}.bias"] = np.zeros(c, np.float32)

    z = cfg.latent_channels

    def spat(key, c):
        norm(f"{key}.norm_layer", c)
        conv3(f"{key}.conv_y.conv", z, c, k=1)
        conv3(f"{key}.conv_b.conv", z, c, k=1)

    def resnet(prefix, cin, cout, spatial):
        if spatial:
            spat(f"{prefix}.norm1", cin)
            spat(f"{prefix}.norm2", cout)
        else:
            norm(f"{prefix}.norm1", cin)
            norm(f"{prefix}.norm2", cout)
        conv3(f"{prefix}.conv1.conv", cin, cout)
        conv3(f"{prefix}.conv2.conv", cout, cout)
        if cin != cout:
            conv3(f"{prefix}.conv_shortcut", cin, cout, k=1)

    boc = cfg.block_out_channels
    rev = list(reversed(boc))
    conv3("encoder.conv_in.conv", cfg.in_channels, boc[0])
    for i in range(len(boc)):
        cin = boc[0] if i == 0 else boc[i - 1]
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else boc[i], boc[i], False)
        if i != len(boc) - 1:
            conv2(f"encoder.down_blocks.{i}.downsamplers.0.conv", boc[i], boc[i])
    for j in range(2):
        resnet(f"encoder.mid_block.resnets.{j}", boc[-1], boc[-1], False)
    norm("encoder.norm_out", boc[-1])
    conv3("encoder.conv_out.conv", boc[-1], 2 * z)

    conv3("decoder.conv_in.conv", z, rev[0])
    for j in range(2):
        resnet(f"decoder.mid_block.resnets.{j}", rev[0], rev[0], True)
    for i in range(len(rev)):
        cin = rev[0] if i == 0 else rev[i - 1]
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else rev[i], rev[i], True)
        if i != len(rev) - 1:
            conv2(f"decoder.up_blocks.{i}.upsamplers.0.conv", rev[i], rev[i])
    spat("decoder.norm_out", rev[-1])
    conv3("decoder.conv_out.conv", rev[-1], cfg.in_channels)
    return sd
