"""HunyuanVideo causal 3D VAE in PyTorch (counterpart of
``lightx2v_tpu.vae.hunyuan_vae``, the diffusers-style AutoencoderKLCausal3D
"884-16c"): the encoder (block channels (128, 256, 512, 512), 2 resnets a
block, strided causal convs downsampling 2x in space at the first three
stages and 2x in time at the second and third) and the decoder (the
channels reversed, 3 resnets a block), 16 latent channels, GroupNorm(32) +
SiLU, causal convs with replicate padding (kt - 1 frames on the left, k // 2
on each spatial side), a frame-causal single-head attention (512 wide) in
the mid block, nearest upsampling where the first frame upsamples in space
only (T latent frames -> 4(T - 1) + 1 frames).

Public functions keep the JAX layout: latents (B, T, h, w, 16), pixels
(B, T', H, W, 3). Inside, activations are channels-first (B, C, T, H, W) for
``F.conv3d`` (the JAX package has no Pallas kernel here). The VAE runs in
fp32; on CUDA the caller chooses TF32 for the convolutions
(``torch.backends.cudnn.allow_tf32``). The mid-block attention is plain
torch, as in the JAX package: quadratic in a tile's tokens, which is why
long or large clips go through the tiled decodes. The encoder's posterior
sample takes its noise from an explicit ``torch.Generator`` or injected
noise (the JAX package draws it from a ``jax.random`` key)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.wan.weights import to_tensor
from ..utils.safetensors_io import read_state_dict
from .cogvideox_vae import _blend_dim, group_norm

Params = Dict[str, Any]

HUNYUAN_LATENT_SCALING = 0.476986
OVERLAP = 0.25  # of a tile, in both tilings


@dataclass(frozen=True)
class HunyuanVAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    time_compression_ratio: int = 4
    spatial_compression_ratio: int = 8

    def up_scales(self):
        """Per-stage (t, h, w) decoder upsample factor, or None; the
        encoder's per-stage downsample strides are the same."""
        n = len(self.block_out_channels)
        nspat = int(np.log2(self.spatial_compression_ratio))
        ntime = int(np.log2(self.time_compression_ratio))
        out = []
        for i in range(n):
            sp = i < nspat
            tm = i >= n - 1 - ntime and i != n - 1
            out.append((2 if tm else 1, 2 if sp else 1, 2 if sp else 1) if (sp or tm) else None)
        return out


# ---------------------------------------------------------------- primitives (channels-first)


def causal_conv3d(p: Params, x: torch.Tensor, stride=(1, 1, 1)) -> torch.Tensor:
    """Causal conv, weight (O, I, kt, kh, kw): replicate padding of kt - 1
    frames on the left and k // 2 on each spatial side, then a conv with no
    padding (``stride``: the encoder's downsampling convs)."""
    w = p["w"]
    kt, kh, kw = w.shape[2:]
    if kt > 1 or kh > 1 or kw > 1:
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0), mode="replicate")
    return F.conv3d(x, w.to(x.dtype), p.get("b"), stride=stride)


def resnet_block(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    h = F.silu(group_norm(p["norm1"], x, groups).float()).to(x.dtype)
    h = causal_conv3d(p["conv1"], h)
    h = F.silu(group_norm(p["norm2"], h, groups).float()).to(x.dtype)
    h = causal_conv3d(p["conv2"], h)
    return (causal_conv3d(p["shortcut"], x) if "shortcut" in p else x) + h


def causal_frame_attention(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    """Single-head attention over the (T, H, W) tokens of a mid block, each
    token attending its own frame and the frames before it."""
    b, c, t, h, w = x.shape
    flat = group_norm(p["group_norm"], x, groups).reshape(b, c, t * h * w).transpose(1, 2)

    def lin(pp, v):
        return (torch.matmul(v.float(), pp["w"].float().t()) + pp["b"].float()).to(v.dtype)

    q, k, v = lin(p["to_q"], flat), lin(p["to_k"], flat), lin(p["to_v"], flat)
    del flat
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / np.sqrt(c)
    frame = torch.arange(t * h * w, device=x.device) // (h * w)
    logits = logits.masked_fill_(~(frame[:, None] >= frame[None, :]), float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    del logits
    out = lin(p["to_out"], torch.matmul(probs, v))
    return x + out.transpose(1, 2).reshape(b, c, t, h, w)


def upsample_causal(x: torch.Tensor, scale: Tuple[int, int, int]) -> torch.Tensor:
    """Nearest upsampling; the first frame is upsampled in space only."""
    st, sh, sw = scale
    first, rest = x[:, :, :1], x[:, :, 1:]
    if sh > 1:
        first = first.repeat_interleave(sh, dim=3).repeat_interleave(sw, dim=4)
        rest = rest.repeat_interleave(sh, dim=3).repeat_interleave(sw, dim=4)
    if rest.shape[2] == 0:
        return first
    if st > 1:
        rest = rest.repeat_interleave(st, dim=2)
    return torch.cat([first, rest], dim=2)


# ---------------------------------------------------------------- encode / decode


def hunyuan_vae_encode(params: Params, x: torch.Tensor, cfg: HunyuanVAEConfig = HunyuanVAEConfig(),
                       scale: bool = True, generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixels x (B, T, H, W, 3) -> latents (B, (T - 1) / 4 + 1, H / 8, W / 8,
    16) fp32: the posterior mean, or with ``noise`` (the latents' shape) or a
    ``generator`` a sample mean + exp(logvar / 2) * noise (logvar clipped to
    [-30, 20]); scaled by ``HUNYUAN_LATENT_SCALING`` with ``scale``."""
    g = cfg.norm_num_groups
    enc = params["encoder"]
    h = causal_conv3d(enc["conv_in"], x.float().permute(0, 4, 1, 2, 3))
    for stage, stride in zip(enc["down"], cfg.up_scales()):  # the encoder strides by the decoder's factors
        for rb in stage["resnets"]:
            h = resnet_block(rb, h, g)
        if stride is not None:
            h = causal_conv3d(stage["downsample"], h, stride=stride)
    h = resnet_block(enc["mid"]["resnet1"], h, g)
    h = causal_frame_attention(enc["mid"]["attn"], h, g)
    h = resnet_block(enc["mid"]["resnet2"], h, g)
    h = F.silu(group_norm(enc["norm_out"], h, g).float())
    h = causal_conv3d(params["quant_conv"], causal_conv3d(enc["conv_out"], h))
    mu, logvar = h.permute(0, 2, 3, 4, 1).chunk(2, dim=-1)
    if noise is None and generator is not None:
        noise = torch.randn(mu.shape, generator=generator, dtype=torch.float32, device=generator.device)
    if noise is not None:
        mu = mu + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * noise.to(mu.device, torch.float32)
    return mu * HUNYUAN_LATENT_SCALING if scale else mu.contiguous()


def hunyuan_vae_decode(params: Params, z: torch.Tensor, cfg: HunyuanVAEConfig = HunyuanVAEConfig(),
                       scale: bool = True) -> torch.Tensor:
    """z (B, t, h, w, 16) -> frames (B, 4(t - 1) + 1, 8h, 8w, 3) fp32."""
    g = cfg.norm_num_groups
    if scale:
        z = z / HUNYUAN_LATENT_SCALING
    dec = params["decoder"]
    h = causal_conv3d(params["post_quant_conv"], z.float().permute(0, 4, 1, 2, 3))
    h = causal_conv3d(dec["conv_in"], h)
    h = resnet_block(dec["mid"]["resnet1"], h, g)
    h = causal_frame_attention(dec["mid"]["attn"], h, g)
    h = resnet_block(dec["mid"]["resnet2"], h, g)
    for stage, sc in zip(dec["up"], cfg.up_scales()):
        for rb in stage["resnets"]:
            h = resnet_block(rb, h, g)
        if sc is not None:
            h = causal_conv3d(stage["upsample"], upsample_causal(h, sc))
    h = F.silu(group_norm(dec["norm_out"], h, g).float())
    return causal_conv3d(dec["conv_out"], h).permute(0, 2, 3, 4, 1)


# The reference's tiling: spatial tiles of 32 latents and temporal tiles of
# 16 latent frames, both overlapping by a quarter and blended with linear
# ramps; each blended tile replaces its original before the next blend (the
# reference blends in place, so later blends see blended neighbours). A
# temporal tile past the first carries one extra leading latent frame whose
# output frame is dropped before blending.


def hunyuan_vae_decode_spatial_tiled(params: Params, z: torch.Tensor, cfg: HunyuanVAEConfig = HunyuanVAEConfig(),
                                     scale: bool = True, tile_latent: int = 32) -> torch.Tensor:
    """Spatially tiled decode of z (B, t, h, w, 16)."""
    h, w = z.shape[2:4]
    step = max(1, int(tile_latent * (1 - OVERLAP)))
    blend, limit = (tile_latent - step) * 8, step * 8
    rows = [[hunyuan_vae_decode(params, z[:, :, i:i + tile_latent, j:j + tile_latent], cfg, scale=scale)
             for j in range(0, w, step)] for i in range(0, h, step)]
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
    return torch.cat(out_rows, dim=2)[:, :, :h * 8, :w * 8]


def hunyuan_vae_decode_tiled(params: Params, z: torch.Tensor, cfg: HunyuanVAEConfig = HunyuanVAEConfig(),
                             scale: bool = True, t_tile_latent: int = 16,
                             spatial_tile_latent: int = 32) -> torch.Tensor:
    """Temporal tiles (outer), each spatially tiled when the latents are
    wider or taller than ``spatial_tile_latent``."""
    t, h, w = z.shape[1:4]

    def dec(tile):
        if max(h, w) > spatial_tile_latent:
            return hunyuan_vae_decode_spatial_tiled(params, tile, cfg, scale=scale, tile_latent=spatial_tile_latent)
        return hunyuan_vae_decode(params, tile, cfg, scale=scale)

    if t <= t_tile_latent:
        return dec(z)
    step = max(1, int(t_tile_latent * (1 - OVERLAP)))
    blend, limit = t_tile_latent * 4 - 4 * step, 4 * step
    row = []
    for i in range(0, t, step):
        tile = z[:, i:i + t_tile_latent + 1]
        if i > 0 and tile.shape[1] <= 1:
            break  # only the dropped leading latent is left
        d = dec(tile)
        row.append(d[:, 1:] if i > 0 else d)
    merged = [row[0][:, :limit + 1]]
    for i in range(1, len(row)):
        row[i] = _blend_dim(row[i - 1], row[i], blend, axis=1)
        merged.append(row[i][:, :limit])
    return torch.cat(merged, dim=1)


# ---------------------------------------------------------------- weights


def load_hunyuan_vae_params(sd: Dict[str, Any], cfg: HunyuanVAEConfig = HunyuanVAEConfig(), device="cpu",
                            encoder: bool = False) -> Params:
    """The decoder's params (fp32, torch conv layouts) and
    ``post_quant_conv`` from a state dict with the diffusers keys; with
    ``encoder`` also the encoder's and ``quant_conv``."""

    def conv(key):
        p = {"w": to_tensor(sd[f"{key}.weight"], torch.float32, device).contiguous()}
        if f"{key}.bias" in sd:
            p["b"] = to_tensor(sd[f"{key}.bias"], torch.float32, device)
        return p

    def affine(key):  # a norm or a linear: weight and bias
        return {"w": to_tensor(sd[f"{key}.weight"], torch.float32, device).contiguous(),
                "b": to_tensor(sd[f"{key}.bias"], torch.float32, device)}

    def resnet(prefix, has_shortcut):
        p = {"norm1": affine(f"{prefix}.norm1"), "conv1": conv(f"{prefix}.conv1.conv"),
             "norm2": affine(f"{prefix}.norm2"), "conv2": conv(f"{prefix}.conv2.conv")}
        if has_shortcut:
            p["shortcut"] = conv(f"{prefix}.conv_shortcut.conv")
        return p

    def attn(prefix):
        return {"group_norm": affine(f"{prefix}.group_norm"), "to_q": affine(f"{prefix}.to_q"),
                "to_k": affine(f"{prefix}.to_k"), "to_v": affine(f"{prefix}.to_v"),
                "to_out": affine(f"{prefix}.to_out.0")}

    rev = list(reversed(cfg.block_out_channels))

    def up_stage(i):
        cin = rev[0] if i == 0 else rev[i - 1]
        st = {"resnets": [resnet(f"decoder.up_blocks.{i}.resnets.{j}", j == 0 and cin != rev[i])
                          for j in range(cfg.layers_per_block + 1)]}
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.conv.weight" in sd:
            st["upsample"] = conv(f"decoder.up_blocks.{i}.upsamplers.0.conv.conv")
        return st

    boc = cfg.block_out_channels

    def down_stage(i):
        cin = boc[0] if i == 0 else boc[i - 1]
        st = {"resnets": [resnet(f"encoder.down_blocks.{i}.resnets.{j}", j == 0 and cin != boc[i])
                          for j in range(cfg.layers_per_block)]}
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.conv.weight" in sd:
            st["downsample"] = conv(f"encoder.down_blocks.{i}.downsamplers.0.conv.conv")
        return st

    params = {} if not encoder else {
        "quant_conv": conv("quant_conv"),
        "encoder": {
            "conv_in": conv("encoder.conv_in.conv"),
            "down": [down_stage(i) for i in range(len(boc))],
            "mid": {"resnet1": resnet("encoder.mid_block.resnets.0", False),
                    "attn": attn("encoder.mid_block.attentions.0"),
                    "resnet2": resnet("encoder.mid_block.resnets.1", False)},
            "norm_out": affine("encoder.conv_norm_out"),
            "conv_out": conv("encoder.conv_out.conv"),
        },
    }
    return {
        **params,
        "post_quant_conv": conv("post_quant_conv"),
        "decoder": {
            "conv_in": conv("decoder.conv_in.conv"),
            "mid": {"resnet1": resnet("decoder.mid_block.resnets.0", False),
                    "attn": attn("decoder.mid_block.attentions.0"),
                    "resnet2": resnet("decoder.mid_block.resnets.1", False)},
            "up": [up_stage(i) for i in range(len(rev))],
            "norm_out": affine("decoder.conv_norm_out"),
            "conv_out": conv("decoder.conv_out.conv"),
        },
    }


def load_hunyuan_vae_from_path(path: str, cfg: HunyuanVAEConfig = HunyuanVAEConfig(), device="cpu",
                               encoder: bool = False) -> Params:
    """The reference's ``vae/pytorch_model.pt`` (a state dict, or one under
    ``"state_dict"``, keys optionally prefixed ``vae.``) or a
    ``.safetensors`` -> decoder params (and with ``encoder`` the encoder's)
    on ``device``."""
    raw = read_state_dict(path)
    if "state_dict" in raw:
        raw = raw["state_dict"]
    sd = {k[len("vae."):] if k.startswith("vae.") else k: v for k, v in raw.items()}
    return load_hunyuan_vae_params(sd, cfg, device=device, encoder=encoder)


def init_random_hunyuan_vae_state_dict(cfg: HunyuanVAEConfig, seed: int = 0,
                                       scale: float = 0.1) -> Dict[str, np.ndarray]:
    """Random encoder + decoder state dict with the diffusers keys; the same
    values as the JAX package's function of the same name for the same seed
    (the encoder is drawn first, so it is drawn here too)."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv(key, i, o, k=3):
        sd[f"{key}.weight"] = rng.standard_normal((o, i, k, k, k), dtype=np.float32) * scale / np.sqrt(i * k ** 3)
        sd[f"{key}.bias"] = np.zeros(o, np.float32)

    def norm(key, c):
        sd[f"{key}.weight"] = np.ones(c, np.float32)
        sd[f"{key}.bias"] = np.zeros(c, np.float32)

    def lin(key, i, o):
        sd[f"{key}.weight"] = rng.standard_normal((o, i), dtype=np.float32) * scale / np.sqrt(i)
        sd[f"{key}.bias"] = np.zeros(o, np.float32)

    def resnet(prefix, cin, cout):
        norm(f"{prefix}.norm1", cin)
        conv(f"{prefix}.conv1.conv", cin, cout)
        norm(f"{prefix}.norm2", cout)
        conv(f"{prefix}.conv2.conv", cout, cout)
        if cin != cout:
            conv(f"{prefix}.conv_shortcut.conv", cin, cout, k=1)

    def attn(prefix, c):
        norm(f"{prefix}.group_norm", c)
        for m in ("to_q", "to_k", "to_v", "to_out.0"):
            lin(f"{prefix}.{m}", c, c)

    boc = cfg.block_out_channels
    z2 = cfg.latent_channels * 2
    conv("quant_conv", z2, z2, k=1)
    conv("post_quant_conv", cfg.latent_channels, cfg.latent_channels, k=1)
    conv("encoder.conv_in.conv", cfg.in_channels, boc[0])
    for i in range(len(boc)):
        cin = boc[0] if i == 0 else boc[i - 1]
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else boc[i], boc[i])
        if cfg.up_scales()[i] is not None:  # the encoder's stride at stage i
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv.conv", boc[i], boc[i])
    for j in range(2):
        resnet(f"encoder.mid_block.resnets.{j}", boc[-1], boc[-1])
    attn("encoder.mid_block.attentions.0", boc[-1])
    norm("encoder.conv_norm_out", boc[-1])
    conv("encoder.conv_out.conv", boc[-1], z2)

    rev = list(reversed(boc))
    conv("decoder.conv_in.conv", cfg.latent_channels, rev[0])
    for j in range(2):
        resnet(f"decoder.mid_block.resnets.{j}", rev[0], rev[0])
    attn("decoder.mid_block.attentions.0", rev[0])
    for i in range(len(rev)):
        cin = rev[0] if i == 0 else rev[i - 1]
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else rev[i], rev[i])
        if cfg.up_scales()[i] is not None:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv.conv", rev[i], rev[i])
    norm("decoder.conv_norm_out", boc[0])
    conv("decoder.conv_out.conv", boc[0], cfg.in_channels)
    return sd
