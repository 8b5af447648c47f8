"""The tiny VAE (TAEHV / taew2_1) in PyTorch (counterpart of
``lightx2v_tpu.vae.tiny_vae``): a fast approximate decoder (and encoder) of
Wan latents.

Public functions keep the JAX layout: latents (N, T, H, W, 16), frames
(N, T', 8H, 8W, 3). Inside, frames are batched channels-first (N*T, C, H,
W) for ``F.conv2d`` (the JAX package runs ``lax.conv_general_dilated``
outside any Pallas kernel). Weights are torch OIHW, as in a ``taew2_1.pth``.

- MemBlock: conv(cat[x, the previous frame's x]) with a skip; frame 0's
  previous frame is zeros.
- TPool / TGrow: 1x1 convs over frames stacked into channels frame-major
  (TGrow keeps the last ``stride * C`` output channels of a checkpoint's
  weight when its time upscale is off).
- The decode drops the first ``2^sum(time_up) - 1`` frames: T latent frames
  give 4T - 3.

``tiny_decode(..., chunk=k)`` decodes k latent frames at a time, each
MemBlock carrying its input's last frame from chunk to chunk (the
reference's sequential mode): the same function, with activations of 4k
frames at the last stage instead of 4T (at 480x832 and 64 channels, 0.41 GB
a frame-batch activation per latent frame).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.wan.weights import to_tensor
from ..utils.safetensors_io import read_state_dict

LATENT_CH = 16
IMAGE_CH = 3
N_F = (256, 128, 64, 64)  # decoder widths by stage


@dataclass(frozen=True)
class TinyVAEConfig:
    decoder_time_upscale: Tuple[bool, ...] = (True, True)
    decoder_space_upscale: Tuple[bool, ...] = (True, True, True)

    @property
    def frames_to_trim(self) -> int:
        return 2 ** sum(self.decoder_time_upscale) - 1

    def time_strides(self) -> Tuple[int, ...]:
        """TGrow's stride per decoder stage (stage 0 never grows time)."""
        return (1,) + tuple(2 if up else 1 for up in self.decoder_time_upscale)


# ---------------------------------------------------------------- primitives


def _conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, stride: int = 1) -> torch.Tensor:
    """torch Conv2d semantics: padding 1 for 3x3 kernels, 0 for 1x1."""
    return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)


def _mem_block(p: Dict, x: torch.Tensor, n: int, t: int, prev: Optional[torch.Tensor]):
    """-> (out, the last frame of x): relu(conv3(cat[x, previous frame]) +
    skip). ``prev`` is the frame before x's first (None: zeros)."""
    xt = x.reshape(n, t, *x.shape[1:])
    first = xt.new_zeros((n, 1, *x.shape[1:])) if prev is None else prev[:, None]
    mem = torch.cat([first, xt[:, :-1]], dim=1).reshape(x.shape)
    h = F.relu(_conv(torch.cat([x, mem], dim=1), p["c0_w"], p["c0_b"]))
    del mem
    h = F.relu(_conv(h, p["c1_w"], p["c1_b"]))
    h = _conv(h, p["c2_w"], p["c2_b"])
    skip = x if "skip_w" not in p else _conv(x, p["skip_w"])
    return F.relu(h + skip), xt[:, -1].clone()


def _tpool(p: Dict, x: torch.Tensor, t: int, stride: int):
    """Stack ``stride`` consecutive frames into channels (frame-major), 1x1 conv."""
    if stride > 1:
        x = x.reshape(x.shape[0] // stride, stride * x.shape[1], *x.shape[2:])
    return _conv(x, p["w"]), t // stride


def _tgrow(p: Dict, x: torch.Tensor, t: int, stride: int):
    """1x1 conv C -> stride * C, the channels split (frame-major) into frames."""
    y = _conv(x, p["w"])
    if stride > 1:
        y = y.reshape(y.shape[0] * stride, y.shape[1] // stride, *y.shape[2:])
    return y, t * stride


# ---------------------------------------------------------------- forward


def _decode_frames(d: Dict, lat: torch.Tensor, cfg: TinyVAEConfig, mem: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(N, t, H, W, 16) latents -> (N, t', 3, 8H, 8W), untrimmed; ``mem``
    holds each MemBlock's previous input frame and is updated in place."""
    n, t = lat.shape[:2]
    x = torch.tanh(lat.float() / 3.0) * 3.0  # Clamp
    x = x.permute(0, 1, 4, 2, 3).reshape(n * t, LATENT_CH, *lat.shape[2:4])
    x = F.relu(_conv(x, d["in_w"], d["in_b"]))
    last = len(cfg.decoder_space_upscale) - 1
    for i, (space_up, stride) in enumerate(zip(cfg.decoder_space_upscale, cfg.time_strides())):
        for j in range(3):
            key = f"s{i}_mem{j}"
            x, mem[key] = _mem_block(d[key], x, n, t, mem.get(key))
        if space_up:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        x, t = _tgrow(d[f"s{i}_grow"], x, t, stride)
        x = _conv(x, d[f"s{i}_out_w"])
        if i == last:
            x = F.relu(x)
    x = _conv(x, d["out_w"], d["out_b"])
    return x.reshape(n, t, *x.shape[1:])


def tiny_decode(params: Dict, latents: torch.Tensor, cfg: TinyVAEConfig = TinyVAEConfig(),
                chunk: Optional[int] = None) -> torch.Tensor:
    """latents (N, T, H, W, 16) ~N(0, 1) -> RGB (N, 4T - 3, 8H, 8W, 3) in
    ~[0, 1], fp32. ``chunk`` latent frames decode at a time (None: all)."""
    d = params["decoder"]
    t = latents.shape[1]
    k = t if not chunk else int(chunk)
    mem: Dict[str, torch.Tensor] = {}
    outs = [_decode_frames(d, latents[:, s:s + k], cfg, mem) for s in range(0, t, k)]
    x = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return x[:, cfg.frames_to_trim:].permute(0, 1, 3, 4, 2)


def tiny_encode(params: Dict, video: torch.Tensor) -> torch.Tensor:
    """video (N, T, H, W, 3) in [0, 1], T % 4 == 0 -> latents (N, T/4, H/8,
    W/8, 16)."""
    e = params["encoder"]
    n, t = video.shape[:2]
    x = video.float().permute(0, 1, 4, 2, 3).reshape(n * t, IMAGE_CH, *video.shape[2:4])
    x = F.relu(_conv(x, e["in_w"], e["in_b"]))
    for i, stride in enumerate((2, 2, 1)):
        x, t = _tpool(e[f"s{i}_pool"], x, t, stride)
        x = _conv(x, e[f"s{i}_down_w"], stride=2)
        for j in range(3):
            x, _ = _mem_block(e[f"s{i}_mem{j}"], x, n, t, None)
    x = _conv(x, e["out_w"], e["out_b"])
    return x.reshape(n, t, *x.shape[1:]).permute(0, 1, 3, 4, 2)


def tiny_decode_wan_latents(params: Dict, latents_cfhw: torch.Tensor, cfg: TinyVAEConfig = TinyVAEConfig(),
                            chunk: Optional[int] = None) -> torch.Tensor:
    """The Wan VAE decoder's calling convention: a (C, F, H, W) latent in,
    (F', 8H, 8W, 3) RGB in ~[-1, 1] out."""
    x = latents_cfhw.permute(1, 2, 3, 0)[None]
    return tiny_decode(params, x, cfg, chunk)[0] * 2.0 - 1.0


# ---------------------------------------------------------------- weights


def _draw(rng, kh, kw, cin, cout, scale=0.05) -> np.ndarray:
    """The JAX package's HWIO draw, as torch OIHW (the same values)."""
    w = np.asarray(rng.standard_normal((kh, kw, cin, cout)) * scale, np.float32)
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def _mem_p(rng, cin, cout) -> Dict[str, np.ndarray]:
    p = {"c0_w": _draw(rng, 3, 3, cin * 2, cout), "c0_b": np.zeros(cout, np.float32),
         "c1_w": _draw(rng, 3, 3, cout, cout), "c1_b": np.zeros(cout, np.float32),
         "c2_w": _draw(rng, 3, 3, cout, cout), "c2_b": np.zeros(cout, np.float32)}
    if cin != cout:
        p["skip_w"] = _draw(rng, 1, 1, cin, cout)
    return p


def _to_device(tree, device) -> Dict:
    return {k: _to_device(v, device) if isinstance(v, dict) else to_tensor(v, torch.float32, device).contiguous()
            for k, v in tree.items()}


def init_random_tiny_vae_params(seed: int = 0, cfg: TinyVAEConfig = TinyVAEConfig(), device="cpu") -> Dict:
    """Random parameters with the taew2_1 topology, drawn from host numpy
    in the JAX package's order: the same values as its function of this
    name (about 10 M parameters)."""
    rng = np.random.default_rng(seed)
    enc = {"in_w": _draw(rng, 3, 3, IMAGE_CH, 64), "in_b": np.zeros(64, np.float32)}
    for i, stride in enumerate((2, 2, 1)):
        enc[f"s{i}_pool"] = {"w": _draw(rng, 1, 1, 64 * stride, 64)}
        enc[f"s{i}_down_w"] = _draw(rng, 3, 3, 64, 64)
        for j in range(3):
            enc[f"s{i}_mem{j}"] = _mem_p(rng, 64, 64)
    enc["out_w"], enc["out_b"] = _draw(rng, 3, 3, 64, LATENT_CH), np.zeros(LATENT_CH, np.float32)
    dec = {"in_w": _draw(rng, 3, 3, LATENT_CH, N_F[0]), "in_b": np.zeros(N_F[0], np.float32)}
    for i, stride in enumerate(cfg.time_strides()):
        for j in range(3):
            dec[f"s{i}_mem{j}"] = _mem_p(rng, N_F[i], N_F[i])
        dec[f"s{i}_grow"] = {"w": _draw(rng, 1, 1, N_F[i], N_F[i] * stride)}
        dec[f"s{i}_out_w"] = _draw(rng, 3, 3, N_F[i], N_F[i + 1])
    dec["out_w"], dec["out_b"] = _draw(rng, 3, 3, N_F[3], IMAGE_CH), np.zeros(IMAGE_CH, np.float32)
    return _to_device({"encoder": enc, "decoder": dec}, device)


# the reference nn.Sequential indices: encoder (pool, down, MemBlocks) per
# stage, decoder (MemBlocks, TGrow, out conv) per stage
ENC_SEQ = ((2, 3, (4, 5, 6)), (7, 8, (9, 10, 11)), (12, 13, (14, 15, 16)))
DEC_SEQ = (((3, 4, 5), 7, 8), ((9, 10, 11), 13, 14), ((15, 16, 17), 19, 20))


def convert_taehv_state_dict(sd: Dict, cfg: TinyVAEConfig = TinyVAEConfig(), device="cpu") -> Dict:
    """A taew2_1.pth-style state dict (``encoder.N.*`` / ``decoder.N.*``
    keys, OIHW) -> params on ``device``. A TGrow weight wider than its
    stage's ``stride * C`` keeps its last ``stride * C`` output channels."""

    def mem(prefix):
        p = {"c0_w": sd[f"{prefix}.conv.0.weight"], "c0_b": sd[f"{prefix}.conv.0.bias"],
             "c1_w": sd[f"{prefix}.conv.2.weight"], "c1_b": sd[f"{prefix}.conv.2.bias"],
             "c2_w": sd[f"{prefix}.conv.4.weight"], "c2_b": sd[f"{prefix}.conv.4.bias"]}
        if f"{prefix}.skip.weight" in sd:
            p["skip_w"] = sd[f"{prefix}.skip.weight"]
        return p

    enc = {"in_w": sd["encoder.0.weight"], "in_b": sd["encoder.0.bias"]}
    for i, (pool_i, down_i, mems) in enumerate(ENC_SEQ):
        enc[f"s{i}_pool"] = {"w": sd[f"encoder.{pool_i}.conv.weight"]}
        enc[f"s{i}_down_w"] = sd[f"encoder.{down_i}.weight"]
        for j, m in enumerate(mems):
            enc[f"s{i}_mem{j}"] = mem(f"encoder.{m}")
    enc["out_w"], enc["out_b"] = sd["encoder.17.weight"], sd["encoder.17.bias"]
    dec = {"in_w": sd["decoder.1.weight"], "in_b": sd["decoder.1.bias"]}
    for i, ((mems, grow_i, out_i), stride) in enumerate(zip(DEC_SEQ, cfg.time_strides())):
        for j, m in enumerate(mems):
            dec[f"s{i}_mem{j}"] = mem(f"decoder.{m}")
        gw = sd[f"decoder.{grow_i}.conv.weight"]
        want = N_F[i] * stride
        dec[f"s{i}_grow"] = {"w": gw[-want:] if gw.shape[0] > want else gw}
        dec[f"s{i}_out_w"] = sd[f"decoder.{out_i}.weight"]
    dec["out_w"], dec["out_b"] = sd["decoder.22.weight"], sd["decoder.22.bias"]
    return _to_device({"encoder": enc, "decoder": dec}, device)


def load_tiny_vae_params(path: str, cfg: TinyVAEConfig = TinyVAEConfig(), device="cpu") -> Dict:
    """taew2_1 weights from a ``.pth`` or ``.safetensors`` file."""
    return convert_taehv_state_dict(read_state_dict(path), cfg, device)
