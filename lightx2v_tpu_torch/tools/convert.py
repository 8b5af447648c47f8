"""Checkpoint converter (counterpart of ``lightx2v_tpu.tools.convert``):
LoRA folding, the smooth-quant fold (``--calib_stats``, advanced_ptq),
per-output-channel int8 or e4m3 quantization, nibble-packed int4 with
per-(channel, group) scales, e4m3 with 128 x 128 block scales
(``fp8_block128``), and the mx formats (``mxfp8``: e4m3, ``mxfp6``: packed
e2m3, with per-(channel, 32-column) power-of-two scales), written as one
file, chunks with an index, or one file per block (the disk tier's layout,
``models/wan/lazy_offload.py``), with a ``config.json`` naming the mm_type.

    python -m lightx2v_tpu_torch.tools.convert --source CKPT_DIR --output OUT_DIR \
        --quant int8 --layout blocks [--lora path.safetensors[:strength] ...] \
        [--calib_stats stats.npz --smooth_alpha 0.5] [--device cpu]

Quantization runs on the device (the card by default; 14B on the host in
numpy takes minutes), tensor by tensor, each result back where its input
lay. ``quantize_weight`` (torch, any device) equals the JAX package's numpy
``quantize_tensor`` bit for bit: the same fp32 scale ``max(absmax, 1e-8) /
127`` (or / 448, / 7), the same round-half-even and clip. (The 8-bit
kernels scale their *activations* by ``absmax * (1/127)``; a weight's scale
is the division.) An fp8 weight comes out as ``torch.float8_e4m3fn`` codes,
cast by torch, which rounds to nearest even like ``ml_dtypes``; the two
casts differ only past 448 (torch saturates, ``ml_dtypes`` gives NaN from
464 up), where a per-channel scale of absmax / 448 never reaches. The e2m3
codes of ``mxfp6`` are rounded in torch (``encode_fp6_e2m3``): the card
machine has no ``ml_dtypes``.

LoRA folds only into float weights: the JAX ``apply_lora`` adds ``b @ a``
to int8 or e4m3 *codes* without their scale; the port raises there and
points here (fold into the float checkpoint, then quantize)."""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.logging_utils import logger
from ..utils.safetensors_io import as_tensor, load_file, load_sharded, save_file

_SKIP_QUANT = re.compile(
    r"(norm|modulation|embedding|time_|head\.|img_emb|patch_embedding|bias$|txt_in|vector_in|guidance_in|final_layer)"
)

_BLOCK_RE = re.compile(r"^(blocks|double_blocks|single_blocks)\.(\d+)\.")
_QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn, torch.uint8)
SCHEMES = ("int8", "fp8", "int4", "fp8_block128", "mxfp8", "mxfp6")
INT4_GROUP = 512  # largest int4 quant group along in-features


def _pick_bk(kin: int, bk: int = INT4_GROUP) -> int:
    """The int4 quant group: 512 halved while it does not divide in-features,
    down to 128; one group per row when none of them divides."""
    while bk > 128 and kin % bk:
        bk //= 2
    return bk if kin % bk == 0 else kin


def quantize_int4_weight(w: torch.Tensor, bk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (out, in), on its device -> (packed (out, in//2) uint8, scales
    (out, in//bk) fp32). Symmetric int4 in [-7, 7]: scale = max(absmax,
    1e-8) / 7 per (channel, group). Within each group, byte j holds column j
    in its low nibble and column j + bk/2 in its high nibble, both stored +8."""
    out, kin = w.shape
    bk = _pick_bk(kin) if bk is None else bk
    wb = w.float().reshape(out, kin // bk, bk)
    scale = wb.abs().amax(dim=-1).clamp_min(1e-8) / 7.0
    q = torch.round(wb / scale[..., None]).clamp_(-7, 7).to(torch.int8)
    lo = (q[..., : bk // 2] + 8).to(torch.uint8)
    hi = (q[..., bk // 2:] + 8).to(torch.uint8)
    return (lo | (hi << 4)).reshape(out, kin // 2), scale


def quantize_fp8_block128(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """128 x 128 block scales: w (out, in) zero-padded to the block grid,
    amax = max(block absmax, 1e-4), e4m3 codes of w * (448 / amax) cut back
    to (out, in), scales amax / 448 of shape (ceil(out/128), ceil(in/128))."""
    o, i = w.shape
    po, pi = (-o) % 128, (-i) % 128
    blocks = F.pad(w.float(), (0, pi, 0, po)).reshape((o + po) // 128, 128, (i + pi) // 128, 128)
    amax = blocks.abs().amax(dim=(1, 3), keepdim=True).clamp_min(1e-4)
    # a tensor numerator: torch computes scalar / tensor as scalar * (1 / tensor), rounding twice
    q = (blocks * (amax.new_tensor(448.0) / amax)).to(torch.float8_e4m3fn).reshape(o + po, i + pi)[:o, :i]
    return q.contiguous(), (amax[:, 0, :, 0] / 448.0).contiguous()


def encode_fp6_e2m3(x: torch.Tensor) -> torch.Tensor:
    """fp32 values in [-7.5, 7.5] -> uint8 e2m3 codes s|ee|mmm, rounded to
    nearest with ties to the even code (``ml_dtypes.float6_e2m3fn``'s cast,
    bit for bit). The grid's step is 1/8 below 2 (the subnormals 0..7/8 and
    1..15/8), 1/4 below 4 and 1/2 up to 7.5; each step's multiples count the
    codes in order, so rounding |x| / step half to even picks the even code."""
    a = x.abs()
    step = torch.where(a < 2.0, 0.125, torch.where(a < 4.0, 0.25, 0.5))
    v = torch.round(a / step) * step
    e = (v >= 1.0).to(torch.int32) + (v >= 2.0).to(torch.int32) + (v >= 4.0).to(torch.int32)
    m = torch.where(e == 0, v * 8.0, (v / torch.exp2((e - 1).float()) - 1.0) * 8.0).to(torch.int32)
    return ((torch.signbit(x).to(torch.int32) << 5) | (e << 3) | m).to(torch.uint8)


def pack_fp6(codes: torch.Tensor) -> torch.Tensor:
    """(rows, n) 6-bit codes -> (rows, 3 n / 4) uint8: four codes c0..c3 as
    the 24 bits c0 | c1 << 6 | c2 << 12 | c3 << 18, little-endian."""
    rows, n = codes.shape
    c = codes.reshape(rows, n // 4, 4).to(torch.int32)
    bits = c[..., 0] | (c[..., 1] << 6) | (c[..., 2] << 12) | (c[..., 3] << 18)
    return torch.stack([bits & 255, (bits >> 8) & 255, (bits >> 16) & 255], dim=-1).to(torch.uint8).reshape(
        rows, 3 * n // 4)


def quantize_mx(w: torch.Tensor, scheme: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """mx formats: per-(channel, 32-column block) power-of-two scales, the
    smallest with block absmax / scale <= fmax (448 for mxfp8, 7.5 for
    mxfp6): scale = 2^ceil(log2(max(absmax, 1e-12) / fmax)), the log2
    correctly rounded to fp32 as numpy's is (through fp64: the card's fp32
    log2 is not). mxfp8: e4m3 codes (out, in); mxfp6: e2m3 codes packed
    (out, 3 in / 4). in_features must be a multiple of 32."""
    o, i = w.shape
    if i % 32:
        raise ValueError(f"mx formats need in_features % 32 == 0, got {i}")
    g = w.float().reshape(o, i // 32, 32)
    amax = g.abs().amax(dim=2).clamp_min(1e-12)
    fmax = 448.0 if scheme == "mxfp8" else 7.5
    scale = torch.exp2(torch.ceil(torch.log2((amax / fmax).double()).float()))
    el = torch.clamp(g / scale[:, :, None], -fmax, fmax)
    if scheme == "mxfp8":
        return el.to(torch.float8_e4m3fn).reshape(o, i), scale
    return pack_fp6(encode_fp6_e2m3(el).reshape(o, i)), scale


def quantize_weight(w: torch.Tensor, scheme: str = "int8") -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantization of w (out, in), on its device. int8: per output channel,
    scale = max(absmax, 1e-8) / 127, codes clip(round(w / scale)). fp8: scale
    = max(absmax, 1e-8) / 448, float8_e4m3fn codes of w / scale. int4:
    ``quantize_int4_weight``; fp8_block128: ``quantize_fp8_block128``; mxfp8,
    mxfp6: ``quantize_mx``. Scales are fp32."""
    if scheme == "int4":
        return quantize_int4_weight(w)
    if scheme == "fp8_block128":
        return quantize_fp8_block128(w)
    if scheme in ("mxfp8", "mxfp6"):
        return quantize_mx(w, scheme)
    if scheme not in ("int8", "fp8"):
        raise ValueError(f"unknown quant scheme {scheme!r}")
    wf = w.float()
    absmax = wf.abs().amax(dim=1)
    if scheme == "fp8":
        scale = absmax.clamp_min(1e-8) / 448.0
        return (wf / scale[:, None]).to(torch.float8_e4m3fn), scale
    scale = absmax.clamp_min(1e-8) / 127.0
    return torch.round(wf / scale[:, None]).clamp_(-127, 127).to(torch.int8), scale


def _scale_key(name: str) -> str:
    return name.replace(".weight", ".weight_scale") if name.endswith(".weight") else name + "_scale"


def quantize_model(weights: Dict[str, Any], scheme: str = "int8", device=None) -> Dict[str, Any]:
    """Quantize every 2-D matmul weight not matched by ``_SKIP_QUANT`` with
    ``quantize_weight`` on ``device`` (default: where it lies; a numpy array
    lies on the host) and add ``<name>.weight_scale`` beside it. Codes and
    scale are torch tensors where the weight lay; other entries pass as
    they are."""
    out: Dict[str, Any] = {}
    n_q = 0
    for name, w in weights.items():
        if w.ndim == 2 and not _SKIP_QUANT.search(name):
            t = as_tensor(w)
            q, scale = quantize_weight(t.to(device) if device is not None else t, scheme)
            out[name], out[_scale_key(name)] = q.to(t.device), scale.to(t.device)
            n_q += 1
        else:
            out[name] = w
    logger.info(f"quantized {n_q} matmul weights to {scheme}")
    return out


def _fold(weights: Dict[str, Any], key: str, delta, strength: float, device) -> None:
    w = as_tensor(weights[key])
    if w.dtype in _QUANT_DTYPES or _scale_key(key) in weights:
        raise ValueError(f"LoRA meets quantized weight {key} ({w.dtype}): fold the LoRA into the float checkpoint "
                         f"first, then quantize (python -m lightx2v_tpu_torch.tools.convert --lora ...)")
    dev = device if device is not None else w.device
    out = w.to(dev, torch.float32) + strength * delta(dev)
    weights[key] = out.to(w.dtype).to(w.device)


def apply_lora(weights: Dict[str, Any], lora: Dict[str, Any], strength: float = 1.0, device=None) -> int:
    """Fold LoRA factors into float weights in place and return how many
    deltas were applied: ``lora_A``/``lora_B`` (or ``lora_down``/``lora_up``)
    pairs add ``strength * b @ a`` in fp32, ``.diff`` / ``.diff_b`` add to
    a weight / bias; keys lose a ``diffusion_model.`` prefix. Runs on
    ``device`` (default: where each weight lies). Raises ``ValueError`` on
    a quantized weight."""
    applied = 0

    def f32(key):
        return lambda dev: as_tensor(lora[key]).to(dev, torch.float32)

    for key in list(lora):
        if key.endswith("lora_A.weight") or key.endswith("lora_down.weight"):
            up_key = key.replace("lora_A", "lora_B").replace("lora_down", "lora_up")
            base_key = re.sub(r"\.(lora_A|lora_down)\.weight$", ".weight", key).replace("diffusion_model.", "")
            if up_key in lora and base_key in weights:
                _fold(weights, base_key, lambda dev: f32(up_key)(dev) @ f32(key)(dev), strength, device)
                applied += 1
        elif key.endswith(".diff") or key.endswith(".diff_b"):
            stem, sfx = key.rsplit(".", 1)
            base_key = (stem + (".weight" if sfx == "diff" else ".bias")).replace("diffusion_model.", "")
            if base_key in weights:
                _fold(weights, base_key, f32(key), strength, device)
                applied += 1
    logger.info(f"applied {applied} LoRA deltas")
    return applied


SMOOTH_SITES = (("self_attn.q", ("self_attn.q", "self_attn.k", "self_attn.v"), "affine_norm1"),
                ("ffn.0", ("ffn.0",), "affine_norm3"))


def apply_smooth_quant(weights: Dict[str, Any], stats: Dict[str, Any], alpha: float = 0.5, device=None) -> int:
    """Fold SmoothQuant factors into float weights in place and return the
    number of sites folded. At each block's two smoothable sites (the
    self-attention's input: q, k, v; the FFN's: ffn.0), with the site's
    activation absmax from ``stats`` (``tools/calibrate.py``) and the
    column absmax over its weights, s = ``smooth_factors``: the weights'
    columns are multiplied by s (fp32 results) and ``affine_norm1`` /
    ``affine_norm3`` (weight and bias) become 1 / s, which the forward
    applies on the normalized activations (``models/wan/model.py``), so the
    fold is transparent before quantization. Runs on ``device`` (default:
    where each weight lies); each result goes back where its weight lay."""
    from .calibrate import smooth_factors

    block_ids = sorted({int(k.split(".")[1]) for k in weights if k.startswith("blocks.")})
    n_smoothed = 0
    for i in block_ids:
        for site, mods, affine in SMOOTH_SITES:
            act = stats.get(f"blocks.{i}.{site}")
            if act is None:
                continue
            ws = [as_tensor(weights[f"blocks.{i}.{m}.weight"]) for m in mods]
            dev = device if device is not None else ws[0].device
            wmax = None
            for w in ws:
                wm = w.to(dev, torch.float32).abs().amax(dim=0)
                wmax = wm if wmax is None else torch.maximum(wmax, wm)
            # the factors are one vector a site: numpy's power on the host, as the JAX converter computes them
            s = smooth_factors(wmax.cpu().numpy(), np.asarray(as_tensor(act).float().cpu().numpy()), alpha)
            st = torch.from_numpy(s).to(dev)
            for m, w in zip(mods, ws):
                weights[f"blocks.{i}.{m}.weight"] = (w.to(dev, torch.float32) * st[None, :]).to(w.device)
            inv = torch.from_numpy((1.0 / s).astype(np.float32)).to(ws[0].device)
            weights[f"blocks.{i}.{affine}.weight"] = inv
            weights[f"blocks.{i}.{affine}.bias"] = inv.clone()
            n_smoothed += 1
    logger.info(f"smooth-quant folded at {n_smoothed} sites (alpha={alpha})")
    return n_smoothed


def _nbytes(v) -> int:
    t = as_tensor(v)
    return t.numel() * t.element_size()


def save_quantized(weights: Dict[str, Any], out_dir: str, layout: str = "single", scheme: Optional[str] = None,
                   chunk_gb: float = 4.0, advanced_ptq: bool = False) -> None:
    """Write ``weights`` to ``out_dir`` as ``model.safetensors``
    (``single``), ``model-NNNNN.safetensors`` files of about ``chunk_gb``
    with ``model.safetensors.index.json`` (``chunked``), or one
    ``block_{i}.safetensors`` per block plus ``non_block.safetensors``
    (``blocks``); and ``config.json`` with the scheme's mm_type (and
    ``quant_method: advanced_ptq`` for a smooth-quant fold)."""
    os.makedirs(out_dir, exist_ok=True)
    if layout == "single":
        save_file(weights, os.path.join(out_dir, "model.safetensors"))
    elif layout == "chunked":
        index: Dict[str, Any] = {"weight_map": {}, "metadata": {}}
        chunks, size = [{}], 0
        for k, v in weights.items():
            chunks[-1][k] = v
            size += _nbytes(v)
            if size >= chunk_gb * 2**30:
                chunks.append({})
                size = 0
        for idx, chunk in enumerate(c for c in chunks if c):
            fname = f"model-{idx:05d}.safetensors"
            save_file(chunk, os.path.join(out_dir, fname))
            index["weight_map"].update(dict.fromkeys(chunk, fname))
        with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
            json.dump(index, f, indent=2)
    elif layout == "blocks":
        blocks: Dict[str, Dict[str, Any]] = {}
        non_block: Dict[str, Any] = {}
        for k, v in weights.items():
            m = _BLOCK_RE.match(k)
            if m:
                blocks.setdefault(m.group(2), {})[k] = v
            else:
                non_block[k] = v
        for idx, tensors in blocks.items():
            save_file(tensors, os.path.join(out_dir, f"block_{idx}.safetensors"))
        save_file(non_block, os.path.join(out_dir, "non_block.safetensors"))
    else:
        raise ValueError(f"unknown layout {layout}")
    cfg: Dict[str, Any] = {"mm_type": mm_type_for_scheme(scheme)}
    if advanced_ptq:
        cfg["quant_method"] = "advanced_ptq"
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)


def mm_type_for_scheme(scheme: Optional[str]) -> str:
    """The runtime mm_type of a quant scheme; weight-only int4 keeps bf16
    activations."""
    if not scheme:
        return "Default"
    if scheme == "int4":
        return "W-int4-group-sym-A-bf16-Tpu"
    if scheme == "fp8_block128":
        return "W-fp8-block128-sym-A-fp8-channel-group128-sym-dynamic-Tpu"
    if scheme == "mxfp8":
        return "W-mxfp8-A-mxfp8-dynamic-Tpu"
    if scheme == "mxfp6":
        return "W-mxfp6-A-mxfp8-dynamic-Tpu"
    return f"W-{scheme}-channel-sym-A-{scheme}-channel-sym-dynamic-Tpu"


def main(argv=None):
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(description="fold LoRAs into, quantize and re-lay a checkpoint")
    p.add_argument("--source", required=True, help="source checkpoint dir (safetensors)")
    p.add_argument("--output", required=True)
    p.add_argument("--quant", choices=list(SCHEMES) + ["none"], default="int8")
    p.add_argument("--calib_stats", default=None,
                   help="activation-stats .npz from tools/calibrate.py; folds smooth-quant factors into the "
                        "weights and writes affine_norm tensors (advanced_ptq)")
    p.add_argument("--smooth_alpha", type=float, default=0.5)
    p.add_argument("--layout", choices=["single", "chunked", "blocks"], default="single")
    p.add_argument("--lora", action="append", default=[], help="path[:strength]")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where LoRAs fold and weights quantize (default cuda; cuda without a GPU raises)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    weights = load_sharded(args.source)
    for spec in args.lora:
        path, _, s = spec.partition(":")
        apply_lora(weights, load_file(path), float(s or 1.0), device=device)
    if args.calib_stats:
        from .calibrate import load_stats

        apply_smooth_quant(weights, load_stats(args.calib_stats), args.smooth_alpha, device=device)
    scheme = None if args.quant == "none" else args.quant
    if scheme:
        weights = quantize_model(weights, scheme, device=device)
    save_quantized(weights, args.output, args.layout, scheme, advanced_ptq=bool(args.calib_stats))
    logger.info(f"saved to {args.output}")


if __name__ == "__main__":
    main()
