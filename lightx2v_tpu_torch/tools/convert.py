"""Weight quantization of a flat checkpoint dict (the int8, fp8 and int4
parts of ``lightx2v_tpu.tools.convert``): per-output-channel int8 or e4m3,
and nibble-packed int4 with per-(channel, group) scales. ``quantize_tensor``
takes and returns numpy arrays.

numpy has no float8 dtype, and the port does not import ``ml_dtypes``: an
fp8 weight comes out of ``quantize_tensor`` as uint8 **bit patterns** of
float8_e4m3fn codes (``fp8_bits_to_tensor`` views them as
``torch.float8_e4m3fn``, which is what ``quantize_model`` stores, so that
the loader cannot take them for packed int4 bytes). The codes
are cast by torch, which rounds to nearest even like ``ml_dtypes``; the two
casts differ only past 448 (torch saturates, ``ml_dtypes`` gives NaN from
464 up), where a per-channel scale of absmax / 448 never reaches."""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.logging_utils import logger

_SKIP_QUANT = re.compile(
    r"(norm|modulation|embedding|time_|head\.|img_emb|patch_embedding|bias$|txt_in|vector_in|guidance_in|final_layer)"
)

INT4_GROUP = 512  # largest int4 quant group along in-features


def _pick_bk(kin: int, bk: int = INT4_GROUP) -> int:
    """The int4 quant group: 512 halved while it does not divide in-features,
    down to 128; one group per row when none of them divides."""
    while bk > 128 and kin % bk:
        bk //= 2
    return bk if kin % bk == 0 else kin


def quantize_int4(w: np.ndarray, bk: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """w (out, in) -> (packed (out, in//2) uint8, scales (out, in//bk) fp32).
    Symmetric int4 in [-7, 7]: scale = max(absmax, 1e-8) / 7 per (channel,
    group). Within each group, byte j holds column j in its low nibble and
    column j + bk/2 in its high nibble, both stored +8."""
    out, kin = w.shape
    bk = _pick_bk(kin) if bk is None else bk
    wb = w.reshape(out, kin // bk, bk).astype(np.float32)
    scale = np.maximum(np.abs(wb).max(axis=-1), 1e-8) / 7.0
    q = np.clip(np.round(wb / scale[..., None]), -7, 7).astype(np.int8)
    lo = (q[..., : bk // 2] + 8).astype(np.uint8)
    hi = (q[..., bk // 2:] + 8).astype(np.uint8)
    return (lo | (hi << 4)).reshape(out, kin // 2), scale.astype(np.float32)


def fp8_bits(x: np.ndarray) -> np.ndarray:
    """fp32 values -> uint8 bit patterns of their float8_e4m3fn codes
    (torch's cast: round to nearest even, saturating at +-448)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.float8_e4m3fn)
    return t.view(torch.uint8).numpy()


def fp8_bits_to_tensor(bits: np.ndarray) -> torch.Tensor:
    """uint8 bit patterns -> a float8_e4m3fn tensor (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(bits, np.uint8)).view(torch.float8_e4m3fn)


def quantize_tensor(w: np.ndarray, scheme: str = "int8") -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric quantization of w (out, in).
    int8: scale = max(absmax, 1e-8) / 127, codes clip(round(w / scale)).
    fp8: scale = max(absmax, 1e-8) / 448, codes w / scale cast to e4m3,
    returned as uint8 bit patterns (``fp8_bits``).
    int4: ``quantize_int4``."""
    wf = np.asarray(w, np.float32)
    if scheme == "int4":
        return quantize_int4(wf)
    if scheme not in ("int8", "fp8"):
        raise NotImplementedError(f"quant scheme {scheme!r} is not ported yet (ROADMAP.md, Queue 1 item 12)")
    absmax = np.abs(wf).max(axis=1)
    if scheme == "fp8":
        scale = np.maximum(absmax, 1e-8) / 448.0
        return fp8_bits(wf / scale[:, None]), scale
    scale = np.maximum(absmax, 1e-8) / 127.0
    q = np.clip(np.round(wf / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def quantize_model(weights: Dict[str, np.ndarray], scheme: str = "int8") -> Dict[str, Any]:
    """Quantize every 2-D matmul weight not matched by ``_SKIP_QUANT``; adds
    ``<name>.weight_scale`` beside each. fp8 weights come back as
    float8_e4m3fn torch tensors (numpy has no fp8 dtype), all else as numpy
    arrays."""
    out: Dict[str, Any] = {}
    n_q = 0
    for name, w in weights.items():
        if w.ndim == 2 and not _SKIP_QUANT.search(name):
            q, scale = quantize_tensor(w, scheme)
            out[name] = fp8_bits_to_tensor(q) if scheme == "fp8" else q
            out[name.replace(".weight", ".weight_scale") if name.endswith(".weight") else name + "_scale"] = scale
            n_q += 1
        else:
            out[name] = w
    logger.info(f"quantized {n_q} matmul weights to {scheme}")
    return out
