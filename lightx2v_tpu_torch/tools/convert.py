"""Weight quantization of a flat checkpoint dict (the int8 and int4 parts of
``lightx2v_tpu.tools.convert``; numpy only): per-output-channel int8, and
nibble-packed int4 with per-(channel, group) scales."""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np

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


def quantize_tensor(w: np.ndarray, scheme: str = "int8") -> Tuple[np.ndarray, np.ndarray]:
    """int8: per-output-channel symmetric, scale = max(absmax, 1e-8) / 127.
    int4: ``quantize_int4``."""
    wf = np.asarray(w, np.float32)
    if scheme == "int4":
        return quantize_int4(wf)
    if scheme != "int8":
        raise NotImplementedError(f"quant scheme {scheme!r} is not ported yet (ROADMAP.md, Queue 1 item 12)")
    absmax = np.abs(wf).max(axis=1)
    scale = np.maximum(absmax, 1e-8) / 127.0
    q = np.clip(np.round(wf / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def quantize_model(weights: Dict[str, np.ndarray], scheme: str = "int8") -> Dict[str, np.ndarray]:
    """Quantize every 2-D matmul weight not matched by ``_SKIP_QUANT``; adds
    ``<name>.weight_scale`` beside each."""
    out: Dict[str, np.ndarray] = {}
    n_q = 0
    for name, w in weights.items():
        if w.ndim == 2 and not _SKIP_QUANT.search(name):
            q, scale = quantize_tensor(w, scheme)
            out[name] = q
            out[name.replace(".weight", ".weight_scale") if name.endswith(".weight") else name + "_scale"] = scale
            n_q += 1
        else:
            out[name] = w
    logger.info(f"quantized {n_q} matmul weights to {scheme}")
    return out
