"""Per-output-channel int8 weight quantization of a flat checkpoint dict
(the int8 part of ``lightx2v_tpu.tools.convert``; numpy only)."""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np

from ..utils.logging_utils import logger

_SKIP_QUANT = re.compile(
    r"(norm|modulation|embedding|time_|head\.|img_emb|patch_embedding|bias$|txt_in|vector_in|guidance_in|final_layer)"
)


def quantize_tensor(w: np.ndarray, scheme: str = "int8") -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: scale = max(absmax, 1e-8) / 127."""
    if scheme != "int8":
        raise NotImplementedError(f"quant scheme {scheme!r} is not ported yet (ROADMAP.md, Queue 1 item 12)")
    wf = np.asarray(w, np.float32)
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
