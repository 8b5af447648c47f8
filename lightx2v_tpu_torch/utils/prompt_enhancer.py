"""Prompt enhancer (counterpart of ``lightx2v_tpu.utils.prompt_enhancer``).

Rewrites a terse prompt into a detailed video description by POSTing it to
an enhancer service (``{url}/v1/enhance``, stdlib only). The local enhancer,
an HF Qwen-class causal LM through ``transformers``, is not ported: the
card machine has no ``transformers``, so ``PromptEnhancer`` raises.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Optional

from .logging_utils import logger


class PromptEnhancer:
    """The local LM-based enhancer: not ported (it needs ``transformers``)."""

    def __init__(self, model_name: str = "Qwen/Qwen2.5-32B-Instruct", device: str = "cpu"):
        raise NotImplementedError(f"the local prompt enhancer ({model_name} through transformers) is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 18); run an enhancer service and set "
                                  "prompt_enhancer_url")


def enhance_via_service(prompt: str, url: str, timeout: float = 30.0) -> Optional[str]:
    """POST the prompt to an enhancer service; the enhanced prompt, or None
    on any failure so that callers fall back to the raw prompt."""
    try:
        req = urllib.request.Request(
            url.rstrip("/") + "/v1/enhance",
            data=json.dumps({"prompt": prompt}).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read()).get("prompt") or None
    except Exception as e:
        logger.warning(f"prompt enhancer service unavailable: {e}")
        return None
