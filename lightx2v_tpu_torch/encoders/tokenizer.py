"""Prompt tokenization (counterpart of ``lightx2v_tpu.encoders.tokenizer``):
whitespace and HTML clean-up of the prompt, then an HF ``AutoTokenizer``
(imported when first used, from local files only) to fixed-length ids and
mask. ``HFTokenizer`` is the HF text encoders' call (``encoders/hf_text.py``,
as the JAX ``TextEncoderHF*`` models tokenize): the texts as given, padded on
the right to ``max_length`` and truncated."""

from __future__ import annotations

import html
import re
from functools import lru_cache
from typing import Sequence, Tuple, Union

import numpy as np

_WS = re.compile(r"\s+")


def clean_prompt(text: str) -> str:
    """Fix mojibake when ftfy is present, unescape HTML entities twice
    (scraped prompts are often double-escaped), collapse whitespace."""
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return _WS.sub(" ", text).strip()


@lru_cache(maxsize=4)
def _hf_tokenizer(name_or_path: str):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)


def encode_prompts(tokenizer_path: str, prompts: Union[str, Sequence[str]],
                   seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Prompt(s) -> ``(ids, mask)`` numpy arrays of shape (B, seq_len),
    padded and truncated to ``seq_len``; mask is 1 on real tokens."""
    if isinstance(prompts, str):
        prompts = [prompts]
    out = _hf_tokenizer(tokenizer_path)([clean_prompt(p) for p in prompts], return_tensors="np",
                                        padding="max_length", truncation=True, max_length=seq_len)
    return np.asarray(out["input_ids"]), np.asarray(out["attention_mask"])


def hf_tokenize(tokenizer_path: str, texts: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Texts -> ``(ids, mask)`` numpy arrays (B, max_length): no clean-up,
    ``padding="max_length"`` on the right, truncated."""
    out = _hf_tokenizer(tokenizer_path)(list(texts), return_tensors="np", padding="max_length", truncation=True,
                                        max_length=max_length, padding_side="right")
    return np.asarray(out["input_ids"]), np.asarray(out["attention_mask"])


class HFTokenizer:
    """The tokenizer files of an HF model directory as the text encoders'
    tokenizer callable, ``(texts, return_mask=False) -> ids`` or ``(ids,
    mask)``; ``transformers`` is imported at the first call, and its absence
    raises there."""

    def __init__(self, path: str, max_length: int):
        self.path = path
        self.max_length = max_length

    def __call__(self, texts, return_mask=False, **kw):
        ids, mask = hf_tokenize(self.path, [texts] if isinstance(texts, str) else texts, self.max_length)
        return (ids, mask) if return_mask else ids
