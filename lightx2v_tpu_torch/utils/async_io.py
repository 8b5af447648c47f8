"""Background video saving (counterpart of ``lightx2v_tpu.utils.async_io``):
the frames are written on a worker thread while the caller goes on."""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np

from .media import cache_video

_POOL: Optional[ThreadPoolExecutor] = None
_LOCK = threading.Lock()


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=2, thread_name_prefix="video-io")
        return _POOL


def save_video_async(frames: np.ndarray, path: str, fps: int = 16) -> Future:
    """A Future resolving to the saved path (or None on failure)."""
    frames = np.array(frames)  # a snapshot: the caller may reuse its buffer
    return _pool().submit(cache_video, frames, path, fps)
