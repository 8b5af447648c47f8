"""Seeding and video writing (the slice's part of ``lightx2v_tpu.utils.media``)."""

from __future__ import annotations

import random
import time
from typing import Optional

import numpy as np
import torch

from .logging_utils import logger


def seed_all(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)


def to_uint8_frames(video: np.ndarray) -> np.ndarray:
    """(T, H, W, C) float in [-1, 1] -> uint8."""
    video = np.clip((video + 1.0) / 2.0, 0.0, 1.0)
    return (video * 255.0 + 0.5).astype(np.uint8)


def video_writer():
    """The importable video writer module (imageio, else cv2); raises when
    neither is installed."""
    for name in ("imageio", "cv2"):
        try:
            return __import__(name)
        except ImportError:
            continue
    raise RuntimeError("writing a video needs imageio or cv2 and neither is importable "
                       "(run the pipeline with save_video=False, or the CLI with --save_video_path '')")


def _write_mp4(frames: np.ndarray, path: str, fps: int) -> None:
    writer = video_writer()
    if writer.__name__ == "imageio":
        writer.mimwrite(path, list(frames), fps=fps)
        return
    cv2 = writer
    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


def cache_video(video: np.ndarray, save_path: str, fps: int = 16, normalize: bool = True,
                retry: int = 5) -> Optional[str]:
    """Write (T, H, W, C) frames to mp4 with a retry loop. Raises when no
    video writer (imageio or cv2) is importable."""
    frames = to_uint8_frames(video) if normalize else video.astype(np.uint8)
    error = None
    for _ in range(retry):
        try:
            _write_mp4(frames, save_path, fps)
            return save_path
        except RuntimeError:
            raise
        except Exception as e:  # io errors: retry, then report
            error = e
            time.sleep(0.5)
    logger.error(f"cache_video failed, error: {error}")
    return None
