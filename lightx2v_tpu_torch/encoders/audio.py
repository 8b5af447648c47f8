"""Audio features for audio-driven video (counterpart of
``lightx2v_tpu.encoders.audio``).

Host numpy, as in the JAX package: a wav read with the standard library,
a linear resample, and the waveform-envelope stand-in features (one
1024-d row per video frame) that the synthetic mode feeds the audio
adapter. The wav2vec-class encoder of a real checkpoint runs through
``transformers``, which the port does not depend on: ``AudioEncoder``
with a model path raises ``NotImplementedError`` (ROADMAP.md, Queue 1
item 20)."""

from __future__ import annotations

import wave
from typing import Optional

import numpy as np

FEAT_DIM = 1024


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Mono fp32 waveform + sample rate."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        raw = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16).astype(np.float32) / 32768.0
        if w.getnchannels() > 1:
            raw = raw.reshape(-1, w.getnchannels()).mean(-1)
    return raw, sr


def resample_linear(x: np.ndarray, sr: int, target_sr: int = 16000) -> np.ndarray:
    if sr == target_sr:
        return x
    n_out = int(round(len(x) * target_sr / sr))
    return np.interp(np.linspace(0.0, len(x) - 1.0, n_out), np.arange(len(x)), x).astype(np.float32)


def envelope_features(waveform: np.ndarray, sr: int, num_frames: int, fps: float = 16.0,
                      feat_dim: int = FEAT_DIM) -> np.ndarray:
    """Frame-aligned stand-in features from the waveform envelope: (1,
    num_frames, feat_dim), zero rows past the waveform's end."""
    per_frame = max(1, int(sr / fps))
    feats = np.zeros((num_frames, feat_dim), np.float32)
    for i in range(num_frames):
        seg = waveform[i * per_frame: (i + 1) * per_frame]
        if len(seg):
            env = np.abs(seg)
            bins = np.array_split(env, feat_dim)
            feats[i] = [b.mean() if len(b) else 0.0 for b in bins]
    return feats[None]


def _interp_time(feats: np.ndarray, num_frames: int) -> np.ndarray:
    """(T, D) -> (num_frames, D) linear resample along time."""
    t_in = feats.shape[0]
    if t_in == num_frames:
        return feats
    src = np.linspace(0.0, t_in - 1.0, num_frames)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, t_in - 1)
    w = (src - lo)[:, None].astype(np.float32)
    return feats[lo] * (1.0 - w) + feats[hi] * w


class AudioEncoder:
    """wav -> (1, num_frames, 1024) features: the envelope stand-in. A
    ``model_path`` (a wav2vec-class checkpoint) is refused."""

    def __init__(self, model_path: Optional[str] = None):
        if model_path:
            raise NotImplementedError("the wav2vec audio encoder (a transformers checkpoint) is not ported yet "
                                      "(ROADMAP.md, Queue 1 item 20)")

    def infer(self, audio_path: str, num_frames: int, fps: float = 16.0) -> np.ndarray:
        waveform, sr = read_wav(audio_path)
        return self.infer_array(waveform, sr, num_frames, fps=fps)

    def infer_array(self, waveform: np.ndarray, sr: int, num_frames: int, fps: float = 16.0) -> np.ndarray:
        return envelope_features(waveform, sr, num_frames, fps=fps)
