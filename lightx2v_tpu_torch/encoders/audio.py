"""Audio features for audio-driven video (counterpart of
``lightx2v_tpu.encoders.audio``).

A wav read with the standard library and a linear resample on the host,
as in the JAX package, then either the waveform-envelope stand-in
features (one 1024-d row per video frame) that the synthetic mode feeds
the audio adapter, or a wav2vec-class encoder read from an HF directory
(``encoders/wav2vec.py``: ``wav2vec2``, ``hubert``, ``wavlm``; the
directory's ``audio_encoder/`` subfolder where it has one) on the card
unless the caller asks for the CPU: the waveform resampled to 16 kHz,
trimmed or zero-padded to the video's ``16000 * num_frames / fps``
samples, normalized as its ``preprocessor_config.json`` says, encoded in
fp32; ``last_hidden_state`` zero-padded to 1024 features and resampled
linearly to the frames."""

from __future__ import annotations

import os
import wave
from typing import Optional

import numpy as np

from .wav2vec import Wav2VecModel

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
    """wav -> (1, num_frames, 1024) features. ``model_path``: an HF
    wav2vec-class directory, or one with an ``audio_encoder`` subfolder;
    None gives the envelope stand-in."""

    def __init__(self, model_path: Optional[str] = None, device="cuda"):
        self.model = None
        if model_path:
            sub = os.path.join(model_path, "audio_encoder")
            self.model = Wav2VecModel(sub if os.path.isdir(sub) else model_path, device)

    def infer(self, audio_path: str, num_frames: int, fps: float = 16.0) -> np.ndarray:
        waveform, sr = read_wav(audio_path)
        return self.infer_array(waveform, sr, num_frames, fps=fps)

    def infer_array(self, waveform: np.ndarray, sr: int, num_frames: int, fps: float = 16.0) -> np.ndarray:
        if self.model is None:
            return envelope_features(waveform, sr, num_frames, fps=fps)
        wav16 = resample_linear(waveform, sr, 16000)
        need = int(round(16000 * num_frames / fps))
        wav16 = np.pad(wav16[:need], (0, max(0, need - len(wav16))))
        hidden = self.model(wav16)  # (frames at 50 Hz, hidden)
        if hidden.shape[-1] < FEAT_DIM:
            hidden = np.pad(hidden, ((0, 0), (0, FEAT_DIM - hidden.shape[-1])))
        return _interp_time(hidden, num_frames)[None]
