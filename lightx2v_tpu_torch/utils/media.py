"""Seeding, image reading, video writing and the audio/video muxes (the
port's part of ``lightx2v_tpu.utils.media``)."""

from __future__ import annotations

import io
import os
import random
import struct
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


def encode_jpegs(frames: np.ndarray, quality: int) -> list:
    """(T, H, W, 3) uint8 RGB -> one baseline JPEG (bytes) per frame, by PIL
    (the JAX package encodes with cv2, which the port does not use)."""
    from PIL import Image

    out = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, format="JPEG", quality=quality)
        out.append(buf.getvalue())
    return out


def mux_avi_pcm(
    frames: np.ndarray,
    audio: np.ndarray,
    sample_rate: int,
    path: str,
    fps: int = 16,
    jpeg_quality: int = 92,
    normalize: bool = True,
) -> str:
    """Mux video + mono PCM16 audio into one .avi file, pure Python: a
    RIFF-AVI container with MJPG video (a PIL JPEG per frame) and
    interleaved PCM16 audio, the JAX package's layout.

    frames: (T, H, W, 3) RGB (float [-1,1] if normalize else uint8);
    audio: float waveform in [-1, 1] (or int16)."""
    fr = to_uint8_frames(frames) if normalize else frames.astype(np.uint8)
    t, h, w, _ = fr.shape
    if audio.dtype != np.int16:
        audio = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    pcm = audio.tobytes()
    jpegs = encode_jpegs(fr, jpeg_quality)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload + (b"\x00" if len(payload) & 1 else b"")

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    us_per_frame = int(round(1_000_000 / fps))
    max_jpeg = max(len(j) for j in jpegs)
    avih = struct.pack("<14I", us_per_frame, max_jpeg * fps, 0, 0x10,  # HASINDEX
                       t, 0, 2, max_jpeg, w, h, 0, 0, 0, 0)
    # AVIStreamHeader: fccType/fccHandler, flags, prio+lang (2H),
    # init/scale/rate/start/length/bufsize/quality/samplesize (8I),
    # rcFrame (4h)
    strh_v = struct.pack("<4s4sI2H8I4h", b"vids", b"MJPG", 0, 0, 0,
                         0, 1, fps, 0, t, max_jpeg, 0xFFFFFFFF, 0,
                         0, 0, w, h)
    strf_v = struct.pack("<I2i2H2I2i2I", 40, w, h, 1, 24, 0x47504A4D,  # 'MJPG'
                         w * h * 3, 0, 0, 0, 0)
    # mono PCM16: one "sample" = one 2-byte frame
    bytes_sec = sample_rate * 2
    n_samples = len(pcm) // 2
    strh_a = struct.pack("<4s4sI2H8I4h", b"auds", b"\x00\x00\x00\x00", 0, 0, 0,
                         0, 1, sample_rate, 0, n_samples, bytes_sec, 0xFFFFFFFF, 2,
                         0, 0, 0, 0)
    strf_a = struct.pack("<2H2I2H", 1, 1, sample_rate, bytes_sec, 2, 16)  # WAVE_FORMAT_PCM
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh_v) + chunk(b"strf", strf_v))
               + lst(b"strl", chunk(b"strh", strh_a) + chunk(b"strf", strf_a)))

    # interleave: per video frame, the matching slice of audio
    movi_parts = []
    idx_entries = []
    movi_len = 0

    def emit(cc: bytes, data: bytes):
        nonlocal movi_len
        # idx1 offsets point at the chunk fourcc, relative to 'movi'
        idx_entries.append(struct.pack("<4s3I", cc, 0x10, 4 + movi_len, len(data)))
        c = chunk(cc, data)
        movi_parts.append(c)
        movi_len += len(c)

    a_off = 0
    for i, j in enumerate(jpegs):
        emit(b"00dc", j)
        a_end = min(round((i + 1) * bytes_sec / fps) & ~1, len(pcm))
        if i == len(jpegs) - 1:
            a_end = len(pcm)
        if a_end > a_off:
            emit(b"01wb", pcm[a_off:a_end])
            a_off = a_end
    movi_payload = b"".join(movi_parts)
    movi = lst(b"movi", movi_payload)
    idx1 = chunk(b"idx1", b"".join(idx_entries))

    body = b"AVI " + hdrl + movi + idx1
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def mux_mp4_pcm(
    frames: np.ndarray,
    audio: np.ndarray,
    sample_rate: int,
    path: str,
    fps: int = 16,
    jpeg_quality: int = 92,
    normalize: bool = True,
) -> str:
    """Mux video + mono PCM16 audio into one .mp4, pure Python: the JAX
    package's ISO BMFF layout, an MJPEG video track (sample entry ``mp4v``
    + esds objectTypeIndication 0x6C = JPEG, each sample one PIL-encoded
    JPEG, every sample sync) and a QuickTime-style ``sowt`` little-endian
    PCM16 audio track. libavformat (ffmpeg, VLC) demuxes both tracks.

    frames: (T, H, W, 3) RGB (float [-1,1] if normalize else uint8);
    audio: float waveform in [-1, 1] (or int16)."""
    fr = to_uint8_frames(frames) if normalize else frames.astype(np.uint8)
    t, h, w, _ = fr.shape
    if audio.dtype != np.int16:
        audio = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    pcm = audio.astype("<i2").tobytes()
    n_samples = len(pcm) // 2
    jpegs = encode_jpegs(fr, jpeg_quality)

    def box(fourcc: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", 8 + len(payload)) + fourcc + payload

    def full(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
        return box(fourcc, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)

    def desc(tag: int, payload: bytes) -> bytes:
        # MPEG-4 descriptor with expandable length (here always < 2^21)
        n = len(payload)
        if n < 0x80:
            ln = bytes([n])
        elif n < 0x4000:
            ln = bytes([0x80 | (n >> 7), n & 0x7F])
        else:
            ln = bytes([0x80 | (n >> 14), 0x80 | ((n >> 7) & 0x7F), n & 0x7F])
        return bytes([tag]) + ln + payload

    ftyp = box(b"ftyp", b"mp42" + struct.pack(">I", 0) + b"mp42isomqt  ")

    # mdat: all video samples, then the PCM — offsets recorded for stco
    mdat_payload = b"".join(jpegs) + pcm
    mdat_off = len(ftyp) + 8  # first byte of mdat payload in the file
    video_off = mdat_off
    audio_off = mdat_off + sum(len(j) for j in jpegs)
    mdat = box(b"mdat", mdat_payload)

    MOVIE_TS = 1000  # movie timescale
    dur_movie = int(round(t / fps * MOVIE_TS))
    dur_movie = max(dur_movie, int(round(n_samples / sample_rate * MOVIE_TS)))

    def mvhd():
        return full(b"mvhd", 0, 0, struct.pack(
            ">IIII", 0, 0, MOVIE_TS, dur_movie)  # created/modified/timescale/duration
            + struct.pack(">i", 0x00010000)  # rate 1.0
            + struct.pack(">h", 0x0100)      # volume
            + b"\x00" * 10                   # reserved
            + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
            + b"\x00" * 24                   # predefined
            + struct.pack(">I", 3))          # next track id

    def tkhd(track_id, duration, width=0, height=0, volume=0):
        return full(b"tkhd", 0, 7, struct.pack(
            ">IIIII", 0, 0, track_id, 0, duration)
            + b"\x00" * 8
            + struct.pack(">hhhh", 0, 0, volume, 0)
            + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
            + struct.pack(">II", width << 16, height << 16))

    def mdhd(timescale, duration):
        return full(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0))  # lang 'und'

    def hdlr(handler: bytes, name: bytes):
        return full(b"hdlr", 0, 0, struct.pack(">I4s", 0, handler) + b"\x00" * 12 + name + b"\x00")

    def dinf():
        return box(b"dinf", full(b"dref", 0, 0, struct.pack(">I", 1) + full(b"url ", 0, 1, b"")))

    def stts(count, delta):
        return full(b"stts", 0, 0, struct.pack(">III", 1, count, delta))

    def stsc(samples_per_chunk):
        return full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, samples_per_chunk, 1))

    def stco(offset):
        return full(b"stco", 0, 0, struct.pack(">II", 1, offset))

    # ---- video track
    esds_payload = desc(0x03, struct.pack(">HB", 1, 0) + desc(
        0x04,
        # OTI 0x6C = JPEG, streamType visual (0x04<<2|1), bufsize/max/avg
        struct.pack(">BB3sII", 0x6C, 0x11, (0).to_bytes(3, "big"), 0, 0),
    ) + desc(0x06, b"\x02"))
    esds = full(b"esds", 0, 0, esds_payload)
    mp4v = box(b"mp4v", struct.pack(">6xH", 1)  # reserved + data_ref_index
               + struct.pack(">HHII", 0, 0, 0, 0) + struct.pack(">I", 0)
               + struct.pack(">HH", w, h)
               + struct.pack(">II", 0x480000, 0x480000)  # 72 dpi
               + struct.pack(">I", 0) + struct.pack(">H", 1)
               + b"\x00" * 32                       # compressor name
               + struct.pack(">Hh", 24, -1) + esds)
    v_ts = fps * 1000
    stbl_v = box(b"stbl", full(b"stsd", 0, 0, struct.pack(">I", 1) + mp4v)
                 + stts(t, 1000)
                 + stsc(t)
                 + full(b"stsz", 0, 0, struct.pack(">II", 0, t)
                        + b"".join(struct.pack(">I", len(j)) for j in jpegs))
                 + stco(video_off))
    minf_v = box(b"minf", full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0)) + dinf() + stbl_v)
    mdia_v = box(b"mdia", mdhd(v_ts, t * 1000) + hdlr(b"vide", b"VideoHandler") + minf_v)
    trak_v = box(b"trak", tkhd(1, dur_movie, width=w, height=h) + mdia_v)

    # ---- audio track: 'sowt' = s16 little-endian PCM (QTFF)
    sowt = box(b"sowt", struct.pack(">6xH", 1)
               + struct.pack(">HHI", 0, 0, 0)       # version/revision/vendor
               + struct.pack(">HHHH", 1, 16, 0, 0)  # mono, 16-bit
               + struct.pack(">I", min(sample_rate, 65535) << 16))
    stbl_a = box(b"stbl", full(b"stsd", 0, 0, struct.pack(">I", 1) + sowt)
                 + stts(n_samples, 1)
                 + stsc(n_samples)
                 + full(b"stsz", 0, 0, struct.pack(">II", 2, n_samples))
                 + stco(audio_off))
    minf_a = box(b"minf", full(b"smhd", 0, 0, struct.pack(">hH", 0, 0)) + dinf() + stbl_a)
    mdia_a = box(b"mdia", mdhd(sample_rate, n_samples) + hdlr(b"soun", b"SoundHandler") + minf_a)
    trak_a = box(b"trak", tkhd(2, dur_movie, volume=0x0100) + mdia_a)

    moov = box(b"moov", mvhd() + trak_v + trak_a)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(ftyp + mdat + moov)
    return path


def load_image(path: str) -> np.ndarray:
    """Load an RGB image as float32 in [-1, 1], shape (H, W, 3)."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)
    return img / 127.5 - 1.0
