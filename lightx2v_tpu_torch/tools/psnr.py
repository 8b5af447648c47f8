"""PSNR of generated frames against reference frames (counterpart of
``lightx2v_tpu.tools.psnr``).

    python -m lightx2v_tpu_torch.tools.psnr --ours out.npy --ref ref.npy [--min_db 35]

``.npy`` and ``.npz`` (its ``frames``) always load. An ``.mp4`` is read
through ``cv2`` where it imports; without it (the card machine) reading one
raises ``ImportError`` (ROADMAP.md, Queue 3, difference av). The math is
numpy on the host, in float64.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np


def psnr(ref: np.ndarray, got: np.ndarray, data_range: Optional[float] = None) -> float:
    """Peak signal-to-noise ratio in dB; ``data_range`` defaults to 255 for
    uint8 inputs and ref.max() - ref.min() otherwise. Equal inputs give inf."""
    ref, got = np.asarray(ref), np.asarray(got)
    if ref.shape != got.shape:
        raise ValueError(f"shape mismatch: {ref.shape} vs {got.shape}")
    if data_range is None:
        data_range = 255.0 if ref.dtype == np.uint8 else float(ref.max() - ref.min())
    mse = np.mean(np.square(ref.astype(np.float64) - got.astype(np.float64)))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range * data_range / mse))


def per_frame_psnr(ref: np.ndarray, got: np.ndarray) -> List[float]:
    """PSNR of each frame of (T, H, W, C) videos."""
    return [psnr(r, g, data_range=255.0 if ref.dtype == np.uint8 else None) for r, g in zip(ref, got)]


def load_frames(path: str) -> np.ndarray:
    """(T, H, W, C) frames from ``.npy``, ``.npz["frames"]``, or (through
    ``cv2``, RGB) a video file."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z["frames"]
    try:  # an optional reader, looked up as utils/media.video_writer looks up its writers
        cv2 = __import__("cv2")
    except ImportError as e:
        raise ImportError(f"reading {path} needs cv2, which does not import here; pass .npy or .npz frames "
                          f"(ROADMAP.md, Queue 3, difference av)") from e
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="PSNR vs reference frames")
    ap.add_argument("--ours", required=True)
    ap.add_argument("--ref", required=True)
    ap.add_argument("--min_db", type=float, default=35.0, help="pass threshold in dB")
    args = ap.parse_args(argv)

    ref, got = load_frames(args.ref), load_frames(args.ours)
    t = min(len(ref), len(got))
    per = per_frame_psnr(ref[:t], got[:t])
    overall = psnr(ref[:t], got[:t])
    print(f"frames={t} overall_psnr={overall:.2f} dB  min={min(per):.2f}  mean={float(np.mean(per)):.2f}")
    ok = overall >= args.min_db
    print("PASS" if ok else f"FAIL (< {args.min_db} dB)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
