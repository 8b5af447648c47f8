"""Image resizing without OpenCV: the two ``cv2.resize`` modes that the JAX
package's i2v path uses, as one (out, in) weight matrix per axis applied to
an (H, W, C) float32 array on the host.

``resize_bicubic`` matches ``cv2.INTER_CUBIC`` on float images: Keys' cubic
with A = -0.75, half-pixel centres (src = (dst + 0.5) * in / out - 0.5, its
fraction rounded to float32 as cv2 keeps it), the four taps' indices clamped
into the image (a replicated border), and no antialiasing when it shrinks. ``resize_area`` matches ``cv2.INTER_AREA``:
when neither axis grows, each output pixel averages the input pixels its
cell covers, weighted by the covered fraction (cv2's
``computeResizeAreaTab``); when an axis grows, cv2 runs its linear filter in
"area mode" on both axes (src = floor(dst * in / out), with the fraction
(dst + 1) - (src + 1) * out / in kept past zero), and so does this. An
unchanged size returns a copy, as cv2 does.

The weights are built in float64 and the sums run in float64, rounded once
to float32; cv2 sums in float32 in its own order, so the two differ in the
last bits (``tests/test_torch_i2v.py`` pins the difference).

``resize_trilinear`` resizes a latent tensor on its device as
``jax.image.resize(..., method="trilinear")`` does when no axis shrinks:
half-pixel centres, and at the edges the weights of the taps inside the
latent renormalised to 1, which is ``F.interpolate(mode="trilinear",
align_corners=False)``'s clamp (``tests/test_torch_changing_resolution.py``
pins it)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _cubic(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """cv2's ``interpolateCubic`` weights of the four taps at offsets
    -1, 0, 1, 2 for the fractions ``t``."""
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    return np.stack([w0, w1, w2, 1 - w0 - w1 - w2], axis=-1)


def bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of cv2's INTER_CUBIC along one axis."""
    scale = 1.0 / (n_out / n_in)
    f = (np.arange(n_out) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    taps = _cubic((f - s).astype(np.float32).astype(np.float64))  # cv2 keeps the fraction as a float
    w = np.zeros((n_out, n_in))
    for j in range(4):
        np.add.at(w, (np.arange(n_out), np.clip(s - 1 + j, 0, n_in - 1)), taps[:, j])
    return w


def area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) pixel-coverage weights of cv2's INTER_AREA shrink
    along one axis."""
    scale = 1.0 / (n_out / n_in)  # cv2 keeps the inverse scale and inverts it
    w = np.zeros((n_out, n_in))
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += (s1 - f1) / cell
        w[d, s1:s2] += 1.0 / cell
        if f2 - s2 > 1e-3:
            w[d, s2] += min(min(f2 - s2, 1.0), cell) / cell
    return w


def area_linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of cv2's linear filter in area mode (INTER_AREA
    on an image that grows along some axis)."""
    inv = n_out / n_in
    scale = 1.0 / inv
    w = np.zeros((n_out, n_in))
    for d in range(n_out):
        s = math.floor(d * scale)
        f = float(np.float32((d + 1) - (s + 1) * inv))
        f = 0.0 if f <= 0 else f - math.floor(f)
        if s < 0:
            s, f = 0, 0.0
        if s >= n_in - 1:
            s, f = n_in - 1, 0.0
        w[d, s] += 1.0 - f
        if f:
            w[d, s + 1] += f
    return w


def _apply(img: np.ndarray, wh: np.ndarray, ww: np.ndarray) -> np.ndarray:
    x = np.asarray(img, np.float64)
    return np.einsum("oh,hwc,pw->opc", wh, x, ww, optimize=True).astype(np.float32)


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) float -> (height, width, C) float32, as
    ``cv2.resize(img, (width, height), interpolation=cv2.INTER_CUBIC)``."""
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return np.array(img, np.float32)
    return _apply(img, bicubic_weights(h, height), bicubic_weights(w, width))


def resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) float -> (height, width, C) float32, as
    ``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)``."""
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return np.array(img, np.float32)
    if height <= h and width <= w:
        return _apply(img, area_weights(h, height), area_weights(w, width))
    return _apply(img, area_linear_weights(h, height), area_linear_weights(w, width))


def resize_trilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(C, F, H, W) -> (C, *size), trilinear, for sizes that do not shrink
    (a shrinking axis would need JAX's antialiasing kernel)."""
    size = tuple(int(v) for v in size)
    if any(o < i for o, i in zip(size, x.shape[1:])):
        raise ValueError(f"resize_trilinear upsamples only: {tuple(x.shape[1:])} -> {size}")
    return F.interpolate(x[None], size=size, mode="trilinear", align_corners=False)[0]
