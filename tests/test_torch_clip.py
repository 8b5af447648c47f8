"""Port CLIP vision tower and image resizes vs the JAX package on its CPU
path (and vs OpenCV, which the JAX package resizes with).

The tower: the JAX test's tiny arch (28 px images, 14 px patches, dim 64, 4
heads, 2 of 3 blocks), from one numpy state dict, bf16 activations on both
sides. Bar: relative L2 1e-2 on the tokens, dense and int8 (bf16 rounding
of every block output; measured 2.0e-3 dense, 3.5e-3 int8).

The resizes are pinned against ``cv2.resize`` (which the card machine need
not have) on float32 images in [-1, 1], bars a little above the measured
maximum differences: INTER_CUBIC 480x832 -> 224x224 measured 3.1e-7 (bar
1e-6), and CLIP's preprocessing against the JAX package's 7.2e-7 (bar
2e-6); INTER_AREA shrinking by a fraction measured 1.2e-7 and by an
integer 6.0e-8, growing 1.2e-7, the same size 0 (bar 5e-7 each): float32
sums in another order."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.encoders import clip as jclip
from lightx2v_tpu_torch.encoders import clip as tclip
from lightx2v_tpu_torch.utils import image as timage

TINY = dict(image_size=28, patch_size=14, dim=64, mlp_ratio=2, num_heads=4, num_layers=3, use_blocks=2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def clip_sd():
    sd = jclip.init_random_clip_state_dict(jclip.ClipVisionArch(**TINY), seed=0, scale=0.05)
    tsd = tclip.init_random_clip_state_dict(tclip.ClipVisionArch(**TINY), seed=0, scale=0.05)
    assert sd.keys() == tsd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], tsd[k])
    return sd


@pytest.mark.parametrize("scheme", [None, "int8"])
def test_clip_tower_matches_jax(clip_sd, scheme):
    ja, ta = jclip.ClipVisionArch(**TINY), tclip.ClipVisionArch(**TINY)
    jp, tp = jclip.load_clip_vision_params(clip_sd, ja), tclip.load_clip_vision_params(clip_sd, ta)
    if scheme:
        jp, tp = jclip.quantize_clip_params(jp, scheme), tclip.quantize_clip_params(tp, scheme)
        assert tp["blocks"][1]["fc2_w"]["w"].dtype == torch.int8
    px = np.random.default_rng(1).standard_normal((2, 28, 28, 3)).astype(np.float32)
    ref = np.asarray(jclip.clip_vision_forward(jp, jnp.asarray(px), ja), np.float32)
    out = tclip.clip_vision_forward(tp, torch.from_numpy(px), ta)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape == (2, 5, 64)
    assert _rel(out.float().numpy(), ref) < 1e-2, _rel(out.float().numpy(), ref)


def test_clip_model_infer_and_device_synthesizer():
    """``CLIPVisionModel.infer`` preprocesses and runs the tower; the
    device synthesizer gives ``load_clip_vision_params``'s layout."""
    arch = tclip.ClipVisionArch(**TINY)
    params = tclip.init_random_clip_params_on_device(arch, seed=3, device="cpu")
    ref = tclip.load_clip_vision_params(tclip.init_random_clip_state_dict(arch), arch)
    flat = lambda p: {k: (v.shape, v.dtype) for k, v in p.items() if isinstance(v, torch.Tensor)}  # noqa: E731
    assert flat(params) == flat(ref) and len(params["blocks"]) == arch.use_blocks
    assert flat(params["blocks"][0]) == flat(ref["blocks"][0])
    img = np.random.default_rng(2).uniform(-1, 1, (64, 48, 3)).astype(np.float32)
    out = tclip.CLIPVisionModel(arch, params=params).infer(img)
    want = tclip.clip_vision_forward(params, torch.from_numpy(tclip.preprocess_image(img, 28)), arch)
    assert out.shape == (1, 5, 64) and torch.equal(out, want)
    with pytest.raises(NotImplementedError):
        tclip.CLIPVisionModel(arch)


def test_preprocess_image_matches_jax():
    """CLIP's bicubic resize and normalization (the JAX package's runs cv2)."""
    img = np.random.default_rng(3).uniform(-1, 1, (64, 48, 3)).astype(np.float32)
    np.testing.assert_allclose(tclip.preprocess_image(img, 28), jclip.preprocess_image(img, 28), rtol=0, atol=2e-6)
    gray = tclip.preprocess_image(np.zeros((64, 48, 3), np.float32), 28)
    np.testing.assert_allclose(gray[0, 0, 0], (0.5 - tclip.CLIP_MEAN) / tclip.CLIP_STD, rtol=1e-6)


def test_bicubic_resize_matches_cv2():
    img = np.random.default_rng(4).uniform(-1, 1, (480, 832, 3)).astype(np.float32)
    ref = cv2.resize(img, (224, 224), interpolation=cv2.INTER_CUBIC)
    out = timage.resize_bicubic(img, 224, 224)
    assert out.shape == (224, 224, 3) and out.dtype == np.float32
    assert np.abs(out - ref).max() < 1e-6


@pytest.mark.parametrize("hw", [(48, 80), (32, 48), (100, 150), (30, 200), (64, 96)])
def test_area_resize_matches_cv2(hw):
    """From 64x96: shrinking by a fraction and by an integer (cv2's fast
    path), growing, growing along one axis only, and the same size."""
    img = np.random.default_rng(5).uniform(-1, 1, (64, 96, 3)).astype(np.float32)
    ref = cv2.resize(img, hw[::-1], interpolation=cv2.INTER_AREA)
    out = timage.resize_area(img, *hw)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 5e-7
