"""Changing resolution on the CPU, port vs JAX package: the trilinear resize
against ``jax.image.resize``, and the ``wan2.1`` runner's two-phase denoise
(``configs/changing_resolution/wan_t2v.json``'s keys at a tiny size)
against the JAX runner, with the JAX re-noise draw injected.

Resize bar: max |port - JAX| <= 1e-6 max |JAX| (the same half-pixel taps
with weights rounded in another order; measured 1.5e-7).

Runner: dim 256, ffn 512, 2 heads of 128, 2 layers, bf16 linears, 9 frames
of 64x96 (latents 16x3x8x12; 16x3x6x8 at rate 0.75), 6 UniPC steps switching
at step 3, CFG at scale 6 as one batch-2 forward, the same host weights, the
initial latents from one CPU torch stream (``latent_init: "torch"``) and
``jax.random.normal(PRNGKey(seed + 101))`` as the re-noise on both sides.
Bar: relative L2 5e-2 on the latents and the frames, the CFG runner's
(``test_torch_cfg.py``), which carries the guidance's 6x of its rows'
differences through six steps and the switch (measured 8.2e-3 and 6.5e-4;
the prompts' tokens, and so the error, move with the process's hash seed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu_torch.utils.image import resize_trilinear

CFG = dict(model_cls="wan2.1", task="t2v", synthetic_weights=True, prompt="a red panda climbing",
           negative_prompt="blurry low quality", seed=42, enable_cfg=True, sample_guide_scale=6,
           infer_steps=6, target_video_length=9, target_height=64, target_width=96, sample_shift=8,
           rope_fused=True, latent_init="torch", text_len=64, self_attn_1_type="flash_attn3",
           cross_attn_1_type="flash_attn3", changing_resolution=True, resolution_rate=0.75,
           changing_resolution_steps=3, dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)
TARGET = (16, 3, 8, 12)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small ops: one torch thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("src,dst", [((16, 3, 6, 8), (3, 8, 12)), ((2, 21, 44, 78), (21, 60, 104)),
                                     ((3, 5, 7, 9), (6, 11, 13)), ((4, 2, 3, 3), (2, 3, 3))])
def test_trilinear_resize_vs_jax(src, dst):
    """The test runner's resize, the config's (16, 21, 44, 78) -> 60 x 104
    at 2 channels, every axis growing by a non-integer factor, and the
    identity."""
    x = np.random.default_rng(sum(src)).standard_normal(src).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (src[0], *dst), method="trilinear"))
    out = resize_trilinear(torch.from_numpy(x), dst).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


def test_trilinear_resize_refuses_shrinking():
    with pytest.raises(ValueError, match="upsamples only"):
        resize_trilinear(torch.zeros((1, 3, 8, 8)), (3, 6, 8))


@pytest.fixture(scope="module")
def runs():
    from lightx2v_tpu.runners.wan_runner import WanRunner as JRunner
    from lightx2v_tpu.utils.config import set_config as jset
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    jr = JRunner(jset(dict(CFG)))
    tr = tinfer.init_runner(tset(dict(CFG, device="cpu")))
    j_enc, t_enc = jr.run_input_encoder(), tr.run_input_encoder()
    renoise = np.array(jax.random.normal(jax.random.PRNGKey(CFG["seed"] + 101), TARGET, jnp.float32))
    j_lat = jr.run_dit(j_enc)
    t_lat = tr.run_dit(t_enc, renoise=torch.from_numpy(renoise))
    return dict(jr=jr, tr=tr, j_lat=j_lat, t_lat=t_lat, j_frames=jr.run_vae_decoder(j_lat),
                t_frames=tr.run_vae_decoder(t_lat))


def test_runner_denoise_vs_jax(runs):
    tr = runs["tr"]
    assert tr.timings["step_index"] == list(range(6)) and len(tr.timings["step_s"]) == 6
    assert tr.timings["calc_steps"] == [True] * 6
    # phase B's scheduler: shift 8 + 2, restarted at step 4
    assert tr.scheduler.sample_shift == 8 and tr.scheduler.corr_order[4] == 0 and tr.scheduler.corr_order[5] > 0
    j, t = np.asarray(runs["j_lat"]), runs["t_lat"].numpy()
    assert t.shape == j.shape == TARGET and np.isfinite(t).all()
    assert _rel(t, j) < 5e-2, _rel(t, j)


def test_runner_decode_vs_jax(runs):
    j, t = runs["j_frames"], runs["t_frames"]
    assert t.shape == j.shape == (9, 64, 96, 3) and np.isfinite(t).all()
    assert _rel(t, j) < 5e-2, _rel(t, j)


@pytest.mark.parametrize("window", [(2, 3), (0, 4)])
def test_step_window_crosses_the_switch(runs, window):
    """A window holding step k runs its phase-A steps, the step-k forward and
    its phase-B steps, each at the file's index; a window without k is
    refused."""
    tr = runs["tr"]
    tr.step_window = window
    try:
        lat = tr.run_dit(tr.run_input_encoder())
        first, count = window
        assert tr.timings["step_index"] == list(range(first, first + count))
        assert len(tr.timings["step_s"]) == len(tr.timings["calc_steps"]) == count
        assert lat.shape == TARGET and torch.isfinite(lat).all()
        tr.step_window = (4, 2)
        with pytest.raises(ValueError, match="must hold step 3"):
            tr.run_dit(tr.run_input_encoder())
    finally:
        tr.step_window = None
