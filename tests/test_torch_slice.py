"""The whole slice on the CPU, port vs JAX package: the runners' stages
(T5 encode -> 4-step distill denoise -> tiled VAE decode) with synthetic
weights that both packages build from the same host numpy dicts.

Both runners draw the initial latents from the same CPU torch stream
(``latent_init: "torch"``), and the port's re-noise draws are replaced by
the JAX scheduler's own (``jax.random`` keys from seed + 1), so the two
runs see the same inputs. Tiny arch: dim 256, ffn 512, 2 heads of 128,
2 layers, latents 16x5x20x20 (17 frames of 160x160), rope_fused, bf16
linears (the JAX synthetic runner cannot build int8 weights). Bar: relative
L2 1e-2 on the context, the latents and the frames (measured: 5e-3 on the
bf16 context, 2e-3 on the latents after the 4 steps, 1e-4 on the frames)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

CFG = dict(model_cls="wan2.1_distill", task="t2v", synthetic_weights=True, prompt="a red panda climbing",
           seed=42, enable_cfg=False, target_video_length=17, target_height=160, target_width=160,
           sample_shift=5, rope_fused=True, use_tiling_vae=True, latent_init="torch",
           denoising_step_list=[1000, 750, 500, 250], dim=256, ffn_dim=512, num_heads=2, num_layers=2,
           text_dim=256, text_len=512, self_attn_1_type="flash_attn3", cross_attn_1_type="flash_attn3")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def runs():
    from lightx2v_tpu.runners.wan_runner import WanDistillRunner as JRunner
    from lightx2v_tpu.utils.config import set_config as jset
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    jr = JRunner(jset(dict(CFG)))
    tr = tinfer.init_runner(tset(dict(CFG, device="cpu")))
    j_enc, t_enc = jr.run_input_encoder(), tr.run_input_encoder()

    j_lat = jr.run_dit(j_enc)
    shape = tuple(tr.set_target_shape())
    rng, noises = jax.random.PRNGKey(CFG["seed"] + 1), []
    for _ in range(4):
        rng, sub = jax.random.split(rng)
        noises.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    t_lat = tr.run_dit(t_enc, noises=noises)
    return dict(jr=jr, tr=tr, j_enc=j_enc, t_enc=t_enc, j_lat=j_lat, t_lat=t_lat,
                j_frames=jr.run_vae_decoder(j_lat), t_frames=tr.run_vae_decoder(t_lat))


def test_encode_stage(runs):
    j = np.asarray(runs["j_enc"]["text_encoder_output"]["context"], np.float32)
    t = runs["t_enc"]["text_encoder_output"]["context"].float().numpy()
    assert t.shape == j.shape == (1, 512, 256)
    assert _rel(t, j) < 1e-2


def test_denoise_stage(runs):
    j, t = np.asarray(runs["j_lat"]), runs["t_lat"].numpy()
    assert t.shape == j.shape == (16, 5, 20, 20) and np.isfinite(t).all()
    assert _rel(t, j) < 1e-2, _rel(t, j)


def test_decode_stage(runs):
    j, t = runs["j_frames"], runs["t_frames"]
    assert t.shape == j.shape == (17, 160, 160, 3) and t.dtype == np.float32
    assert np.isfinite(t).all() and t.min() >= -1.0 and t.max() <= 1.0
    assert _rel(t, j) < 1e-2, _rel(t, j)


def test_release_modules_and_rerun():
    """With release_modules the T5 is dropped before the denoise and the
    DiT before the decode; a second run reloads them."""
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    cfg = dict(CFG, device="cpu", release_modules=True, target_video_length=5, target_height=64,
               target_width=64, denoising_step_list=[1000, 500])
    r = tinfer.init_runner(tset(cfg))
    f1 = r.run_pipeline(save_video=False)
    assert r.text_encoder is None and r.model is None
    f2 = r.run_pipeline(save_video=False)
    assert f1.shape == (5, 64, 64, 3) and len(r.timings["step_s"]) == 2
    np.testing.assert_array_equal(f1, f2)
