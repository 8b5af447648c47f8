"""The CogVideoX text-to-video slice on the CPU, port vs JAX package: the 3D
RoPE tables, the joint-stream DiT forward (CFG's batch of 2), the XDPM
trajectory, the VAE decode (whole, frame-batched at odd T, tiled with edge
tiles), the T5 v1.1 encoder (one bias table shared by every layer) and the
small synthetic runner end to end. Weights come from the host numpy state
dicts that both packages build identically; inputs from numpy seeds.

The DiT runs at head dim 64 (2 heads, 2 layers, text_len 16), the width of
CogVideoX1.5-5B's 48 heads, so the port's attention runs the plain version
of the 64-wide flash kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.encoders import t5 as jt5
from lightx2v_tpu.models.cogvideox import model as jm
from lightx2v_tpu.schedulers.cogvideox import CogvideoxXDPMScheduler as JXDPM
from lightx2v_tpu.utils.config import set_config as jset
from lightx2v_tpu.vae import cogvideox_vae as jv
from lightx2v_tpu_torch.encoders import t5 as tt5
from lightx2v_tpu_torch.models.cogvideox import config as tc
from lightx2v_tpu_torch.models.cogvideox import model as tm
from lightx2v_tpu_torch.models.cogvideox import weights as tw
from lightx2v_tpu_torch.schedulers.cogvideox import CogvideoxXDPMScheduler as TXDPM
from lightx2v_tpu_torch.utils.config import set_config as tset
from lightx2v_tpu_torch.vae import cogvideox_vae as tv

ARCH = dict(num_layers=2, num_heads=2, head_dim=64, text_len=16, text_dim=32, time_embed_dim=64)
VAE = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, latent_channels=4, norm_num_groups=4)


@pytest.fixture(autouse=True)
def _one_thread():
    """The VAE and the runner are thousands of small torch ops: one thread,
    so that parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def test_state_dicts_and_rope_match_jax():
    """The host state dicts (DiT and VAE) and the RoPE tables are the JAX
    package's, value for value."""
    jsd = jm.init_random_cog_state_dict(jm.CogArch(**ARCH), seed=4, scale=0.05)
    tsd = tw.init_random_cog_state_dict(tc.CogArch(**ARCH), seed=4, scale=0.05)
    assert set(jsd) == set(tsd)
    for k in jsd:
        np.testing.assert_array_equal(tsd[k], np.asarray(jsd[k], np.float32), err_msg=k)
    jvsd = jv.init_random_cog_vae_state_dict(jv.CogVAEConfig(**VAE), seed=0)
    tvsd = tv.init_random_cog_vae_state_dict(tv.CogVAEConfig(**VAE), seed=0)
    assert set(jvsd) == set(tvsd) and all(np.array_equal(jvsd[k], tvsd[k]) for k in jvsd)
    for grid in ((2, 4, 4), (11, 3, 5)):
        for a, b in zip(tc.build_cog_rope(tc.CogArch(**ARCH), *grid), jm.build_cog_rope(jm.CogArch(**ARCH), *grid)):
            assert a.shape == (int(np.prod(grid)), 32)
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def dit():
    jsd = jm.init_random_cog_state_dict(jm.CogArch(**ARCH), seed=4, scale=0.05)
    ja, ta = jm.CogArch(**ARCH), tc.CogArch(**ARCH)
    return ja, ta, jm.load_cog_params(jsd, ja), tw.load_cog_params(jsd, ta)


@pytest.mark.parametrize("frames", [3, 4])
def test_forward_batch2_vs_jax(dit, frames):
    """cog_forward at batch 2 (CFG's cond and uncond rows, two contexts),
    with an odd latent frame count (padded to p_t = 2 and cut back) and an
    even one. Bar: relative L2 1e-2 (bf16 activations; the JAX CPU path's
    flash_attn3 is an fp32 chunked softmax, the port's the 64-wide kernel's
    plain version with q and P rounded to bf16; measured 1.4e-3)."""
    ja, ta, jp, tp = dit
    rng = np.random.default_rng(frames)
    lat = rng.standard_normal((2, 16, frames, 8, 8)).astype(np.float32)
    ctx = (rng.standard_normal((2, ARCH["text_len"], ARCH["text_dim"])) * 0.5).astype(np.float32)
    t = np.array([500.0, 500.0], np.float32)
    cos, sin = tc.build_cog_rope(ta, (frames + 1) // 2, 4, 4)
    fwd = jax.jit(lambda p, *a: jm.cog_forward(p, *a, arch=ja))
    ref = np.asarray(fwd(jp, jnp.asarray(lat).astype(jnp.bfloat16), jnp.asarray(t), jnp.asarray(ctx),
                         jnp.asarray(cos), jnp.asarray(sin)), np.float32)
    out = tm.CogTransformer(tp, ta)(torch.from_numpy(lat).to(torch.bfloat16), torch.from_numpy(t),
                                    torch.from_numpy(ctx), torch.from_numpy(cos), torch.from_numpy(sin))
    assert out.shape == (2, 16, frames, 8, 8) and out.dtype == torch.float32
    assert _rel(out.numpy(), ref) < 1e-2, _rel(out.numpy(), ref)


def test_xdpm_trajectory_vs_jax():
    """configs/cogvideox_t2v.json's schedule (50 trailing steps, v-prediction,
    zero-terminal SNR): the same latents, v-predictions and re-noise draws
    (the JAX scheduler's own jax.random draws injected) through every step,
    the first-order first step, the second-order steps and the last step's
    prev_t < 0 branch. Bar: fp32 elementwise order, 1e-5 (measured 1.9e-6
    max abs after the 50 steps)."""
    cfg = dict(infer_steps=50, scheduler_prediction_type="v_prediction", scheduler_rescale_betas_zero_snr=True,
               timestep_spacing="trailing", latent_init="torch")
    js, ts = JXDPM(jset(dict(cfg))), TXDPM(tset(dict(cfg)))
    np.testing.assert_array_equal(ts._ts_int, js._ts_int)
    assert ts._ts_int[-1] - 1000 // 50 < 0  # the last step takes the prev_t < 0 branch
    shape = (16, 3, 4, 6)
    jst = js.prepare(shape, 7)
    tst = ts.prepare(shape, torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(tst["latents"].numpy(), np.asarray(jst["latents"]))
    rng = np.random.default_rng(3)
    step = jax.jit(js.step_post)
    for _ in range(50):
        pred = rng.standard_normal(shape).astype(np.float32)
        _, key = jax.random.split(jst["rng"])
        noise = np.array(jax.random.normal(key, shape, jnp.float32))
        jst = step(jst, jnp.asarray(pred))
        tst = ts.step_post(tst, torch.from_numpy(pred), noise=torch.from_numpy(noise))
    ref = np.asarray(jst["latents"])
    assert np.isfinite(ref).all() and tst["step_index"] == 50
    np.testing.assert_allclose(tst["latents"].numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key,value", [("scheduler_beta_start", 0.0001), ("scheduler_beta_end", 0.02),
                                       ("scheduler_snr_shift_scale", 3.0), ("scheduler_beta_schedule", "linear"),
                                       ("timestep_spacing", "leading"), ("scheduler_prediction_type", "epsilon"),
                                       ("scheduler_rescale_betas_zero_snr", False),
                                       ("scheduler_set_alpha_to_one", False)])
def test_xdpm_refuses_other_schedules(key, value):
    """The port fixes CogVideoX1.5-5B's schedule: every other value of a
    schedule key, which the JAX scheduler takes, raises; the config's own
    values build the same alphas as the JAX scheduler's."""
    JXDPM(jset(dict(infer_steps=50, **{key: value})))
    with pytest.raises(NotImplementedError, match=key):
        TXDPM(tset(dict(infer_steps=50, **{key: value})))
    np.testing.assert_array_equal(TXDPM(tset(dict(infer_steps=50))).alphas_cumprod,
                                  JXDPM(jset(dict(infer_steps=50))).alphas_cumprod)


def test_nearest_resize_is_jax_half_pixel():
    """The spatial norm's nearest resize samples at half-pixel centres as
    jax.image.resize does; F.interpolate's "nearest" differs at a
    non-integer factor (5 -> 7), so the port does not use it."""
    x = torch.arange(5, dtype=torch.float32).reshape(1, 1, 5, 1, 1)
    ours = tv._resize_nearest(x, (7, 1, 1)).flatten()
    ref = np.asarray(jax.image.resize(jnp.arange(5, dtype=jnp.float32), (7,), "nearest"))
    np.testing.assert_array_equal(ours.numpy(), ref)
    legacy = torch.nn.functional.interpolate(x, size=(7, 1, 1), mode="nearest").flatten()
    assert not torch.equal(legacy, ours)


@pytest.fixture(scope="module")
def vae():
    sd = jv.init_random_cog_vae_state_dict(jv.CogVAEConfig(**VAE), seed=0)
    cfg_j, cfg_t = jv.CogVAEConfig(**VAE), tv.CogVAEConfig(**VAE)
    return cfg_j, cfg_t, jv.load_cog_vae_params(sd, cfg_j), tv.load_cog_vae_params(sd, cfg_t)


@pytest.mark.parametrize("mode", ["whole", "chunked", "tiled"])
def test_vae_decode_vs_jax(vae, mode):
    """whole: 3 latent frames (odd T: the first frame resized and upsampled
    apart), scaled; chunked: 5 latent frames in chunks [3, 2] with the conv
    caches carried; tiled: 6 x 14 latents in 8-wide tiles (6 x 8 and an
    edge tile 6 x 2), each frame-batched. Bar: fp32 convolutions in another
    order, relative L2 1e-4 (measured ~1e-6)."""
    cfg_j, cfg_t, jp, tp = vae
    shape = {"whole": (1, 3, 4, 4, 4), "chunked": (1, 5, 6, 8, 4), "tiled": (1, 3, 6, 14, 4)}[mode]
    z = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    if mode == "whole":
        ref = jax.jit(lambda p, z_: jv.cog_vae_decode(p, z_, cfg_j, scale=True))(jp, jnp.asarray(z))
        out = tv.cog_vae_decode(tp, torch.from_numpy(z), cfg_t, scale=True)
    elif mode == "chunked":
        ref = jv.cog_vae_decode_chunked(jp, jnp.asarray(z), cfg_j, scale=False)
        out = tv.cog_vae_decode_chunked(tp, torch.from_numpy(z), cfg_t, scale=False)
    else:
        ref = jv.cog_vae_decode_tiled(jp, jnp.asarray(z), cfg_j, scale=False, tile_latent=8, frame_batch=2)
        out = tv.cog_vae_decode_tiled(tp, torch.from_numpy(z), cfg_t, scale=False, tile_latent=8)
    ref = np.asarray(ref)
    frames = 4 * (shape[1] - 1) + 1
    assert out.shape == ref.shape == (1, frames, 8 * shape[2], 8 * shape[3], 3)
    assert _rel(out.numpy(), ref) < 1e-4, _rel(out.numpy(), ref)


def test_t5_v1_1_shared_pos_vs_jax():
    """A small T5 v1.1 (one relative bias table read by every layer) from
    the JAX package's state dict, on two prompts with padding. Bar: relative
    L2 1e-2 on the bf16 context (the UMT5 bar of tests/test_torch_t5_vae.py);
    rows past each prompt stay zero."""
    cfg_kw = dict(vocab_size=256, dim=64, dim_attn=64, dim_ffn=128, num_heads=4, num_layers=2, shared_pos=True)
    jcfg, tcfg = jt5.T5Config(**cfg_kw), tt5.T5Config(**cfg_kw)
    sd = jt5.init_random_t5_state_dict(jcfg, seed=1)
    assert "pos_embedding.embedding.weight" in sd and "blocks.0.pos_embedding.embedding.weight" not in sd
    tp = tt5.load_t5_params(tt5.init_random_t5_state_dict(tcfg, seed=1), tcfg)
    ids = np.zeros((2, 12), np.int32)
    mask = np.zeros((2, 12), np.int32)
    ids[0, :7], mask[0, :7] = np.arange(2, 9), 1
    ids[1, :12], mask[1, :12] = np.arange(100, 112), 1
    ref = np.asarray(jt5.t5_encode(jt5.load_t5_params(sd, jcfg), jnp.asarray(ids), jnp.asarray(mask), jcfg),
                     np.float32)
    out = tt5.t5_encode(tp, torch.from_numpy(ids), torch.from_numpy(mask), tcfg)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 12, 64)
    assert not out[0, 7:].any()
    assert _rel(out.float().numpy(), ref) < 1e-2, _rel(out.float().numpy(), ref)
    # the device synthesizer shares the one table across blocks, as a checkpoint loads
    dp = tt5.init_random_t5_params_on_device(tcfg, seed=1, device="cpu")
    assert all(b["rel_emb"] is dp["blocks"][0]["rel_emb"] for b in dp["blocks"])
    assert tt5.T5_V1_1_XXL.shared_pos and tt5.T5_V1_1_XXL.vocab_size == 32128


CFG = dict(model_cls="cogvideox", task="t2v", synthetic_weights=True, prompt="a red panda climbing", seed=42,
           target_video_length=9, target_height=64, target_width=48, infer_steps=3, latent_init="torch",
           guidance_scale=6.0, enable_cfg=True, attention_type="flash_attn3")


def test_small_synthetic_runner_vs_jax():
    """The JAX runner's small synthetic mode on both packages in one process
    (the random context draws from Python's salted hash of the prompt):
    context from the prompt, 3 XDPM steps with CFG at batch 2 (the JAX
    re-noise draws injected into the port): first order, second order, and
    the last step's prev_t < 0 branch; then the frame-batched decode of 3
    latent frames. Bars: relative L2 3e-2 on the latents and the frames:
    the bf16 DiT's noise of the forward test, which guidance at scale 6
    multiplies with the cond - uncond difference (measured over six hash
    seeds: 1.2-1.3e-2 on the latents, 1.8-2.0e-2 on the frames; at scale 1
    the latents' error falls to 2.1e-3, with the port's flash or its plain
    fp32 attention alike)."""
    from lightx2v_tpu.runners.cogvideox_runner import CogvideoxRunner as JRunner
    from lightx2v_tpu_torch import infer as tinfer

    jr = JRunner(jset(dict(CFG)))
    tr = tinfer.init_runner(tset(dict(CFG, device="cpu")))
    assert tr.arch.head_dim == jr.arch.head_dim == 32 and tr.text_encoder is None
    j_enc, t_enc = jr.run_input_encoder(), tr.run_input_encoder()
    for key in ("context", "context_null"):
        np.testing.assert_array_equal(t_enc["text_encoder_output"][key].numpy(),
                                      np.asarray(j_enc["text_encoder_output"][key]))
    j_lat = jr.run_dit(j_enc)
    shape = tuple(tr.set_target_shape())
    assert shape == (16, 3, 8, 6)
    rng, noises = jax.random.PRNGKey(CFG["seed"] + 3), []
    for _ in range(CFG["infer_steps"]):
        rng, sub = jax.random.split(rng)
        noises.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    t_lat = tr.run_dit(t_enc, noises=noises)
    assert len(tr.timings["step_s"]) == 3
    assert _rel(t_lat.numpy(), np.asarray(j_lat)) < 3e-2, _rel(t_lat.numpy(), np.asarray(j_lat))
    j_frames, t_frames = jr.run_vae_decoder(j_lat), tr.run_vae_decoder(t_lat)
    assert t_frames.shape == j_frames.shape == (9, 64, 48, 3) and np.isfinite(t_frames).all()
    assert _rel(t_frames, j_frames) < 3e-2, _rel(t_frames, j_frames)
