"""The rest of CogVideoX on the CPU, port vs JAX package: the int8 and fp8
DiT forwards from one numpy-quantized state dict, the device synthesizer's
quantized layouts, every XDPM schedule (one case per non-default value of
each schedule key), the schedule keys reaching the runner's scheduler from
its config, and the VAE encoder at the posterior mean and with injected
noise. Weights come from the host numpy state dicts that both packages build
identically; inputs from numpy seeds. The DiT runs at head dim 64, so the
port's attention runs the plain version of the 64-wide flash kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.models.cogvideox import model as jm
from lightx2v_tpu.schedulers.cogvideox import CogvideoxXDPMScheduler as JXDPM
from lightx2v_tpu.tools.convert import quantize_tensor
from lightx2v_tpu.utils.config import set_config as jset
from lightx2v_tpu.vae import cogvideox_vae as jv
from lightx2v_tpu_torch.models.cogvideox import config as tc
from lightx2v_tpu_torch.models.cogvideox import model as tm
from lightx2v_tpu_torch.models.cogvideox import weights as tw
from lightx2v_tpu_torch.schedulers.cogvideox import CogvideoxXDPMScheduler as TXDPM
from lightx2v_tpu_torch.utils.config import set_config as tset
from lightx2v_tpu_torch.vae import cogvideox_vae as tv

ARCH = dict(num_layers=2, num_heads=2, head_dim=64, text_len=16, text_dim=32, time_embed_dim=64)
VAE = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, latent_channels=4, norm_num_groups=4)
MM = {"int8": "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu",
      "fp8": "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Tpu"}
# params name -> state-dict key of each block linear
LINEARS = {"norm1_linear": "norm1.linear", "to_q": "attn1.to_q", "to_k": "attn1.to_k", "to_v": "attn1.to_v",
           "to_out": "attn1.to_out.0", "norm2_linear": "norm2.linear", "ff_0": "ff.net.0.proj", "ff_2": "ff.net.2"}


@pytest.fixture(autouse=True)
def _one_thread():
    """Thousands of small torch ops: one thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("scheme,bar", [("int8", 1e-2), ("fp8", 3e-2)])
def test_quantized_forward_vs_jax(scheme, bar):
    """``cog_forward(mm_type=...)`` at CFG's batch of 2 with every block
    linear (the AdaLN projections included) quantized by the JAX
    converter's ``quantize_tensor`` from one numpy dict, loaded into both
    packages (the JAX tree takes the stacked codes and scales in place of
    its bf16 weights); per-token activation codes on both sides. Bars:
    relative L2 on the fp32 prediction, the bf16 forward's 1e-2 for int8,
    3e-2 for fp8, which amplifies bf16 noise about three times as much as
    int8 (PERF.md)."""
    ja, ta = jm.CogArch(**ARCH), tc.CogArch(**ARCH)
    sd = jm.init_random_cog_state_dict(ja, seed=4, scale=0.05)
    qsd, jp = dict(sd), jm.load_cog_params(sd, ja)
    for name, key in LINEARS.items():
        keys = [f"transformer_blocks.{i}.{key}" for i in range(ja.num_layers)]
        for k in keys:
            qsd[f"{k}.weight"], qsd[f"{k}.weight_scale"] = quantize_tensor(sd[f"{k}.weight"], scheme)
        jp["blocks"][name]["w"] = jnp.asarray(np.stack([qsd[f"{k}.weight"] for k in keys]))
        jp["blocks"][name]["w_scale"] = jnp.asarray(np.stack([qsd[f"{k}.weight_scale"] for k in keys]))
    tp = tw.load_cog_params(qsd, ta)
    assert tp["blocks"][0]["ff_2"]["w"].dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[scheme]
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, 16, 3, 8, 8)).astype(np.float32)
    ctx = (rng.standard_normal((2, ARCH["text_len"], ARCH["text_dim"])) * 0.5).astype(np.float32)
    t = np.array([500.0, 500.0], np.float32)
    cos, sin = tc.build_cog_rope(ta, 2, 4, 4)
    fwd = jax.jit(lambda p, *a: jm.cog_forward(p, *a, arch=ja, mm_type=MM[scheme]))
    ref = np.asarray(fwd(jp, jnp.asarray(lat).astype(jnp.bfloat16), jnp.asarray(t), jnp.asarray(ctx),
                         jnp.asarray(cos), jnp.asarray(sin)), np.float32)
    out = tm.CogTransformer(tp, ta)(torch.from_numpy(lat).to(torch.bfloat16), torch.from_numpy(t),
                                    torch.from_numpy(ctx), torch.from_numpy(cos), torch.from_numpy(sin),
                                    mm_type=MM[scheme])
    assert out.shape == (2, 16, 3, 8, 8) and np.isfinite(ref).all()
    assert _rel(out.numpy(), ref) < bar, _rel(out.numpy(), ref)


def test_device_synthesizer_schemes():
    """``init_random_cog_params_on_device(scheme=...)``: every block linear
    int8 or e4m3 codes with (out,) scales, the embeddings and head bf16."""
    arch = tc.CogArch(**ARCH)
    for scheme, dtype in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        p = tw.init_random_cog_params_on_device(arch, scheme, seed=1, device="cpu")
        for lin in (p["blocks"][i][k] for i in range(arch.num_layers) for k in LINEARS):
            assert lin["w"].dtype == dtype and lin["w_scale"].shape == (lin["w"].shape[0],)
        assert p["proj_out"]["w"].dtype == torch.bfloat16 and "w_scale" not in p["text_proj"]
    with pytest.raises(ValueError, match="int4"):
        tw.init_random_cog_params_on_device(arch, "int4", device="cpu")


# one case per non-default value of each schedule key; epsilon prediction on
# an unrescaled schedule (zero terminal SNR makes its first x0 a division by 0)
SCHEDULES = [dict(scheduler_beta_start=0.0001), dict(scheduler_beta_end=0.02),
             dict(scheduler_snr_shift_scale=3.0), dict(scheduler_beta_schedule="linear"),
             dict(timestep_spacing="leading", steps_offset=1), dict(timestep_spacing="linspace"),
             dict(scheduler_prediction_type="epsilon", scheduler_rescale_betas_zero_snr=False),
             dict(scheduler_prediction_type="sample"), dict(scheduler_rescale_betas_zero_snr=False),
             dict(scheduler_set_alpha_to_one=False)]


@pytest.mark.parametrize("keys", SCHEDULES, ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_xdpm_schedule_vs_jax(keys):
    """A 10-step XDPM trajectory under each schedule: the same alphas, final
    alpha and timesteps as the JAX scheduler, then the same latents,
    predictions and re-noise draws (the JAX scheduler's own jax.random
    draws injected) through every step. Bar: fp32 elementwise order, 1e-5
    relative to the latents' magnitude (the 50-step trajectory test's)."""
    cfg = dict(infer_steps=10, latent_init="torch", **keys)
    js, ts = JXDPM(jset(dict(cfg))), TXDPM(tset(dict(cfg)))
    np.testing.assert_array_equal(ts.alphas_cumprod, js.alphas_cumprod)
    np.testing.assert_array_equal(ts._ts_int, js._ts_int)
    assert ts.final_alpha_cumprod == js.final_alpha_cumprod and ts.prediction_type == js.prediction_type
    shape = (16, 2, 4, 6)
    jst = js.prepare(shape, 7)
    tst = ts.prepare(shape, torch.Generator().manual_seed(7))
    rng = np.random.default_rng(3)
    step = js.step_post  # eager: ten steps dispatch faster than a compile
    for _ in range(10):
        pred = rng.standard_normal(shape).astype(np.float32)
        _, key = jax.random.split(jst["rng"])
        noise = np.array(jax.random.normal(key, shape, jnp.float32))
        jst = step(jst, jnp.asarray(pred))
        tst = ts.step_post(tst, torch.from_numpy(pred), noise=torch.from_numpy(noise))
    ref = np.asarray(jst["latents"])
    assert np.isfinite(ref).all() and tst["step_index"] == 10
    np.testing.assert_allclose(tst["latents"].numpy(), ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


def test_runner_passes_schedule_keys():
    """The runner builds its scheduler from its config: a schedule key given
    to ``init_runner`` reaches the XDPM scheduler, whose schedule is the JAX
    scheduler's for the same keys."""
    from lightx2v_tpu_torch import infer as tinfer

    keys = dict(timestep_spacing="leading", scheduler_prediction_type="sample", scheduler_snr_shift_scale=2.0)
    runner = tinfer.init_runner(tset(dict(model_cls="cogvideox", task="t2v", synthetic_weights=True, device="cpu",
                                          infer_steps=4, target_video_length=5, target_height=32, target_width=32,
                                          **keys)))
    sched = runner.init_scheduler()
    ref = JXDPM(jset(dict(infer_steps=4, **keys)))
    assert sched.prediction_type == "sample"
    np.testing.assert_array_equal(sched._ts_int, ref._ts_int)
    np.testing.assert_array_equal(sched.alphas_cumprod, ref.alphas_cumprod)


@pytest.mark.parametrize("noise", [False, True])
def test_vae_encode_vs_jax(noise):
    """``cog_vae_encode`` of 5 frames of 32 x 48 (two first-frame-keeping
    temporal pools, three stride-2 downsamples) -> 2 x 4 x 6 latents,
    scaled, at the posterior mean and with noise injected: the JAX sample
    key's normal draws passed to the port. Bar: fp32 convolutions in
    another order, relative L2 1e-4 (the decoder's)."""
    sd = jv.init_random_cog_vae_state_dict(jv.CogVAEConfig(**VAE), seed=0)
    cfg_j, cfg_t = jv.CogVAEConfig(**VAE), tv.CogVAEConfig(**VAE)
    x = np.random.default_rng(2).uniform(-1, 1, (1, 5, 32, 48, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4) if noise else None
    ref = np.asarray(jax.jit(lambda p, x_: jv.cog_vae_encode(p, x_, cfg_j, rng=key))(
        jv.load_cog_vae_params(sd, cfg_j), jnp.asarray(x)))
    eps = torch.from_numpy(np.array(jax.random.normal(key, ref.shape, jnp.float32))) if noise else None
    tp = tv.load_cog_vae_params(sd, cfg_t, encoder=True)
    out = tv.cog_vae_encode(tp, torch.from_numpy(x), cfg_t, noise=eps)
    assert out.shape == ref.shape == (1, 2, 4, 6, 4)
    assert _rel(out.numpy(), ref) < 1e-4, _rel(out.numpy(), ref)
    if noise:  # the sample moved off the mean by the noise
        assert _rel(out.numpy(), tv.cog_vae_encode(tp, torch.from_numpy(x), cfg_t).numpy()) > 1e-3
