"""The base model path on the CPU, port vs JAX package: one classifier-free
guidance forward (batch 2: cond, uncond), and the whole ``wan2.1`` runner
(UniPC, 3 steps, CFG at scale 5) stage by stage with synthetic weights
that both packages build from the same host numpy dicts.

Tiny arch: dim 256, ffn 512, 2 heads of 128, 2 layers, latents 16x5x20x20
(17 frames of 160x160), rope_fused, bf16 linears (the JAX synthetic runner
builds no quantized weights). Both runners draw the initial latents from the
same CPU torch stream (``latent_init: "torch"``); UniPC draws no other
noise. Bars: relative L2 1e-2 for each row of the batch-2 forward (as the
non-CFG forward; measured ~5e-3). The combined output
uncond + 5 * (cond - uncond) carries 5x the cond row's and 4x the uncond
row's bf16 differences, so its bar is 5e-2 (measured 2.6e-2); the runner's
latents after three such UniPC steps and its frames get the same 5e-2, its
contexts 1e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.models.wan import config as jcfg
from lightx2v_tpu.models.wan import model as jmodel
from lightx2v_tpu.models.wan import weights as jweights
from lightx2v_tpu.models.wan.pipeline import rope_for_shape as j_rope_for_shape
from lightx2v_tpu_torch.models.wan import config as tcfg
from lightx2v_tpu_torch.models.wan import model as tmodel
from lightx2v_tpu_torch.models.wan import weights as tweights
from lightx2v_tpu_torch.models.wan.pipeline import make_denoise_fn
from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape as t_rope_for_shape

TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)
SHAPE = (16, 5, 20, 20)
CFG = dict(model_cls="wan2.1", task="t2v", synthetic_weights=True, prompt="a red panda climbing",
           negative_prompt="blurry low quality", seed=42, enable_cfg=True, sample_guide_scale=5,
           infer_steps=3, target_video_length=17, target_height=160, target_width=160, sample_shift=5,
           rope_fused=True, latent_init="torch", text_len=64, self_attn_1_type="flash_attn3",
           cross_attn_1_type="flash_attn3", **TINY)


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


@pytest.mark.parametrize("self_attn", ["flash_attn3", "sage_attn2"])
def test_cfg_forward_matches_jax(self_attn):
    """sage_attn2 on the JAX CPU path is dense attention, so the port's int8
    QK noise shows: its rows' bar is 2e-2 and the combined output's 1e-1."""
    wd = jweights.init_random_weight_dict(jcfg.WanArch(**TINY), seed=0)
    jarch, tarch = jcfg.WanArch(**TINY, rope_fused=True), tcfg.WanArch(**TINY, rope_fused=True)
    jp = jweights.permute_qk_half(jweights.load_wan_params(wd, jarch), jarch)
    tp = tweights.permute_qk_half(tweights.load_wan_params(wd, tarch), tarch)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, *SHAPE)).astype(np.float32)
    ctx, ctx_null = ((rng.standard_normal((1, 64, 256)) * 0.5).astype(np.float32) for _ in range(2))
    ctx[:, 40:] = 0.0
    ctx_null[:, 5:] = 0.0
    t = np.array([750.0], np.float32)
    jc, js, _ = j_rope_for_shape(jarch, SHAPE)
    tc, ts, _ = t_rope_for_shape(tarch, SHAPE)
    ref = jmodel.wan_forward_cfg(jp, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx, jnp.bfloat16),
                                 jnp.asarray(ctx_null, jnp.bfloat16), 5.0, jc, js, jarch, self_attn_type=self_attn)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    out = tmodel.wan_forward_cfg(tp, torch.from_numpy(lat), torch.from_numpy(t), tb(ctx), tb(ctx_null), 5.0,
                                 tc, ts, tarch, self_attn_type=self_attn)
    assert out.shape == (1, 16, 5, 20, 20) and out.dtype == torch.float32
    sage = self_attn == "sage_attn2"
    assert _rel(out.numpy(), np.asarray(ref)) < (1e-1 if sage else 5e-2)
    # the batch-2 forward itself, row by row (cond, uncond)
    lat2, t2, ctx2 = np.concatenate([lat, lat]), np.concatenate([t, t]), np.concatenate([ctx, ctx_null])
    jrows = np.asarray(jmodel.wan_forward(jp, jnp.asarray(lat2), jnp.asarray(t2), jnp.asarray(ctx2, jnp.bfloat16),
                                          jc, js, jarch, self_attn_type=self_attn))
    trows = tmodel.wan_forward(tp, torch.from_numpy(lat2), torch.from_numpy(t2), tb(ctx2), tc, ts, tarch,
                               self_attn_type=self_attn).numpy()
    for row in range(2):
        assert _rel(trows[row], jrows[row]) < (2e-2 if sage else 1e-2), row
    # the combined output is uncond + g * (cond - uncond) of the two single
    # forwards (a batch-2 matmul may sum in another order than a batch-1 one,
    # which flips a bf16 rounding here and there: 5e-3 absolute)
    kw = dict(self_attn_type=self_attn)
    cond = tmodel.wan_forward(tp, torch.from_numpy(lat), torch.from_numpy(t), tb(ctx), tc, ts, tarch, **kw)
    unc = tmodel.wan_forward(tp, torch.from_numpy(lat), torch.from_numpy(t), tb(ctx_null), tc, ts, tarch, **kw)
    np.testing.assert_allclose(out.numpy(), (unc + 5.0 * (cond - unc)).numpy(), rtol=0, atol=5e-3)


def test_denoise_needs_context_null_under_cfg():
    from lightx2v_tpu_torch.schedulers.unipc import WanUniPCScheduler
    from lightx2v_tpu_torch.utils.config import set_config

    sched = WanUniPCScheduler(set_config(dict(infer_steps=2, sample_shift=5)))
    denoise = make_denoise_fn(tcfg.WanArch(**TINY), sched, SHAPE, enable_cfg=True)
    with pytest.raises(ValueError, match="context_null"):
        denoise({}, {}, torch.zeros(1, 4, 256))
    make_denoise_fn(tcfg.WanArch(**TINY), sched, SHAPE, feature_caching="Tea")  # ported: builds
    with pytest.raises(ValueError, match="feature_caching"):
        make_denoise_fn(tcfg.WanArch(**TINY), sched, SHAPE, feature_caching="FirstBlock")


@pytest.fixture(scope="module")
def runs():
    from lightx2v_tpu.runners.wan_runner import WanRunner as JRunner
    from lightx2v_tpu.utils.config import set_config as jset
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    jr = JRunner(jset(dict(CFG)))
    tr = tinfer.init_runner(tset(dict(CFG, device="cpu")))
    j_enc, t_enc = jr.run_input_encoder(), tr.run_input_encoder()
    j_lat, t_lat = jr.run_dit(j_enc), tr.run_dit(t_enc)
    return dict(jr=jr, tr=tr, j_enc=j_enc, t_enc=t_enc, j_lat=j_lat, t_lat=t_lat,
                j_frames=jr.run_vae_decoder(j_lat), t_frames=tr.run_vae_decoder(t_lat))


@pytest.mark.parametrize("key", ["context", "context_null"])
def test_runner_encode_stage(runs, key):
    j = np.asarray(runs["j_enc"]["text_encoder_output"][key], np.float32)
    t = runs["t_enc"]["text_encoder_output"][key].float().numpy()
    assert t.shape == j.shape == (1, 64, 256)
    assert _rel(t, j) < 1e-2
    other = "context_null" if key == "context" else "context"
    assert _rel(t, runs["t_enc"]["text_encoder_output"][other].float().numpy()) > 0.1  # two prompts


def test_runner_denoise_stage(runs):
    from lightx2v_tpu_torch.schedulers.unipc import WanUniPCScheduler

    tr = runs["tr"]
    assert isinstance(tr.scheduler, WanUniPCScheduler) and tr.scheduler.num_steps() == 3
    assert len(tr.timings["step_s"]) == 3
    j, t = np.asarray(runs["j_lat"]), runs["t_lat"].numpy()
    assert t.shape == j.shape == SHAPE and np.isfinite(t).all()
    assert _rel(t, j) < 5e-2, _rel(t, j)


def test_runner_decode_stage(runs):
    j, t = runs["j_frames"], runs["t_frames"]
    assert t.shape == j.shape == (17, 160, 160, 3) and t.dtype == np.float32
    assert np.isfinite(t).all() and t.min() >= -1.0 and t.max() <= 1.0
    assert _rel(t, j) < 5e-2, _rel(t, j)


def test_base_path_tiny_on_cpu():
    """The base path's own scheme at a tiny size: weight-only int4 linears
    (group 256 at dim 256), sage self-attention, CFG, 3 UniPC steps, through
    ``run_pipeline``; on the CPU no kernel is launched."""
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from lightx2v_tpu_torch.utils.config import set_config as tset

    cfg = dict(CFG, device="cpu", self_attn_1_type="sage_attn2", target_video_length=5, target_height=64,
               target_width=64, mm_config={"mm_type": "W-int4-group-sym-A-bf16-Tpu"})
    r = tinfer.init_runner(tset(cfg))
    blk = r.model["blocks"][0]
    assert blk["ffn"]["0"]["w"].dtype == torch.uint8 and blk["ffn"]["0"]["w"].shape == (512, 128)
    assert blk["self_attn"]["q"]["w_scale"].shape == (256, 1)
    reset_launch_counts()
    frames = r.run_pipeline(save_video=False)
    assert frames.shape == (5, 64, 64, 3) and np.isfinite(frames).all()
    assert not any(launch_counts().values())
    assert set(launch_counts()) >= {"sage_attention", "int4_matmul", "flash_attention_with_lse",
                                    "block_sparse_attention_shared"}
