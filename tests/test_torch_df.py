"""SkyReels-V2 diffusion forcing on the CPU, port vs JAX package: the
timestep matrix, the masked per-frame UniPC step with the prefix re-noise,
the per-frame time embedding, and the runner with one and two segments.

The matrix is numpy on both sides: equal bit for bit. The DF step: the
same initial latents (the CPU torch stream, ``latent_init: "torch"``), the
same prediction each row and the JAX scheduler's ``PRNGKey(seed + 17)``
re-noise injected; bar relative L2 1e-5 (fp32 on both sides; measured 0).
The per-frame time embedding against the JAX per-token one: the
embeddings within 1e-5 (fp32 GEMMs of two libraries; measured 2.1e-6,
6.7e-7), a forward within 1e-2 (measured 4.8e-3), the tiny arch of the
other port tests (dim 256, 2 heads of 128, 2 layers, one shared numpy
weight dict).

Runner: 64 x 96, the tiny arch, 2 UniPC steps. One segment of 9 frames with
CFG at 6 at batch 2 (bar 3e-2 on the latents, as CogVideoX's CFG at 6,
difference s; measured 9.7e-3; frames 1e-2, measured 7.9e-4); two segments
of 9 frames overlapping by 5 (13 frames, the tail decoded and encoded as
the prefix, re-noised at 20), the JAX draws injected; bar 1e-2, measured
1.5e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.models.wan import config as jcfg
from lightx2v_tpu.models.wan import model as jmodel
from lightx2v_tpu.models.wan import weights as jweights
from lightx2v_tpu.models.wan.pipeline import rope_for_shape as j_rope_for_shape
from lightx2v_tpu.schedulers import df as jdf
from lightx2v_tpu.utils.config import set_config as jset
from lightx2v_tpu_torch.models.wan import config as tcfg
from lightx2v_tpu_torch.models.wan import model as tmodel
from lightx2v_tpu_torch.models.wan import weights as tweights
from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape as t_rope_for_shape
from lightx2v_tpu_torch.schedulers import df as tdf
from lightx2v_tpu_torch.utils.config import set_config as tset
from test_torch_vae_encode import jit_vae

TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)
CFG = dict(model_cls="wan2.1_skyreels_v2_df", task="t2v", synthetic_weights=True, prompt="a boat on a lake", seed=42,
           target_height=64, target_width=96, sample_shift=8, text_len=64, latent_init="torch",
           self_attn_1_type="flash_attn3", cross_attn_1_type="flash_attn3", **TINY)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("args,kw", [
    ((4, 4, [900, 600, 300]), {}),  # sync
    ((4, 4, [900, 600, 300]), dict(num_pre_ready=2)),  # prefix
    ((6, 6, list(range(999, 0, -100))), dict(ar_step=2)),
    ((8, 4, list(range(999, 0, -100))), dict(ar_step=3, num_pre_ready=2)),  # ar_step past the base window
    ((4, 4, [900, 600]), dict(casual_block_size=2)),
    ((25, 25, [999, 966, 931]), dict(num_pre_ready=5, casual_block_size=5, ar_step=1)),
])
def test_timestep_matrix_bit_for_bit(args, kw):
    f, base, tmpl = args
    jsm, jum, jvi = jdf.generate_timestep_matrix(f, base, np.asarray(tmpl, np.int64), **kw)
    tsm, tum, tvi = tdf.generate_timestep_matrix(f, base, np.asarray(tmpl, np.int64), **kw)
    np.testing.assert_array_equal(tsm, jsm)
    np.testing.assert_array_equal(tum, jum)
    assert tvi == jvi and tsm.dtype == jsm.dtype and tum.dtype == jum.dtype


def _close_where_finite(t, j, what):
    """NaN at the same entries, the rest within 1e-5 relative L2."""
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j), err_msg=str(what))
    ok = ~np.isnan(j)
    assert _rel(t[ok], j[ok]) < 1e-5, (what, _rel(t[ok], j[ok]))


@pytest.mark.parametrize("ar_step", [0, 1])
def test_df_step_with_mask_and_prefix_vs_jax(ar_step):
    """5 latent frames, 2 of them a prefix re-noised at 20; ar_step 1 staggers
    the frames (6 rows of a 4-step schedule: steps past it clamp). From row
    4 on, the JAX update of a frame still stepping reads sigma 0 as its
    start (log 0 in lambda) and gives NaN; the port gives NaN at the same
    entries (the finite ones within the bar)."""
    cfg = dict(infer_steps=4, sample_shift=8, addnoise_condition=20, latent_init="torch")
    js, ts = jdf.WanSkyreelsV2DFScheduler(jset(cfg)), tdf.WanSkyreelsV2DFScheduler(tset(cfg))
    shape, seed = (16, 5, 4, 6), 3
    rng = np.random.default_rng(0)
    prefix = rng.standard_normal((16, 2, 4, 6)).astype(np.float32)
    jst = js.prepare_df(shape, seed, num_pre_ready=2, ar_step=ar_step, prefix_latents=jnp.asarray(prefix))
    tst = ts.prepare_df(shape, torch.Generator().manual_seed(seed), num_pre_ready=2, ar_step=ar_step,
                        prefix_latents=torch.from_numpy(prefix))
    np.testing.assert_array_equal(ts.step_matrix, js.step_matrix)
    assert ts.num_steps() == js.num_steps() == (4 if ar_step == 0 else 6)
    np.testing.assert_array_equal(tst["latents"].numpy(), np.asarray(jst["latents"]))
    key = jax.random.PRNGKey(seed + 17)
    for r in range(js.num_steps()):
        key, sub = jax.random.split(key)
        noise = np.array(jax.random.normal(sub, (16, 2, 4, 6), jnp.float32))
        jst, jlat, jt = js.df_step_pre(jst, jnp.asarray(js.step_matrix[r]))
        tst, tlat, tt = ts.df_step_pre(tst, ts.step_matrix[r], noise=torch.from_numpy(noise))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert tt[0] == 20.0 and tt[2] == float(ts.step_matrix[r][2])
        _close_where_finite(tlat.float().numpy(), np.asarray(jlat, np.float32), (r, "model input"))
        pred = rng.standard_normal(shape).astype(np.float32)
        jst = js.df_step_post(jst, jnp.asarray(pred), jnp.asarray(js.update_mask[r]), jst["step_index"])
        tst = ts.df_step_post(tst, torch.from_numpy(pred), ts.update_mask[r])
        for k in ("latents", "m_prev", "last_sample"):
            _close_where_finite(tst[k].numpy(), np.asarray(jst[k]), (r, k))
    np.testing.assert_array_equal(tst["frame_step"].numpy(), np.asarray(jst["frame_step"]))
    assert int(tst["frame_step"][0]) == 0  # the prefix is never updated


@pytest.fixture(scope="module")
def dit_pair():
    jarch, tarch = jcfg.WanArch(**TINY), tcfg.WanArch(**TINY)
    wd = jweights.init_random_weight_dict(jarch, seed=0)
    return jarch, tarch, jweights.load_wan_params(wd, jarch), tweights.load_wan_params(wd, tarch)


def test_per_frame_time_embedding_vs_jax_per_token(dit_pair):
    """The port embeds one timestep per latent frame and broadcasts it over
    the frame's tokens; the JAX package embeds each token's timestep."""
    jarch, tarch, jp, tp = dit_pair
    shape, tpf = (16, 3, 8, 12), 24  # 3 latent frames of 4 x 6 tokens
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, *shape)).astype(np.float32)
    ctx = (rng.standard_normal((2, 64, 256)) * 0.5).astype(np.float32)
    t_frames = np.array([[20.0, 850.0, 999.0], [20.0, 850.0, 999.0]], np.float32)
    t_tok = np.repeat(t_frames, tpf, axis=1)
    je, je0 = jmodel.time_embeddings(jp, jnp.asarray(t_tok), jarch)
    te, te0 = tmodel.time_embeddings(tp, torch.from_numpy(t_frames), tarch)
    assert tuple(te0.shape) == (2, 3, 6, 256) and je0.shape == (2, 72, 6, 256)
    assert _rel(te.repeat_interleave(tpf, dim=1), np.asarray(je)) < 1e-5
    assert _rel(te0.repeat_interleave(tpf, dim=1), np.asarray(je0)) < 1e-5
    jc, js = j_rope_for_shape(jarch, shape)[:2]
    tc, ts = t_rope_for_shape(tarch, shape)[:2]
    ref = np.asarray(jmodel.wan_forward(jp, jnp.asarray(lat), jnp.asarray(t_tok), jnp.asarray(ctx, jnp.bfloat16),
                                        jc, js, jarch))
    out = tmodel.wan_forward(tp, torch.from_numpy(lat), torch.from_numpy(t_frames),
                             torch.from_numpy(ctx).to(torch.bfloat16), tc, ts, tarch).numpy()
    assert out.shape == ref.shape == (2, *shape) and np.isfinite(out).all()
    assert _rel(out, ref) < 1e-2, _rel(out, ref)


def _renoise(seed, n_rows, shape):
    key, out = jax.random.PRNGKey(seed + 17), []
    for _ in range(n_rows):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return out


@pytest.mark.parametrize("extra,bar", [
    (dict(enable_cfg=True, sample_guide_scale=6, infer_steps=2, target_video_length=9, base_num_frames=9,
          overlap_history=0, addnoise_condition=0), 3e-2),
    (dict(enable_cfg=False, infer_steps=2, target_video_length=13, base_num_frames=9, overlap_history=5,
          addnoise_condition=20, latent_init="jax"), 1e-2),
], ids=["one_segment_cfg", "two_segments"])
def test_runner_vs_jax(extra, bar):
    """One segment draws its latents from the shared CPU torch stream on both
    sides; two segments take the JAX draws injected: each segment's latents
    (``PRNGKey(seed + s)``) and the second's prefix re-noise."""
    from lightx2v_tpu.runners import wan_skyreels_v2_df_runner as jmod
    from lightx2v_tpu.vae import wan_vae as jvae
    from lightx2v_tpu_torch import infer as tinfer

    cfg = dict(CFG, **extra)
    jr = jmod.WanSkyreelsV2DFRunner(jset(dict(cfg)))
    tr = tinfer.init_runner(tset(dict(cfg, device="cpu")))
    j_enc, t_enc = jr.run_input_encoder(), tr.run_input_encoder()
    mp = pytest.MonkeyPatch()  # the JAX encode as one compiled program
    mp.setattr(jmod, "vae_encode", lambda params, x, c, scale: jnp.asarray(
        jit_vae(jvae.vae_encode, params, x, c, scale=scale)))
    j_lat = np.asarray(jr.run_dit(j_enc))
    mp.undo()
    n_seg = 2 if extra["target_video_length"] == 13 else 1
    latents, renoise = None, None
    if n_seg > 1:
        latents = [torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(CFG["seed"] + s), (16, 3, 8, 12),
                                                               jnp.float32))) for s in range(n_seg)]
        renoise = [None] + [_renoise(CFG["seed"] + s, 2, (16, 2, 8, 12)) for s in range(1, n_seg)]
    t_lat = tr.run_dit(t_enc, latents=latents, renoise=renoise)
    frames = extra["target_video_length"]
    assert tuple(t_lat.shape) == j_lat.shape == (16, (frames - 1) // 4 + 1, 8, 12) and torch.isfinite(t_lat).all()
    assert tr.timings["segment_rows"] == [extra["infer_steps"]] * n_seg
    assert _rel(t_lat, j_lat) < bar, _rel(t_lat, j_lat)
    if n_seg == 1:  # the decode (the two-segment run decodes and encodes its tail inside run_dit)
        j_frames, t_frames = jr.run_vae_decoder(jnp.asarray(j_lat)), tr.run_vae_decoder(t_lat)
        assert t_frames.shape == j_frames.shape == (frames, 64, 96, 3)
        assert _rel(t_frames, j_frames) < 1e-2, _rel(t_frames, j_frames)


@pytest.mark.parametrize("extra,err,match", [
    (dict(mm_config={"mm_type": "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"}), ValueError, "Default"),
    (dict(lazy_load=True), NotImplementedError, "resident"),
    (dict(feature_caching="Tea"), NotImplementedError, "caching"),
    (dict(changing_resolution=True), NotImplementedError, "one resolution"),
    (dict(mesh_shape={"seq": 2}), NotImplementedError, "item 14"),
])
def test_runner_refusals(extra, err, match):
    """What the JAX DF runner does not run raises before any weight is made;
    a quantized mm_type too (its forward runs Default whatever the config
    says)."""
    from lightx2v_tpu_torch import infer as tinfer

    with pytest.raises(err, match=match):
        tinfer.init_runner(tset(dict(CFG, device="cpu", infer_steps=2, **extra)))


def test_entry_point_smoke_config():
    """``infer.init_runner`` on the JAX tests' smoke config (the small
    synthetic stack) with ``tests/test_df_causvid.py``'s overrides."""
    from pathlib import Path

    from lightx2v_tpu_torch import infer

    args = infer.build_parser().parse_args([
        "--model_cls", "wan2.1_skyreels_v2_df", "--config_json",
        str(Path(__file__).resolve().parents[1] / "configs/wan_t2v_synthetic_smoke.json"),
        "--prompt", "a spinning top", "--synthetic_weights", "--device", "cpu"])
    cfg = tset(args)
    cfg.update(enable_cfg=False, infer_steps=3, ar_step=0, addnoise_condition=0, base_num_frames=9,
               overlap_history=0)
    frames = infer.init_runner(cfg).run_pipeline(save_video=False)
    assert frames.shape == (9, 64, 96, 3) and np.isfinite(frames).all()
