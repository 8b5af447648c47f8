"""CausVid on the CPU, port vs JAX package: the cross-attention K/V, one
KV-cached block forward and its cache update, and the whole runner over two
fragments.

Tiny arch: dim 256, ffn 512, 2 heads of 128, 2 layers, from the same host
numpy dict (``init_random_weight_dict``); blocks of one latent frame of 8 x
12 latents (24 tokens), a window of 3 frames (72 cache slots). Bars,
relative L2: 1e-2 on the cross K/V and a forward's prediction and cache
(bf16 activations, fp32 sums in another order; measured 1.4e-6 / 1.5e-8,
5.0e-3 and 3.2e-3 / 2.8e-3); 1e-2 on the runner's latents, 5 AR blocks of 3
distill steps each on the caches the earlier blocks wrote (measured 1.6e-3),
and on the decoded frames (measured 8.9e-5). The runner test injects the
JAX draws: each block's initial latents (``jax.random.split`` of ``PRNGKey(seed)``) and the
re-noise of each step (``PRNGKey(seed + 1)``, restarted per block)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.models.wan import causvid as jcv
from lightx2v_tpu.models.wan import config as jcfg
from lightx2v_tpu.models.wan import model as jmodel
from lightx2v_tpu.models.wan import weights as jweights
from lightx2v_tpu.ops.linear import resolve_mm as j_resolve_mm
from lightx2v_tpu.ops.rope import build_wan_rope_grid as j_rope_grid
from lightx2v_tpu_torch.models.wan import causvid as tcv
from lightx2v_tpu_torch.models.wan import config as tcfg
from lightx2v_tpu_torch.models.wan import model as tmodel
from lightx2v_tpu_torch.models.wan import weights as tweights
from lightx2v_tpu_torch.ops.linear import resolve_mm as t_resolve_mm

TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)
CFG = dict(model_cls="wan2.1_causvid", task="t2v", synthetic_weights=True, prompt="a spinning top", seed=42,
           enable_cfg=False, target_video_length=9, target_height=64, target_width=96, sample_shift=5,
           text_len=64, self_attn_1_type="flash_attn3", cross_attn_1_type="flash_attn3", num_frames=3,
           num_frame_per_block=1, num_blocks=3, num_fragments=2, denoising_step_list=[999, 500, 100], **TINY)


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
def pair():
    jarch, tarch = jcfg.WanArch(**TINY), tcfg.WanArch(**TINY)
    wd = jweights.init_random_weight_dict(jarch, seed=0)
    jp, tp = jweights.load_wan_params(wd, jarch), tweights.load_wan_params(wd, tarch)
    rng = np.random.default_rng(3)
    ctx = (rng.standard_normal((1, 64, 256)) * 0.5).astype(np.float32)
    ctx[:, 20:] = 0.0
    j_ctx = jmodel.text_embeddings(jp, jnp.asarray(ctx, jnp.bfloat16), j_resolve_mm("Default"))
    t_ctx = tmodel.text_embeddings(tp, torch.from_numpy(ctx).to(torch.bfloat16), t_resolve_mm("Default"))
    return dict(jarch=jarch, tarch=tarch, jp=jp, tp=tp, j_ctx=j_ctx, t_ctx=t_ctx, rng=rng)


def test_precompute_cross_kv(pair):
    jk, jv = jcv.precompute_cross_kv(pair["jp"], pair["j_ctx"], pair["jarch"])
    t = tcv.precompute_cross_kv(pair["tp"], pair["t_ctx"], pair["tarch"])
    tk, tv = torch.stack([k for k, _ in t]), torch.stack([v for _, v in t])
    assert tuple(tk.shape) == jk.shape == (2, 1, 64, 2, 128)
    assert _rel(tk.float(), np.asarray(jk, np.float32)) < 1e-2
    assert _rel(tv.float(), np.asarray(jv, np.float32)) < 1e-2


def test_causvid_forward_and_cache(pair):
    """The block at window position 1 of 3 (slots 24..47 written, 0..47
    read): the prediction, the written slots, and the slots it must not
    touch (0..23 and the stale 48..71, V = 1e4 there, never read)."""
    rng = pair["rng"]
    lat = rng.standard_normal((1, 16, 1, 8, 12)).astype(np.float32)
    cache = {k: (rng.standard_normal((2, 1, 72, 2, 128)) * 0.5).astype(np.float32) for k in ("k", "v")}
    cache["v"][:, :, 48:] = 1e4
    cos, sin = j_rope_grid(128, 1, 4, 6, start_frame=1)
    jcross = jcv.precompute_cross_kv(pair["jp"], pair["j_ctx"], pair["jarch"])
    j_out, j_cache = jcv.causvid_forward(pair["jp"], jnp.asarray(lat), jnp.asarray([750.0]),
                                         {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache.items()}, jcross,
                                         jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(24), jnp.asarray(48),
                                         pair["jarch"], attn_type="flash_attn3")
    t_cache = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in cache.items()}
    before = {k: v.clone() for k, v in t_cache.items()}
    t_out = tcv.causvid_forward(pair["tp"], torch.from_numpy(lat), torch.tensor([750.0]), t_cache,
                                tcv.precompute_cross_kv(pair["tp"], pair["t_ctx"], pair["tarch"]),
                                torch.from_numpy(cos), torch.from_numpy(sin), 24, 48, pair["tarch"])
    assert tuple(t_out.shape) == j_out.shape == (1, 16, 1, 8, 12) and torch.isfinite(t_out).all()
    assert _rel(t_out, np.asarray(j_out)) < 1e-2, _rel(t_out, np.asarray(j_out))
    for k in ("k", "v"):
        assert _rel(t_cache[k][:, :, 24:48].float(), np.asarray(j_cache[k][:, :, 24:48], np.float32)) < 1e-2
        assert torch.equal(t_cache[k][:, :, :24], before[k][:, :, :24])
        assert torch.equal(t_cache[k][:, :, 48:], before[k][:, :, 48:])


def _jax_draws(shape, n_blocks, n_steps, seed):
    rng, blocks = jax.random.PRNGKey(seed), []
    for _ in range(n_blocks):
        rng, sub = jax.random.split(rng)
        blocks.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    rng, noises = jax.random.PRNGKey(seed + 1), []
    for _ in range(n_steps):
        rng, sub = jax.random.split(rng)
        noises.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return blocks, noises


def test_runner_two_fragments_vs_jax():
    """2 fragments of 3 one-frame blocks: 3 + 2 blocks, the second
    fragment's cache re-anchored on the first's last block."""
    from lightx2v_tpu.runners.wan_causvid_runner import WanCausVidRunner as JRunner
    from lightx2v_tpu.utils.config import set_config as jset
    from lightx2v_tpu_torch.runners.wan_causvid_runner import WanCausVidRunner as TRunner
    from lightx2v_tpu_torch.utils.config import set_config as tset

    jr = JRunner(jset(dict(CFG)))
    tr = TRunner(tset(dict(CFG, device="cpu")))
    j_enc, t_enc = jr.run_input_encoder(), tr.run_input_encoder()
    j_lat = np.asarray(jr.run_dit(j_enc))
    blocks, noises = _jax_draws((16, 1, 8, 12), 5, 3, CFG["seed"])
    t_lat = tr.run_dit(t_enc, block_latents=blocks, noises=noises)
    assert tuple(t_lat.shape) == j_lat.shape == (16, 5, 8, 12) and torch.isfinite(t_lat).all()
    assert _rel(t_lat, j_lat) < 1e-2, _rel(t_lat, j_lat)
    assert len(tr.timings["step_s"]) == 15 and len(tr.timings["block_s"]) == 5
    assert len(tr.timings["reanchor_s"]) == 1
    j_frames, t_frames = jr.run_vae_decoder(jnp.asarray(j_lat)), tr.run_vae_decoder(t_lat)
    assert t_frames.shape == j_frames.shape == (17, 64, 96, 3)
    assert _rel(t_frames, j_frames) < 1e-2, _rel(t_frames, j_frames)


@pytest.mark.parametrize("extra,match", [
    (dict(cpu_offload=True), "resident"), (dict(weight_streaming=True), "resident"),
    (dict(feature_caching="TaylorSeer"), "caching"), (dict(changing_resolution=True), "one resolution"),
    (dict(mesh_shape={"seq": 2}), "item 14"),
])
def test_runner_refusals(extra, match):
    """Keys the JAX CausVid runner does not run raise before any weight is made."""
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    with pytest.raises(NotImplementedError, match=match):
        tinfer.init_runner(tset(dict(CFG, device="cpu", **extra)))


def test_entry_point_smoke_config():
    """``infer.init_runner`` on the JAX tests' smoke config (the small
    synthetic stack) with ``tests/test_df_causvid.py``'s overrides."""
    from pathlib import Path

    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    args = infer.build_parser().parse_args([
        "--model_cls", "wan2.1_causvid", "--config_json",
        str(Path(__file__).resolve().parents[1] / "configs/wan_t2v_synthetic_smoke.json"),
        "--prompt", "a spinning top", "--synthetic_weights", "--device", "cpu"])
    cfg = tset(args)
    cfg.update(enable_cfg=False, num_frames=3, num_frame_per_block=1, num_blocks=3, num_fragments=2,
               denoising_step_list=[999, 500, 100])
    frames = infer.init_runner(cfg).run_pipeline(save_video=False)
    assert frames.shape == (17, 64, 96, 3) and np.isfinite(frames).all()


def test_sample_shift_required():
    """``configs/wan_t2v_causvid.json`` names no ``sample_shift``, which the
    step-distill schedule reads: the JAX runner fails on it (AttributeError)
    and the port raises ``ValueError`` saying so."""
    from lightx2v_tpu.runners.wan_causvid_runner import WanCausVidRunner as JRunner
    from lightx2v_tpu.utils.config import set_config as jset
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    cfg = {k: v for k, v in CFG.items() if k != "sample_shift"}
    with pytest.raises(AttributeError, match="sample_shift"):
        JRunner(jset(dict(cfg, num_layers=1))).init_scheduler()
    with pytest.raises(ValueError, match="sample_shift"):
        tinfer.init_runner(tset(dict(cfg, device="cpu", num_layers=1))).init_scheduler()
