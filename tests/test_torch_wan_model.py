"""Port Wan DiT (weights, wan_forward, scheduler) vs the JAX package on
its CPU path, from one numpy checkpoint dict.

Tiny arch: dim 256, ffn 512, 2 heads of 128, 2 layers, latents 16x5x20x20
(500 tokens, so the 128-row tiles of the flash plain version end ragged).
Bar for whole forwards: relative L2 error 1e-2 (measured ~5e-3). Both run bf16 activations
through two blocks; they differ where the port's attention is the flash
kernel's plain version (q scaled and rounded to bf16 before the logits, P
rounded to bf16) and the JAX CPU path is chunked XLA attention with
apply_rope_half (rotated q/k rounded to bf16 before scaling)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.models.wan import config as jcfg
from lightx2v_tpu.models.wan import model as jmodel
from lightx2v_tpu.models.wan import weights as jweights
from lightx2v_tpu.models.wan.pipeline import rope_for_shape as j_rope_for_shape
from lightx2v_tpu.tools import convert as jconvert
from lightx2v_tpu_torch.models.wan import config as tcfg
from lightx2v_tpu_torch.models.wan import model as tmodel
from lightx2v_tpu_torch.models.wan import weights as tweights
from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape as t_rope_for_shape
from lightx2v_tpu_torch.tools import convert as tconvert

TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)
SHAPE = (16, 5, 20, 20)
INT8 = "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"


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
def wd():
    return jweights.init_random_weight_dict(jcfg.WanArch(**TINY), seed=0)


def test_random_weight_dict_and_quantizer_match(wd):
    """The port's synthesizer and quantizer give the JAX package's arrays."""
    twd = tweights.init_random_weight_dict(tcfg.WanArch(**TINY), seed=0)
    assert set(twd) == set(wd)
    for k_ in ("blocks.1.ffn.2.weight", "blocks.0.modulation", "head.modulation", "patch_embedding.bias"):
        np.testing.assert_array_equal(np.asarray(wd[k_], np.float32), twd[k_])
    jq, tq = jconvert.quantize_model(wd, "int8"), tconvert.quantize_model(twd, "int8")
    assert set(jq) == set(tq)
    for k_ in ("blocks.0.self_attn.q.weight", "blocks.0.self_attn.q.weight_scale", "text_embedding.0.weight"):
        np.testing.assert_array_equal(np.asarray(jq[k_]), tq[k_])


def test_arch_from_config_and_presets():
    cfg = {"dim": 5120, "ffn_dim": 13824, "num_heads": 40, "num_layers": 40, "rope_fused": True}
    assert tcfg.arch_from_config(cfg) == tcfg.WanArch(**cfg)
    assert tcfg.PRESETS == jcfg.PRESETS
    assert tcfg.is_published_width(tcfg.arch_from_config(cfg))
    assert not tcfg.is_published_width(tcfg.WanArch(**TINY))


def test_load_and_permute_match(wd):
    arch = tcfg.WanArch(**TINY, rope_fused=True)
    jp = jweights.permute_qk_half(jweights.load_wan_params(wd, jcfg.WanArch(**TINY, rope_fused=True)), arch)
    tp = tweights.permute_qk_half(tweights.load_wan_params(wd, arch), arch)
    for i in range(arch.num_layers):
        np.testing.assert_array_equal(np.asarray(jp["blocks"]["self_attn"]["q"]["w"][i], np.float32),
                                      tp["blocks"][i]["self_attn"]["q"]["w"].float().numpy())
        np.testing.assert_array_equal(np.asarray(jp["blocks"]["self_attn"]["norm_k"][i]),
                                      tp["blocks"][i]["self_attn"]["norm_k"].numpy())
    np.testing.assert_array_equal(np.asarray(jp["patch_embedding"]["w"], np.float32),
                                  tp["patch_embedding"]["w"].float().numpy())


def _forward_pair(wd, rope_fused, mm_type):
    jarch = jcfg.WanArch(**TINY, rope_fused=rope_fused)
    tarch = tcfg.WanArch(**TINY, rope_fused=rope_fused)
    jp, tp = jweights.load_wan_params(wd, jarch), tweights.load_wan_params(wd, tarch)
    if rope_fused:
        jp, tp = jweights.permute_qk_half(jp, jarch), tweights.permute_qk_half(tp, tarch)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, *SHAPE)).astype(np.float32)
    ctx = (rng.standard_normal((1, 512, 256)) * 0.5).astype(np.float32)
    ctx[:, 40:] = 0.0  # padded text rows, as the T5 wrapper returns them
    t = np.array([750.0], np.float32)
    jc, js, _ = j_rope_for_shape(jarch, SHAPE)
    tc, ts, _ = t_rope_for_shape(tarch, SHAPE)
    ref = jmodel.wan_forward(jp, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx, jnp.bfloat16), jc, js, jarch,
                             mm_type=mm_type)
    out = tmodel.wan_forward(tp, torch.from_numpy(lat), torch.from_numpy(t),
                             torch.from_numpy(ctx).to(torch.bfloat16), tc, ts, tarch, mm_type=mm_type)
    return np.asarray(ref, np.float32), out.numpy()


@pytest.mark.parametrize("rope_fused,quant", [(True, False), (False, False), (True, True)])
def test_wan_forward_matches_jax(wd, rope_fused, quant):
    if quant:
        wd = jconvert.quantize_model(wd, "int8")
    ref, out = _forward_pair(wd, rope_fused, INT8 if quant else "Default")
    assert out.shape == ref.shape == (1, 16, 5, 20, 20) and np.isfinite(out).all()
    assert _rel(out, ref) < 1e-2, _rel(out, ref)


def test_patchify_roundtrip():
    x = torch.arange(2 * 16 * 4 * 6 * 8, dtype=torch.float32).reshape(2, 16, 4, 6, 8)
    p = tmodel.patchify(x, (1, 2, 2))
    ref = np.asarray(jmodel.patchify(jnp.asarray(x.numpy()), (1, 2, 2)))
    np.testing.assert_array_equal(p.numpy(), ref)
    y = torch.arange(2 * 48 * 64, dtype=torch.float32).reshape(2, 48, 64)
    np.testing.assert_array_equal(tmodel.unpatchify(y, (4, 3, 4), (1, 2, 2), 16).numpy(),
                                  np.asarray(jmodel.unpatchify(jnp.asarray(y.numpy()), (4, 3, 4), (1, 2, 2), 16)))


def test_step_distill_schedule_and_step_post():
    """Same sigma/timestep tables; one step_post with the JAX package's own
    re-noise draw injected gives its update (fp32 elementwise)."""
    import jax

    from lightx2v_tpu.schedulers.step_distill import WanStepDistillScheduler as JS
    from lightx2v_tpu.utils.config import ConfigDict as JC
    from lightx2v_tpu_torch.schedulers.step_distill import WanStepDistillScheduler as TS
    from lightx2v_tpu_torch.utils.config import ConfigDict as TC

    kw = dict(infer_steps=4, denoising_step_list=[1000, 750, 500, 250], sample_shift=5.0, latent_init="torch")
    js, ts = JS(JC(kw)), TS(TC(kw))
    shape = (16, 2, 4, 4)
    jstate = js.prepare(shape, seed=42)
    tstate = ts.prepare(shape, torch.Generator().manual_seed(42))
    np.testing.assert_array_equal(js.sigmas, ts.sigmas)
    np.testing.assert_array_equal(js.timesteps, ts.timesteps)
    np.testing.assert_array_equal(np.asarray(jstate["latents"]), tstate["latents"].numpy())
    pred = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    noise_of = lambda key: np.array(jax.random.normal(key, shape, jnp.float32))  # noqa: E731
    for _ in range(4):
        _, sub = jax.random.split(jstate["rng"])
        noise = noise_of(sub)
        jstate = js.step_post(jstate, jnp.asarray(pred))
        tstate = ts.step_post(tstate, torch.from_numpy(pred), noise=torch.from_numpy(noise))
        np.testing.assert_allclose(tstate["latents"].numpy(), np.asarray(jstate["latents"]), rtol=1e-6, atol=1e-6)
    assert tstate["step_index"] == 4
