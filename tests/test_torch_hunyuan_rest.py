"""The rest of HunyuanVideo on the CPU, port vs JAX package: RIFLEx
(``riflex_k_for`` and the RoPE tables), i2v's token-replace forward, the
int8, fp8, weight-only int4 and int4 x int8 DiT forwards from one
numpy-quantized state dict, the small synthetic i2v runner with TeaCache
(its calc/skip series and its latents), and the VAE encoder at the
posterior mean and with injected noise. Weights come from the host numpy
state dicts that both packages build identically; inputs from numpy seeds.
The JAX side runs its plain attention (``attn_type="xla"``); the port's DiT
runs ``flash_attn3``, the dense flash kernel's plain version on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.models.hunyuan import config as jc
from lightx2v_tpu.models.hunyuan import model as jm
from lightx2v_tpu.models.hunyuan import weights as jw
from lightx2v_tpu.tools.convert import quantize_tensor
from lightx2v_tpu.utils.config import set_config as jset
from lightx2v_tpu.vae import hunyuan_vae as jv
from lightx2v_tpu_torch.caching.teacache import hunyuan_tea_plan
from lightx2v_tpu_torch.models.hunyuan import config as tc
from lightx2v_tpu_torch.models.hunyuan import model as tm
from lightx2v_tpu_torch.models.hunyuan import weights as tw
from lightx2v_tpu_torch.utils.config import set_config as tset
from lightx2v_tpu_torch.vae import hunyuan_vae as tv

ARCH = dict(hidden_size=256, heads_num=2, double_blocks=1, single_blocks=1, mlp_hidden_dim=512, text_states_dim=64,
            text_states_dim_2=32, task="i2v")
GRID = (2, 4, 4)  # latents 16 x 2 x 8 x 8: 32 image tokens, 16 a latent frame
MM = {"int8": "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu",
      "fp8": "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Tpu",
      "int4": "W-int4-group-sym-A-bf16-Tpu",
      "int4a8": "W-int4-group-sym-A-int8-token-dynamic-Tpu"}
# params name -> state-dict key of each block linear
DOUBLE_LINEARS = {f"{s}_{n}": f"{s}_{k}" for s in ("img", "txt") for n, k in
                  (("mod", "mod.linear"), ("attn_qkv", "attn_qkv"), ("attn_proj", "attn_proj"),
                   ("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2"))}
SINGLE_LINEARS = {"linear1": "linear1", "linear2": "linear2", "modulation": "modulation.linear"}


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


@pytest.mark.parametrize("frames", [85, 129, 193, 257, 400])
def test_riflex_vs_jax(frames):
    """``riflex_k_for`` and the RoPE tables with RIFLEx at the real rope dims
    (16, 56, 56): the JAX package's, exactly (None up to 192 frames, then 4,
    4 and 6)."""
    k = tm.riflex_k_for(frames)
    assert k == jm.riflex_k_for(frames)
    lat_f = (frames - 1) // 4 + 1
    out = tm.build_hunyuan_rope(tc.HunyuanArch(**ARCH), lat_f, 2, 3, riflex_k=k, l_test=lat_f if k else None)
    ref = jm.build_hunyuan_rope(jc.HunyuanArch(**ARCH), lat_f, 2, 3, riflex_k=k, l_test=lat_f if k else None)
    for a, b in zip(out, ref):
        assert a.shape == (lat_f * 6, 64)
        np.testing.assert_array_equal(a, b)
    if k:  # the k-th temporal frequency moved: the tables differ from plain RoPE's
        assert not np.array_equal(out[0], tm.build_hunyuan_rope(tc.HunyuanArch(**ARCH), lat_f, 2, 3)[0])


def _quantized(sd, scheme):
    """The state dict with every double and single block linear quantized
    (``.weight`` codes and ``.weight_scale``) by the JAX converter's
    ``quantize_tensor`` ("int4": nibble-packed, per-(channel, group)
    scales, the group from ``_pick_bk``)."""
    out = dict(sd)
    blocks = [(f"double_blocks.{i}", DOUBLE_LINEARS) for i in range(ARCH["double_blocks"])]
    blocks += [(f"single_blocks.{i}", SINGLE_LINEARS) for i in range(ARCH["single_blocks"])]
    for pfx, names in blocks:
        for key in names.values():
            q, s = quantize_tensor(sd[f"{pfx}.{key}.weight"], "int4" if "int4" in scheme else scheme)
            out[f"{pfx}.{key}.weight"], out[f"{pfx}.{key}.weight_scale"] = q, s
    return out


def _jax_params(sd, qsd, ja):
    """The JAX params: the bf16 loader's tree with the block linears' codes
    and scales stacked in place of their weights."""
    jp = jw.load_hunyuan_params(sd, ja)
    if qsd is None:
        return jp
    for stack, n, names in (("double_blocks", ja.double_blocks, DOUBLE_LINEARS),
                            ("single_blocks", ja.single_blocks, SINGLE_LINEARS)):
        for name, key in names.items():
            keys = [f"{stack}.{i}.{key}" for i in range(n)]
            jp[stack][name]["w"] = jnp.asarray(np.stack([qsd[f"{k}.weight"] for k in keys]))
            jp[stack][name]["w_scale"] = jnp.asarray(np.stack([qsd[f"{k}.weight_scale"] for k in keys]))
    return jp


@pytest.fixture(scope="module")
def dit():
    ja, ta = jc.HunyuanArch(**ARCH), tc.HunyuanArch(**ARCH)
    return ja, ta, jw.init_random_hunyuan_state_dict(ja, seed=3, scale=0.05)


def _inputs(seed=0, lt=12, valid=7):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, 16, 2, 8, 8)).astype(np.float32)
    states = (rng.standard_normal((1, lt, ARCH["text_states_dim"])) * 0.5).astype(np.float32)
    mask = np.zeros((1, lt), np.int32)
    mask[0, :valid] = 1
    pooled = (rng.standard_normal((1, ARCH["text_states_dim_2"])) * 0.5).astype(np.float32)
    return lat, np.array([700.0], np.float32), states, mask, pooled


def _both(ja, ta, jp, tp, mm_type="Default", token_replace=True, riflex=(4, 2)):
    """(port, JAX) predictions on the same inputs, the RoPE with RIFLEx k at
    l_test latent frames."""
    lat, t, states, mask, pooled = _inputs()
    k, l_test = riflex
    cos, sin = jm.build_hunyuan_rope(ja, *GRID, riflex_k=k, l_test=l_test)
    fwd = jax.jit(lambda p, *a: jm.hunyuan_forward(p, *a, arch=ja, guidance=jnp.asarray([6000.0]), attn_type="xla",
                                                   mm_type=mm_type, token_replace=token_replace))
    ref = np.asarray(fwd(jp, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(states), jnp.asarray(mask),
                         jnp.asarray(pooled), jnp.asarray(cos), jnp.asarray(sin)), np.float32)
    out = tm.HunyuanTransformer(tp, ta)(
        torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(states), torch.from_numpy(mask),
        torch.from_numpy(pooled), torch.from_numpy(cos), torch.from_numpy(sin), tm.text_kv_len(32, mask),
        guidance=torch.tensor([6000.0]), mm_type=mm_type, token_replace=token_replace)
    assert out.shape == lat.shape and out.dtype == torch.float32 and np.isfinite(ref).all()
    return out.numpy(), ref


def test_i2v_token_replace_forward_vs_jax(dit):
    """``hunyuan_forward(token_replace=True)`` on an i2v arch, RIFLEx k = 4
    in the RoPE: the first latent frame's 16 tokens take the t = 0
    modulation in the image stream and the single blocks. Bar: relative L2
    1e-2 on the fp32 prediction, the t2v forward's (bf16 activations, plain
    attention against the flash kernel's plain version; measured 4.3e-3).
    The token-replace output differs from the plain forward's, on the first
    frame most."""
    ja, ta, sd = dit
    jp, tp = _jax_params(sd, None, ja), tw.load_hunyuan_params(sd, ta)
    out, ref = _both(ja, ta, jp, tp)
    assert _rel(out, ref) < 1e-2, _rel(out, ref)
    plain, _ = _both(ja, ta, jp, tp, token_replace=False)
    moved = np.abs(out - plain)
    assert moved[:, :, 0].mean() > 1e-3 and moved[:, :, 0].mean() > moved[:, :, 1].mean()


@pytest.mark.parametrize("scheme,bar", [("int8", 1e-2), ("fp8", 3e-2), ("int4", 1e-2), ("int4a8", 3e-2)])
def test_quantized_forward_vs_jax(dit, scheme, bar):
    """The DiT with every double and single block linear (the modulation
    projections included) quantized from one numpy dict, loaded into both
    packages, i2v token replace on. int8 and fp8: per-token activation codes
    on both sides (fp8 amplifies bf16 noise more, PERF.md: bar 3e-2).
    Weight-only int4: the same bf16 x int4 products. int4a8: the port
    quantizes activations per (token, group) to int8 as the TPU kernel does,
    where the JAX package's CPU fallback runs weight-only (bar 3e-2). Bars:
    relative L2 on the fp32 prediction (measured 7.6e-3, 1.4e-2, 4.6e-3 and
    7.6e-3)."""
    ja, ta, sd = dit
    qsd = _quantized(sd, scheme)
    tp = tw.load_hunyuan_params(qsd, ta)
    lin = tp["double_blocks"][0]["img_mod"]
    assert lin["w"].dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(scheme, torch.uint8)
    assert lin["w_scale"].ndim == (2 if "int4" in scheme else 1)
    out, ref = _both(ja, ta, _jax_params(sd, qsd, ja), tp, mm_type=MM[scheme])
    assert _rel(out, ref) < bar, _rel(out, ref)


def test_device_synthesizer_schemes():
    """``init_random_hunyuan_params_on_device(scheme=...)`` lays out every
    block linear as the loader does (int8 / e4m3 codes with (out,) scales,
    int4 packed (out, in/2) with (out, in/512) scales), the rest bf16."""
    arch = tc.HunyuanArch(hidden_size=1024, heads_num=8, double_blocks=1, single_blocks=1, mlp_hidden_dim=2048,
                          text_states_dim=64, text_states_dim_2=32)
    for scheme, dtype in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn), ("int4", torch.uint8)):
        p = tw.init_random_hunyuan_params_on_device(arch, seed=1, device="cpu", scheme=scheme)
        for lin in [*(p["double_blocks"][0][k] for k in DOUBLE_LINEARS),
                    *(p["single_blocks"][0][k] for k in SINGLE_LINEARS)]:
            out, k = lin["b"].shape[0], (lin["w"].shape[1] * 2 if scheme == "int4" else lin["w"].shape[1])
            assert lin["w"].dtype == dtype
            assert lin["w_scale"].shape == ((out, k // 512) if scheme == "int4" else (out,))
        assert p["time_in"]["0"]["w"].dtype == torch.bfloat16 and "w_scale" not in p["final_layer"]["linear"]


def test_tea_i2v_runner_vs_jax():
    """The small synthetic i2v runner (token replace, 33 frames: no RIFLEx)
    with TeaCache over 8 Euler steps, on both packages in one process (the
    random text states draw from Python's salted hash of the prompt): the
    port's host plan equals the JAX package's replay of ``tea_decide`` on
    its own time embeddings and holds skip steps; the latents agree. Bar:
    relative L2 1e-2 on the latents, the t2v runner test's."""
    from lightx2v_tpu.caching.teacache import TeaCacheConfig as JTea
    from lightx2v_tpu.caching.teacache import tea_decision_series as j_series
    from lightx2v_tpu.runners.hunyuan_runner import HunyuanRunner as JRunner
    from lightx2v_tpu_torch import infer as tinfer

    cfg = dict(model_cls="hunyuan", task="i2v", prompt="a red panda climbing a bamboo tree", latent_init="torch",
               config_json="configs/hunyuan_t2v_synthetic_smoke.json", infer_steps=8, target_video_length=33,
               feature_caching="Tea", teacache_thresh=0.2)
    jr = JRunner(jset(dict(cfg)))
    tr = tinfer.init_runner(tset(dict(cfg, device="cpu")))
    assert tr.arch.task == jr.arch.task == "i2v"
    j_enc, t_enc = jr.run_input_encoder(), tr.run_input_encoder()
    j_lat, t_lat = jr.run_dit(j_enc), tr.run_dit(t_enc)
    jcfg = dataclasses.replace(JTea.from_config(jr.config), use_ret_steps=False)
    j_plan = j_series(np.asarray(jm._timestep_embedding(jnp.asarray(jr.scheduler.timesteps))), jcfg)
    plan = hunyuan_tea_plan(tr.scheduler.timesteps, tr.config)
    np.testing.assert_array_equal(plan, j_plan)
    assert tr.timings["calc_steps"] == list(plan) and 0 < sum(plan) < 8, plan
    assert tr.timings["tr_len"] == 4 * 6 and tr.timings["riflex_k"] is None
    assert _rel(t_lat.numpy(), np.asarray(j_lat)) < 1e-2, _rel(t_lat.numpy(), np.asarray(j_lat))


VAE = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, latent_channels=4, norm_num_groups=4)


@pytest.mark.parametrize("noise", [False, True])
def test_vae_encode_vs_jax(noise):
    """``hunyuan_vae_encode`` of 5 frames of 32 x 48 (two strided temporal
    stages, the mid block's frame-causal attention) -> 2 x 4 x 6 latents,
    scaled, at the posterior mean and with noise injected: the JAX sample
    key's normal draws passed to the port. Bar: fp32 convolutions in
    another order, relative L2 1e-4 (the decoder's)."""
    sd = jv.init_random_hunyuan_vae_state_dict(jv.HunyuanVAEConfig(**VAE), seed=0)
    cfg_j, cfg_t = jv.HunyuanVAEConfig(**VAE), tv.HunyuanVAEConfig(**VAE)
    x = np.random.default_rng(2).uniform(-1, 1, (1, 5, 32, 48, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4) if noise else None
    ref = np.asarray(jax.jit(lambda p, x_: jv.hunyuan_vae_encode(p, x_, cfg_j, rng=key))(
        jv.load_hunyuan_vae_params(sd, cfg_j), jnp.asarray(x)))
    eps = torch.from_numpy(np.array(jax.random.normal(key, ref.shape, jnp.float32))) if noise else None
    out = tv.hunyuan_vae_encode(tv.load_hunyuan_vae_params(sd, cfg_t, encoder=True), torch.from_numpy(x), cfg_t,
                                noise=eps)
    assert out.shape == ref.shape == (1, 2, 4, 6, 4)
    assert _rel(out.numpy(), ref) < 1e-4, _rel(out.numpy(), ref)
    if noise:  # the sample moved off the mean by the noise
        mean = tv.hunyuan_vae_encode(tv.load_hunyuan_vae_params(sd, cfg_t, encoder=True), torch.from_numpy(x), cfg_t)
        assert _rel(out.numpy(), mean.numpy()) > 1e-3
