"""The HunyuanVideo text-to-video slice on the CPU, port vs JAX package: the
state dict and the RoPE tables, the MMDiT forward with a padded text mask
(so the joint attention's kv_len is below its key count), the flow-match
Euler schedule and steps, the small synthetic runner end to end, and the
runner's refusals. Weights come from the host numpy state dict that both
packages build identically; inputs from numpy seeds. The JAX side runs its
plain attention (``attn_type="xla"``); the port's DiT runs ``flash_attn3``,
the dense flash kernel's plain version on the CPU, at head dim 128 with the
real ``rope_dim_list`` (16, 56, 56)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.models.hunyuan import config as jc
from lightx2v_tpu.models.hunyuan import model as jm
from lightx2v_tpu.models.hunyuan import weights as jw
from lightx2v_tpu.schedulers.euler import FlowMatchEulerScheduler as JEuler
from lightx2v_tpu.utils.config import set_config as jset
from lightx2v_tpu_torch.models.hunyuan import config as tc
from lightx2v_tpu_torch.models.hunyuan import model as tm
from lightx2v_tpu_torch.models.hunyuan import weights as tw
from lightx2v_tpu_torch.schedulers.euler import FlowMatchEulerScheduler as TEuler
from lightx2v_tpu_torch.utils.config import set_config as tset

ARCH = dict(hidden_size=256, heads_num=2, double_blocks=1, single_blocks=1, mlp_hidden_dim=512, text_states_dim=64,
            text_states_dim_2=32)


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


def test_state_dict_and_rope_match_jax():
    """The host state dict and the RoPE tables are the JAX package's, value
    for value (the tables at the real dims (16, 56, 56), theta 256)."""
    jsd = jw.init_random_hunyuan_state_dict(jc.HunyuanArch(**ARCH), seed=3, scale=0.05)
    tsd = tw.init_random_hunyuan_state_dict(tc.HunyuanArch(**ARCH), seed=3, scale=0.05)
    assert set(jsd) == set(tsd)
    for k in jsd:
        np.testing.assert_array_equal(tsd[k], np.asarray(jsd[k], np.float32), err_msg=k)
    for grid in ((2, 4, 4), (22, 3, 5)):
        for a, b in zip(tm.build_hunyuan_rope(tc.HunyuanArch(**ARCH), *grid),
                        jm.build_hunyuan_rope(jc.HunyuanArch(**ARCH), *grid)):
            assert a.shape == (int(np.prod(grid)), 64)
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def dit():
    ja, ta = jc.HunyuanArch(**ARCH), tc.HunyuanArch(**ARCH)
    sd = jw.init_random_hunyuan_state_dict(ja, seed=3, scale=0.05)
    return ja, ta, jw.load_hunyuan_params(sd, ja), tw.load_hunyuan_params(sd, ta)


def _inputs(seed=0, lt=12, valid=7):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, 16, 2, 8, 8)).astype(np.float32)
    states = (rng.standard_normal((1, lt, ARCH["text_states_dim"])) * 0.5).astype(np.float32)
    mask = np.zeros((1, lt), np.int32)
    mask[0, :valid] = 1
    pooled = (rng.standard_normal((1, ARCH["text_states_dim_2"])) * 0.5).astype(np.float32)
    return lat, np.array([700.0], np.float32), states, mask, pooled


def _port_forward(tp, ta, lat, t, states, mask, pooled, attn_type="flash_attn3"):
    cos, sin = (torch.from_numpy(a) for a in tm.build_hunyuan_rope(ta, 2, 4, 4))
    return tm.HunyuanTransformer(tp, ta, attn_type)(
        torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(states), torch.from_numpy(mask),
        torch.from_numpy(pooled), cos, sin, tm.text_kv_len(32, mask), guidance=torch.tensor([6000.0]))


def test_forward_padded_text_vs_jax(dit):
    """hunyuan_forward with 7 of 12 text tokens valid: kv_len 39 of 44 keys
    in the joint attention, padded refiner rows kept finite by the forced
    key column 0. Bar: relative L2 1e-2 on the fp32 prediction (bf16
    activations; the JAX plain attention is an fp32 softmax, the port's the
    flash kernel's plain version with q and P rounded to bf16; measured
    4.5-4.8e-3 over four seeds, the port's plain attention alike). The
    padded text states do not reach the output."""
    ja, ta, jp, tp = dit
    lat, t, states, mask, pooled = _inputs()
    cos, sin = jm.build_hunyuan_rope(ja, 2, 4, 4)
    fwd = jax.jit(lambda p, *a: jm.hunyuan_forward(p, *a, arch=ja, guidance=jnp.asarray([6000.0]), attn_type="xla"))
    ref = np.asarray(fwd(jp, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(states), jnp.asarray(mask),
                         jnp.asarray(pooled), jnp.asarray(cos), jnp.asarray(sin)), np.float32)
    out = _port_forward(tp, ta, lat, t, states, mask, pooled)
    assert out.shape == lat.shape and out.dtype == torch.float32
    assert np.isfinite(ref).all() and tm.text_kv_len(32, mask) == 39
    assert _rel(out.numpy(), ref) < 1e-2, _rel(out.numpy(), ref)
    states2 = states.copy()
    states2[0, 7:] += 3.0
    torch.testing.assert_close(_port_forward(tp, ta, lat, t, states2, mask, pooled), out, rtol=0, atol=0)


def test_euler_vs_jax():
    """configs/hunyuan_t2v.json's schedule (50 steps, shift 7): the same
    sigmas, timesteps and latents, and every Euler step on the same
    predictions. Bar: fp32 elementwise, 1e-6."""
    cfg = dict(infer_steps=50, sample_shift=7.0, latent_init="torch")
    js, ts = JEuler(jset(dict(cfg))), TEuler(tset(dict(cfg)))
    shape = (16, 3, 4, 6)
    jst = js.prepare(shape, 42)
    tst = ts.prepare(shape, torch.Generator().manual_seed(42))
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    assert ts.sigmas[0] == 1.0 and ts.sigmas[-1] == 0.0 and len(ts.timesteps) == 50
    np.testing.assert_array_equal(tst["latents"].numpy(), np.asarray(jst["latents"]))
    rng = np.random.default_rng(1)
    step = jax.jit(js.step_post)
    for i in range(50):
        lat, t = ts.step_pre(tst)
        assert float(t[0]) == ts.timesteps[i]
        pred = rng.standard_normal(shape).astype(np.float32)
        jst = step(jst, jnp.asarray(pred))
        tst = ts.step_post(tst, torch.from_numpy(pred))
    assert tst["step_index"] == 50
    np.testing.assert_allclose(tst["latents"].numpy(), np.asarray(jst["latents"]), rtol=1e-6, atol=1e-6)


CFG = dict(model_cls="hunyuan", task="t2v", prompt="a red panda climbing a bamboo tree", latent_init="torch")


def test_small_synthetic_runner_vs_jax():
    """configs/hunyuan_t2v_synthetic_smoke.json on both packages in one
    process (the random text states draw from Python's salted hash of the
    prompt): the same states, mask and pooled vector; 2 Euler steps of the
    small DiT (head dim 24, plain attention on both sides, kv_len = 72 image
    + 9 text tokens); the untiled decode of 3 latent frames. Bars: relative
    L2 1e-2 on the latents and the frames (bf16 DiT noise; measured over
    three hash seeds 1.3-1.5e-3 and 4.8-5.1e-3)."""
    from lightx2v_tpu.runners.hunyuan_runner import HunyuanRunner as JRunner
    from lightx2v_tpu_torch import infer as tinfer

    smoke = "configs/hunyuan_t2v_synthetic_smoke.json"
    jr = JRunner(jset(dict(CFG, config_json=smoke)))
    tr = tinfer.init_runner(tset(dict(CFG, config_json=smoke, device="cpu")))
    assert tr.arch.head_dim == jr.arch.head_dim == 24 and tr.text_encoder is None
    j_enc, t_enc = jr.run_input_encoder(), tr.run_input_encoder()
    for key in ("text_encoder_1_text_states", "text_encoder_1_attention_mask", "text_encoder_2_text_states"):
        np.testing.assert_array_equal(np.asarray(t_enc["text_encoder_output"][key]),
                                      np.asarray(j_enc["text_encoder_output"][key]))
    j_lat, t_lat = jr.run_dit(j_enc), tr.run_dit(t_enc)
    assert tuple(tr.set_target_shape()) == (16, 3, 8, 12) and tr.timings["kv_len"] == 72 + 9
    assert len(tr.timings["step_s"]) == 2
    assert _rel(t_lat.numpy(), np.asarray(j_lat)) < 1e-2, _rel(t_lat.numpy(), np.asarray(j_lat))
    j_frames, t_frames = jr.run_vae_decoder(j_lat), tr.run_vae_decoder(t_lat)
    assert t_frames.shape == j_frames.shape == (9, 64, 96, 3) and np.isfinite(t_frames).all()
    assert _rel(t_frames, j_frames) < 1e-2, _rel(t_frames, j_frames)


@pytest.mark.parametrize("extra,err,match", [
    (dict(task="i2v"), NotImplementedError, "item 16"),
    (dict(feature_caching="Tea"), NotImplementedError, "item 16"),
    (dict(mesh_shape={"seq": 2}), NotImplementedError, "item 14"),
    (dict(text_encoder_path="/nonexistent"), NotImplementedError, "item 16"),
    (dict(text_encoder_crop_start=95), NotImplementedError, "item 16"),
    (dict(synthetic_weights=False, model_path="/nonexistent"), NotImplementedError, "real weights"),
    (dict(mm_config={"mm_type": "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"}), ValueError, "Default"),
    (dict(hidden_size=1536), ValueError, "3072"),
])
def test_runner_refusals(extra, err, match):
    """What the port's Hunyuan runner does not run raises before any weight
    is made: i2v, Tea and the HF text encoders (``text_encoder_path``,
    ``text_encoder_crop_start``; Queue 1 item 16), Ulysses (item 14), real weights
    (the HF text encoders), a quantized mm_type (the JAX runner runs
    Default whatever it says), a width other than HunyuanArch()'s."""
    from lightx2v_tpu_torch import infer as tinfer

    with pytest.raises(err, match=match):
        tinfer.init_runner(tset({**CFG, "synthetic_weights": True, "device": "cpu", **extra}))
