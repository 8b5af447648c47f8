"""The fp8 (e4m3) path of the port on the CPU, against the JAX package: the
per-channel fp8 quantizer and its cast, the loader on a JAX fp8 dict, a tiny
fp8 Wan forward, the fp8 UMT5 encoder, the runner on a tiny
LightX2V_3-Distill-style config, and the config keys the runner refuses.

The e4m3 casts: torch and ``ml_dtypes`` (the JAX side) round to nearest even
and agree bit for bit inside +-448; past it torch saturates to 448 and
``ml_dtypes`` gives NaN from 464 up (difference "m" in ROADMAP.md). The
quantizers and the activation scales never leave the range, and the port's
synthesizers clip before the cast."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lightx2v_tpu.encoders import t5 as jt5
from lightx2v_tpu.models.wan import config as jcfg
from lightx2v_tpu.models.wan import model as jmodel
from lightx2v_tpu.models.wan import weights as jweights
from lightx2v_tpu.models.wan.pipeline import rope_for_shape as j_rope_for_shape
from lightx2v_tpu.tools import convert as jconvert
from lightx2v_tpu_torch.encoders import t5 as tt5
from lightx2v_tpu_torch.models.wan import config as tcfg
from lightx2v_tpu_torch.models.wan import model as tmodel
from lightx2v_tpu_torch.models.wan import weights as tweights
from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape as t_rope_for_shape
from lightx2v_tpu_torch.tools import convert as tconvert

FP8 = "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Tpu"
TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)
SHAPE = (16, 5, 20, 20)
T5_SMALL = dict(vocab_size=4096, dim=256, dim_attn=256, dim_ffn=512, num_heads=8, num_layers=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Thousands of small ops: one intra-op thread keeps the suite's worker
    processes from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("scale,shape", [(0.05, (64, 300)), (1e-3, (32, 128)), (30.0, (8, 5120))])
def test_quantize_tensor_fp8_matches_jax(scale, shape):
    """Codes bit for bit and scales exactly, against the JAX converter's
    ``ml_dtypes`` cast (rows with a wide spread reach the subnormal codes)."""
    rng = np.random.default_rng(shape[1])
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    w[0, :7] = [0.0, 1e-9, -1e-9, 5e-6, 0.0, 0.0, 0.0]
    q, s = tconvert.quantize_weight(torch.from_numpy(w), "fp8")
    jq, js = jconvert.quantize_tensor(w, "fp8")
    assert q.dtype == torch.float8_e4m3fn and s.dtype == torch.float32 and s.shape == (shape[0],)
    np.testing.assert_array_equal(_bits(q), _bits(jq))
    np.testing.assert_array_equal(s.numpy(), js)
    assert (_bits(q) & 0x78 == 0).any()  # subnormal codes among them


def test_fp8_casts_agree_in_range():
    """torch's and ml_dtypes' e4m3 casts give the same bits on 1M values of
    normal * 100 clipped to +-448 and on values of order 1e-3 (subnormal
    codes)."""
    rng = np.random.default_rng(0)
    a = np.clip(rng.standard_normal(1 << 20).astype(np.float32) * 100, -448, 448)
    b = (rng.standard_normal(1 << 18) * 1e-3).astype(np.float32)
    for v in (a, b):
        np.testing.assert_array_equal(_bits(torch.from_numpy(v).to(torch.float8_e4m3fn)),
                                      _bits(v.astype(ml_dtypes.float8_e4m3fn)))


def test_fp8_cast_difference_m():
    """Difference "m": past 448 torch saturates, ml_dtypes gives NaN from
    464 up (464 itself still rounds to 448). The port clips synthetic fp8
    weights before the cast, and no kernel meets the difference."""
    v = np.array([448.0, 460.0, 464.0, 470.0, 1e4, -500.0], np.float32)
    t = torch.from_numpy(v).to(torch.float8_e4m3fn).float().numpy()
    j = v.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    np.testing.assert_array_equal(t, [448, 448, 448, 448, 448, -448])
    np.testing.assert_array_equal(j[:3], [448, 448, 448])
    assert np.isnan(j[3:]).all()


@pytest.fixture(scope="module")
def wd8():
    return jconvert.quantize_model(jweights.init_random_weight_dict(jcfg.WanArch(**TINY), seed=0), "fp8")


def test_loader_carries_jax_fp8_dict(wd8):
    """A JAX ``quantize_model(wd, "fp8")`` dict (ml_dtypes arrays) loads as
    float8_e4m3fn tensors with their bits, not as fp32 weights; the port's
    own quantize_model gives the same codes as torch tensors."""
    arch = tcfg.WanArch(**TINY, rope_fused=True)
    tp = tweights.permute_qk_half(tweights.load_wan_params(wd8, arch), arch)
    jp = jweights.permute_qk_half(jweights.load_wan_params(wd8, jcfg.WanArch(**TINY, rope_fused=True)), arch)
    for i in range(arch.num_layers):
        for path in (("self_attn", "q"), ("cross_attn", "v"), ("ffn", "2")):
            tl, jl = tp["blocks"][i][path[0]][path[1]], jp["blocks"][path[0]][path[1]]
            assert tl["w"].dtype == torch.float8_e4m3fn and tl["w_scale"].dtype == torch.float32
            np.testing.assert_array_equal(_bits(tl["w"]), _bits(np.asarray(jl["w"][i])))
            np.testing.assert_array_equal(tl["w_scale"].numpy(), np.asarray(jl["w_scale"][i]))
    assert tp["text_embedding"]["0"]["w"].dtype == torch.bfloat16  # pre/post linears stay unquantized
    twd = tconvert.quantize_model(tweights.init_random_weight_dict(tcfg.WanArch(**TINY), seed=0), "fp8")
    key = "blocks.1.ffn.0.weight"
    assert twd[key].dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bits(twd[key]), _bits(wd8[key]))


def test_fp8_wan_forward_matches_jax(wd8):
    """A tiny fp8 forward from the same JAX fp8 dict. At these widths both
    packages run the per-token e4m3 path in plain ops (scale absmax / 448,
    exact products); bf16 noise moves activations across code boundaries,
    and e4m3's 4 significant bits make each move larger than int8's.
    Whole-model bar of test_torch_wan_model.py: relative L2 1e-2."""
    jarch, tarch = jcfg.WanArch(**TINY, rope_fused=True), tcfg.WanArch(**TINY, rope_fused=True)
    jp = jweights.permute_qk_half(jweights.load_wan_params(wd8, jarch), jarch)
    tp = tweights.permute_qk_half(tweights.load_wan_params(wd8, tarch), tarch)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, *SHAPE)).astype(np.float32)
    ctx = (rng.standard_normal((1, 512, 256)) * 0.5).astype(np.float32)
    ctx[:, 40:] = 0.0
    t = np.array([750.0], np.float32)
    jc, js, _ = j_rope_for_shape(jarch, SHAPE)
    tc, ts, _ = t_rope_for_shape(tarch, SHAPE)
    ref = np.asarray(jmodel.wan_forward(jp, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx, jnp.bfloat16), jc, js,
                                        jarch, mm_type=FP8), np.float32)
    out = tmodel.wan_forward(tp, torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx).to(torch.bfloat16),
                             tc, ts, tarch, mm_type=FP8).numpy()
    assert out.shape == ref.shape == (1, *SHAPE) and np.isfinite(out).all()
    assert _rel(out, ref) < 1e-2, _rel(out, ref)


def test_fp8_t5_encode_matches_jax():
    """The same fp8 ``quantize_t5_params`` codes on both sides, then
    t5_encode through the per-token e4m3 linears. bf16 noise between the
    packages moves activations across code boundaries, as in the int8 T5
    test (measured 1.5e-2 there, bar 3e-2), and a crossing moves an e4m3
    code by up to 1/8 of its value: measured 4.0e-2 relative L2 here, while
    the JAX side alone is 7.2e-2 from the unquantized encoder. Bar 6e-2, and
    the two packages must sit closer to each other than 0.8x that
    quantization error."""
    cfg_j, cfg_t = jt5.T5Config(**T5_SMALL), tt5.T5Config(**T5_SMALL)
    sd = jt5.init_random_t5_state_dict(cfg_j, seed=1)
    jbase = jt5.load_t5_params(sd, cfg_j)
    jp = jt5.quantize_t5_params(jbase, "fp8")
    tp = tt5.quantize_t5_params(tt5.load_t5_params(sd, cfg_t), "fp8")
    for name in tt5.T5_LINEARS:
        assert tp["blocks"][1][name]["w"].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(_bits(tp["blocks"][1][name]["w"]), _bits(np.asarray(jp["blocks"][name]["w"][1])))
        np.testing.assert_array_equal(tp["blocks"][1][name]["w_scale"].numpy(),
                                      np.asarray(jp["blocks"][name]["w_scale"][1]))
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 4096, (2, 64)).astype(np.int32)
    mask = np.zeros((2, 64), np.int32)
    mask[0, :20], mask[1, :45] = 1, 1
    ref = np.asarray(jt5.t5_encode(jp, jnp.asarray(ids), jnp.asarray(mask), cfg_j), np.float32)
    base = np.asarray(jt5.t5_encode(jbase, jnp.asarray(ids), jnp.asarray(mask), cfg_j), np.float32)
    out = tt5.t5_encode(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg_t)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 64, 256)
    assert float(out[0, 20:].abs().max()) == 0.0
    apart, quant_err = _rel(out.float().numpy(), ref), _rel(ref, base)
    assert apart < 6e-2 and apart < 0.8 * quant_err, (apart, quant_err)


def test_synthetic_fp8_layouts():
    """The device synthesizers' fp8 scheme: e4m3 codes of normal * 100
    clipped to +-448 (no NaN), per-channel scales scale/100, for the DiT's
    block linears and the T5's seven."""
    cfg = tt5.T5Config(**T5_SMALL)
    p = tt5.init_random_t5_params_on_device(cfg, seed=1, device="cpu", scheme="fp8")
    fc2 = p["blocks"][0]["fc2"]
    assert fc2["w"].dtype == torch.float8_e4m3fn and fc2["w"].shape == (256, 512)
    torch.testing.assert_close(fc2["w_scale"], torch.full((256,), 0.02 / 100))
    out = tt5.t5_encode(p, torch.ones((1, 8), dtype=torch.int64), torch.ones((1, 8), dtype=torch.int64), cfg)
    assert torch.isfinite(out.float()).all()
    params = tweights.init_random_params_on_device(tcfg.WanArch(**TINY), "fp8", seed=0, device="cpu")
    w = params["blocks"][1]["ffn"]["0"]["w"]
    assert w.dtype == torch.float8_e4m3fn and w.shape == (512, 256)
    wf = w.float()
    assert torch.isfinite(wf).all() and float(wf.abs().max()) <= 448.0 and 80 < float(wf.std()) < 120
    assert params["blocks"][0]["self_attn"]["o"]["w_scale"].shape == (256,)


def _tiny_distill_config(**over):
    from lightx2v_tpu_torch.utils.config import set_config

    cfg = dict(model_cls="wan2.1_distill", task="t2v", device="cpu", synthetic_weights=True, enable_cfg=False,
               target_video_length=9, target_height=64, target_width=96, sample_shift=5, rope_fused=True,
               denoising_step_list=[1000, 750, 500, 250], use_tiling_vae=True, mm_config={"mm_type": FP8},
               t5_quantized=True, t5_quant_scheme="fp8", prompt="a red panda")
    cfg.update(over)
    return set_config(cfg)


def test_fp8_distill_runner_tiny_on_cpu():
    """The LightX2V_3-Distill keys (fp8 DiT, fused-RoPE flash, 4 distill
    steps, tiled decode) with the fp8 T5, at the runner's small synthetic
    widths: every block linear and every T5 linear is e4m3, and the run ends
    in finite frames."""
    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.runners import wan_runner

    assert wan_runner._SCHEMES["fp8"] == "fp8"
    runner = infer.init_runner(_tiny_distill_config())
    assert runner.mm_type == FP8
    blk = runner.model["blocks"][0]
    assert {blk[a][m]["w"].dtype for a in ("self_attn", "cross_attn") for m in "qkvo"} == {torch.float8_e4m3fn}
    assert blk["ffn"]["0"]["w"].dtype == blk["ffn"]["2"]["w"].dtype == torch.float8_e4m3fn
    assert {runner.text_encoder.params["blocks"][1][n]["w"].dtype for n in tt5.T5_LINEARS} == {torch.float8_e4m3fn}
    frames = runner.run_pipeline(save_video=False)
    assert frames.shape == (9, 64, 96, 3) and np.isfinite(frames).all()
    assert len(runner.timings["step_s"]) == 4


@pytest.mark.parametrize("key,item", [("do_mm_calib", "Queue 1 item 12"), ("mesh_shape", "Queue 1 item 14")])
def test_unported_config_keys_raise(key, item):
    """Keys the JAX runner honours and the port does not: the runner refuses
    them, naming their ROADMAP.md item, rather than run as if absent."""
    from lightx2v_tpu_torch import infer

    with pytest.raises(NotImplementedError, match=item):
        infer.init_runner(_tiny_distill_config(mm_config={}, t5_quantized=False, **{key: True}))
