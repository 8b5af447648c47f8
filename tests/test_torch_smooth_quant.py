"""The post-training-quantization loop on the CPU, port vs JAX package:
calibration (``tools/calibrate.py``, the runner's ``do_mm_calib``), the
smooth-quant fold (``tools/convert.py --calib_stats``) and the forward of an
advanced-PTQ checkpoint (the ``affine_norm1`` / ``affine_norm3`` tensors the
loader reads as ``smooth_norm1`` / ``smooth_norm2``).

Tiny arch: dim 256, ffn 512, 2 heads of 128, 2 layers; latents 16x2x4x6
(12 tokens a frame). Bars: the forward of a smoothed int8 dict at the
whole-model bar, relative L2 1e-2 (as ``test_torch_wan_model.py``'s int8
forward); the fold's codes, scales and affine tensors bit for bit (the same
fp32 arithmetic; the smooth factors are numpy on both sides); calibration
stats within 2e-2 of each channel's magnitude (both runs feed bf16
activations through the same blocks; a GEMM's fp32 summation order may move
an activation by one bf16 ulp, 2^-8 relative)."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.models.wan import config as jcfg
from lightx2v_tpu.models.wan import model as jmodel
from lightx2v_tpu.models.wan import weights as jweights
from lightx2v_tpu.models.wan.pipeline import rope_for_shape as j_rope_for_shape
from lightx2v_tpu.tools import calibrate as jcal
from lightx2v_tpu.tools import convert as jconv
from lightx2v_tpu_torch.models.wan import config as tcfg
from lightx2v_tpu_torch.models.wan import lazy_offload as tlazy
from lightx2v_tpu_torch.models.wan import model as tmodel
from lightx2v_tpu_torch.models.wan import streaming as tstream
from lightx2v_tpu_torch.models.wan import weights as tweights
from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape as t_rope_for_shape
from lightx2v_tpu_torch.tools import calibrate as tcal
from lightx2v_tpu_torch.tools import convert as tconv
from lightx2v_tpu_torch.utils import safetensors_io as tst

TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)
SHAPE = (16, 2, 4, 6)
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


def _inputs():
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, *SHAPE)).astype(np.float32)
    ctx = (rng.standard_normal((1, 16, 256)) * 0.5).astype(np.float32)
    return lat, ctx, np.array([750.0], np.float32)


@pytest.fixture(scope="module")
def wd():
    return jweights.init_random_weight_dict(jcfg.WanArch(**TINY), seed=0)


@pytest.fixture(scope="module")
def jstats(wd):
    """The JAX tool's stats on the float dict (one eager forward)."""
    arch = jcfg.WanArch(**TINY)
    lat, ctx, t = _inputs()
    cos, sin, _ = j_rope_for_shape(arch, SHAPE)
    return jcal.collect_block_stats(jweights.load_wan_params(wd, arch), arch, jnp.asarray(lat), jnp.asarray(t),
                                    jnp.asarray(ctx), cos, sin)


@pytest.fixture(scope="module")
def ptq_dict(wd, jstats):
    """The JAX package's advanced-PTQ dict: smooth-quant folded, int8."""
    w = dict(wd)
    jconv.apply_smooth_quant(w, jstats, 0.5)
    return jconv.quantize_model(w, "int8")


def _jax_forward(qwd, rope_fused):
    arch = jcfg.WanArch(**TINY, rope_fused=rope_fused)
    p = jweights.load_wan_params(qwd, arch)
    if rope_fused:
        p = jweights.permute_qk_half(p, arch)
    lat, ctx, t = _inputs()
    cos, sin, _ = j_rope_for_shape(arch, SHAPE)
    return np.asarray(jmodel.wan_forward(p, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx, jnp.bfloat16), cos,
                                         sin, arch, mm_type=INT8), np.float32)


def _port_forward(params, arch):
    lat, ctx, t = _inputs()
    cos, sin, _ = t_rope_for_shape(arch, SHAPE)
    return tmodel.wan_forward(params, torch.from_numpy(lat), torch.from_numpy(t),
                              torch.from_numpy(ctx).to(torch.bfloat16), cos, sin, arch, mm_type=INT8).numpy()


@pytest.mark.parametrize("tier,rope_fused", [("resident", False), ("resident", True), ("disk", False)])
def test_advanced_ptq_forward_vs_jax(ptq_dict, tmp_path, tier, rope_fused):
    """F4: the port reads ``affine_norm1`` / ``affine_norm3`` and applies the
    JAX block's smooth-quant arithmetic in place of the modulated LayerNorm,
    resident (with and without the fused-RoPE permutation) and streamed from
    a blocks-layout checkpoint the JAX converter wrote. The same forward with
    the affine norms dropped (the port before the repair) misses by far."""
    arch = tcfg.WanArch(**TINY, rope_fused=rope_fused)
    ref = _jax_forward(ptq_dict, rope_fused)
    if tier == "resident":
        params = tweights.load_wan_params(ptq_dict, arch)
        if rope_fused:
            params = tweights.permute_qk_half(params, arch)
        assert "smooth_norm1" in params["blocks"][1] and "smooth_norm2" in params["blocks"][1]
        out = _port_forward(params, arch)
        dropped = dict(params, blocks=[{k: v for k, v in b.items() if not k.startswith("smooth")}
                                       for b in params["blocks"]])
        assert _rel(_port_forward(dropped, arch), ref) > 0.1
    else:
        jconv.save_quantized(ptq_dict, str(tmp_path), layout="blocks", scheme="int8", advanced_ptq=True)
        assert json.loads((tmp_path / "config.json").read_text())["quant_method"] == "advanced_ptq"
        store = tlazy.LazyBlockStore(str(tmp_path), arch)
        with tlazy.BlockPrefetcher(store, num_workers=1, pin=False) as pf:
            out = _port_forward(dict(store.small, blocks=tstream.BlockStreamer(pf, "cpu")), arch)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert _rel(out, ref) < 1e-2, _rel(out, ref)


def test_advanced_ptq_per_frame_vs_jax_per_token(ptq_dict):
    """Diffusion forcing's per-frame timesteps on an advanced-PTQ dict: the
    port applies each frame's modulation row in the smooth-quant norms
    (through ``_frames``, as ``_modulate``); the JAX block embeds each
    token's timestep."""
    jarch, tarch = jcfg.WanArch(**TINY), tcfg.WanArch(**TINY)
    lat, ctx, _ = _inputs()
    t_frames = np.array([[20.0, 850.0]], np.float32)
    t_tok = np.repeat(t_frames, SHAPE[2] * SHAPE[3] // 4, axis=1)
    jc, js, _ = j_rope_for_shape(jarch, SHAPE)
    tc, ts, _ = t_rope_for_shape(tarch, SHAPE)
    ref = np.asarray(jmodel.wan_forward(jweights.load_wan_params(ptq_dict, jarch), jnp.asarray(lat), jnp.asarray(t_tok),
                                        jnp.asarray(ctx, jnp.bfloat16), jc, js, jarch, mm_type=INT8), np.float32)
    out = tmodel.wan_forward(tweights.load_wan_params(ptq_dict, tarch), torch.from_numpy(lat),
                             torch.from_numpy(t_frames), torch.from_numpy(ctx).to(torch.bfloat16), tc, ts, tarch,
                             mm_type=INT8).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert _rel(out, ref) < 1e-2, _rel(out, ref)


def test_collect_block_stats_vs_jax(wd, jstats):
    """The port's stats: the JAX tool's 20 names (10 linears a block, in the
    block's call order) and values, the q/k/v inputs equal."""
    arch = tcfg.WanArch(**TINY)
    lat, ctx, t = _inputs()
    cos, sin, _ = t_rope_for_shape(arch, SHAPE)
    stats = tcal.collect_block_stats(tweights.load_wan_params(wd, arch), arch, torch.from_numpy(lat),
                                     torch.from_numpy(t), torch.from_numpy(ctx), cos, sin)
    assert sorted(stats) == sorted(jstats) and len(stats) == 20
    for k, v in jstats.items():
        assert stats[k].dtype == np.float32 and stats[k].shape == v.shape
        np.testing.assert_allclose(stats[k], v, rtol=2e-2, atol=2e-2 * float(v.max()), err_msg=k)
    np.testing.assert_array_equal(stats["blocks.1.self_attn.q"], stats["blocks.1.self_attn.v"])


def test_calibrate_cli_vs_jax(tmp_path, monkeypatch):
    """``python -m lightx2v_tpu_torch.tools.calibrate`` on its small synthetic
    DiT (the JAX tool's weights and inputs) writes the JAX tool's stats."""
    monkeypatch.setattr(sys, "argv", ["calibrate", "--output", str(tmp_path / "jax.npz")])
    jcal.main()
    tcal.main(["--output", str(tmp_path / "port.npz"), "--device", "cpu"])
    js, ts = jcal.load_stats(str(tmp_path / "jax.npz")), tcal.load_stats(str(tmp_path / "port.npz"))
    assert sorted(js) == sorted(ts) and len(ts) == 20
    for k, v in js.items():
        np.testing.assert_allclose(ts[k], v, rtol=2e-2, atol=2e-2 * float(v.max()), err_msg=k)


def test_smooth_factors_vs_jax():
    rng = np.random.default_rng(5)
    w = np.abs(rng.standard_normal(1000)).astype(np.float32) * 0.05
    a = np.abs(rng.standard_normal(1000)).astype(np.float32) * 10
    a[:5] = 0.0
    for alpha in (0.5, 0.8):
        np.testing.assert_array_equal(tcal.smooth_factors(w, a, alpha), jcal.smooth_factors(w, a, alpha))
    s = tcal.smooth_factors(w * 1e-4, a * 1e4)
    assert s.dtype == np.float32 and s.max() == np.float32(1e2)


@pytest.mark.parametrize("scheme", ["int8", "fp8_block128", "mxfp6"])
def test_convert_calib_stats_vs_jax_cli(wd, jstats, tmp_path, monkeypatch, scheme):
    """``convert --calib_stats --smooth_alpha`` of both packages on the same
    files: every tensor (codes, scales, the fp32 affine norms, the untouched
    rest) bit for bit, and ``config.json`` with ``quant_method``."""
    src = tmp_path / "src"
    src.mkdir()
    tst.save_file({k: tst.as_tensor(v).to(torch.bfloat16) for k, v in wd.items()}, str(src / "model.safetensors"))
    tcal.save_stats(jstats, str(tmp_path / "stats.npz"))
    args = ["--source", str(src), "--quant", scheme, "--calib_stats", str(tmp_path / "stats.npz"),
            "--smooth_alpha", "0.6"]
    monkeypatch.setattr(sys, "argv", ["convert"] + args + ["--output", str(tmp_path / "jax")])
    jconv.main()
    tconv.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    jout = tst.load_file(str(tmp_path / "jax" / "model.safetensors"))
    tout = tst.load_file(str(tmp_path / "port" / "model.safetensors"))
    assert sorted(jout) == sorted(tout)
    assert {"blocks.0.affine_norm1.weight", "blocks.1.affine_norm3.bias"} <= set(tout)
    for k in jout:
        assert jout[k].dtype == tout[k].dtype and torch.equal(jout[k].view(torch.uint8), tout[k].view(torch.uint8)), k
    assert tout["blocks.0.affine_norm1.weight"].dtype == torch.float32
    for d in ("jax", "port"):
        cfg = json.loads((tmp_path / d / "config.json").read_text())
        assert cfg == {"mm_type": jconv.mm_type_for_scheme(scheme), "quant_method": "advanced_ptq"}


def _runner_cfg(**over):
    return dict(model_cls="wan2.1_distill", task="t2v", synthetic_weights=True, prompt="a red panda climbing",
                seed=42, enable_cfg=False, target_video_length=5, target_height=64, target_width=96, sample_shift=5,
                rope_fused=True, latent_init="torch", denoising_step_list=[1000], dim=256,
                ffn_dim=512, num_heads=2, num_layers=2, text_dim=256, text_len=64, self_attn_1_type="flash_attn3",
                cross_attn_1_type="flash_attn3", do_mm_calib=True, **over)


def test_runner_do_mm_calib_vs_jax(tmp_path):
    """``do_mm_calib``: the port's runner writes the stats of one forward at
    the first timestep before its denoise (``run_pipeline``), and they are
    the JAX runner's (same prompt, latents from the same torch stream); on
    the host-RAM tier too."""
    from lightx2v_tpu.runners.wan_runner import WanDistillRunner as JRunner
    from lightx2v_tpu.utils.config import set_config as jset
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    jr = JRunner(jset(_runner_cfg(calib_output_path=str(tmp_path / "jax.npz"))))
    jr._collect_calib_stats(jr.run_input_encoder())
    tr = tinfer.init_runner(tset(_runner_cfg(calib_output_path=str(tmp_path / "port.npz"), device="cpu")))
    frames = tr.run_pipeline(save_video=False)
    assert np.isfinite(frames).all() and len(tr.timings["step_s"]) == 1
    js, ts = jcal.load_stats(str(tmp_path / "jax.npz")), tcal.load_stats(str(tmp_path / "port.npz"))
    assert sorted(js) == sorted(ts) and len(ts) == 20
    for k, v in js.items():
        np.testing.assert_allclose(ts[k], v, rtol=2e-2, atol=2e-2 * float(v.max()), err_msg=k)
    # the host-RAM tier streams its blocks through the same calibration: the same stats, bit for bit
    off = tinfer.init_runner(tset(_runner_cfg(calib_output_path=str(tmp_path / "off.npz"), device="cpu",
                                              cpu_offload=True)))
    stats = off.collect_calib_stats(off.run_input_encoder())
    assert sorted(stats) == sorted(ts) and all(np.array_equal(stats[k], ts[k]) for k in ts)


def test_do_mm_calib_refusals(tmp_path):
    """A quantized mm_type's weights are codes without their scales, which
    the Default calibration GEMM would multiply (difference au): the port
    raises. The disk tier holds no blocks the JAX runner could calibrate:
    the port raises there too."""
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    with pytest.raises(ValueError, match="difference au"):
        tinfer.init_runner(tset(_runner_cfg(device="cpu", mm_config={"mm_type": INT8})))
    with pytest.raises(NotImplementedError, match="lazy_load.*difference au"):
        tinfer.init_runner(tset(_runner_cfg(device="cpu", lazy_load=True, dit_quantized_ckpt=str(tmp_path))))
