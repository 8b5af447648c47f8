"""The bench flagship's pieces on the CPU, port vs JAX package: the int8
UMT5 encoder, int4 weight loading, one small Wan forward under int4a8 with
Sparge (per-layer l1, dense prefix), and the port's runner end to end on
the flagship overrides at a tiny width.

The JAX package's CPU fallbacks differ from the TPU kernels the port
follows (pinned in test_torch_w4a8.py and test_torch_sparge.py): int4a8
linears run weight-only with bf16 activations there, and Sparge runs a
dense-masked fp32 softmax. The whole forward therefore gets a relative-L2
bar: measured 5.8e-3 here; bar 2e-2."""

import json
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
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

ROOT = Path(__file__).resolve().parents[1]
INT4 = "W-int4-group-sym-A-int8-token-dynamic-Tpu"
TABLE = str(ROOT / "configs/sparge/wan_t2v_14b_structured_keep03.npz")
T5_SMALL = dict(vocab_size=4096, dim=256, dim_attn=256, dim_ffn=512, num_heads=8, num_layers=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run thousands of small ops; one intra-op thread is as
    fast alone and does not oversubscribe the cores when the suite runs in
    several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def test_int8_t5_encode_matches_jax():
    """The same quantize_t5_params codes on both sides, then t5_encode.
    At these widths both run per-token int8 linears in plain ops, identical
    for identical inputs; bf16 noise from the attention moves activations
    across code boundaries, which compounds over the blocks: measured 1.5e-2
    relative L2, bar 3e-2."""
    sd = jt5.init_random_t5_state_dict(jt5.T5Config(**T5_SMALL), seed=1)
    jp = jt5.quantize_t5_params(jt5.load_t5_params(sd, jt5.T5Config(**T5_SMALL)), "int8")
    tp = tt5.quantize_t5_params(tt5.load_t5_params(sd, tt5.T5Config(**T5_SMALL)), "int8")
    for name in tt5.T5_LINEARS:
        np.testing.assert_array_equal(np.asarray(jp["blocks"][name]["w"][1]), tp["blocks"][1][name]["w"].numpy())
        np.testing.assert_array_equal(np.asarray(jp["blocks"][name]["w_scale"][1]),
                                      tp["blocks"][1][name]["w_scale"].numpy())
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 4096, (2, 64)).astype(np.int32)
    mask = np.zeros((2, 64), np.int32)
    mask[0, :20], mask[1, :45] = 1, 1
    ref = jt5.t5_encode(jp, jnp.asarray(ids), jnp.asarray(mask), jt5.T5Config(**T5_SMALL))
    out = tt5.t5_encode(tp, torch.from_numpy(ids), torch.from_numpy(mask), tt5.T5Config(**T5_SMALL))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 64, 256)
    assert float(out[0, 20:].abs().max()) == 0.0
    assert _rel(out.float().numpy(), np.asarray(ref, np.float32)) < 3e-2


def test_synthetic_int8_t5_layout():
    cfg = tt5.T5Config(**T5_SMALL)
    p = tt5.init_random_t5_params_on_device(cfg, seed=1, device="cpu", scheme="int8")
    fc2 = p["blocks"][0]["fc2"]
    assert fc2["w"].dtype == torch.int8 and fc2["w"].shape == (256, 512) and fc2["w_scale"].shape == (256,)
    out = tt5.t5_encode(p, torch.ones((1, 8), dtype=torch.int64), torch.ones((1, 8), dtype=torch.int64), cfg)
    assert torch.isfinite(out.float()).all()


ARCH = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=3, text_dim=256)
SHAPE = (16, 5, 20, 20)  # 500 tokens


@pytest.fixture(scope="module")
def wd4():
    return jconvert.quantize_model(jweights.init_random_weight_dict(jcfg.WanArch(**ARCH), seed=0), "int4")


def test_int4_load_and_permute_match(wd4):
    """uint8 nibbles keep their 2-D (out, groups) scales; permute_qk_half
    moves the packed rows and the scale rows together."""
    arch = tcfg.WanArch(**ARCH, rope_fused=True)
    jp = jweights.permute_qk_half(jweights.load_wan_params(wd4, jcfg.WanArch(**ARCH, rope_fused=True)), arch)
    tp = tweights.permute_qk_half(tweights.load_wan_params(wd4, arch), arch)
    for name in ("q", "k", "o"):
        jl, tl = jp["blocks"]["self_attn"][name], tp["blocks"][2]["self_attn"][name]
        assert tl["w"].dtype == torch.uint8 and tl["w_scale"].shape == (256, 1)
        np.testing.assert_array_equal(np.asarray(jl["w"][2]), tl["w"].numpy())
        np.testing.assert_array_equal(np.asarray(jl["w_scale"][2]), tl["w_scale"].numpy())


def test_int4_sparge_forward_matches_jax(wd4):
    """3 blocks: block 0 dense (dense_prefix 1), blocks 1-2 Sparge at their
    own l1 (fp32 table values), 128-token superblocks so the selection is
    not trivial at 500 tokens; rope_fused, int4a8 linears."""
    jarch = jcfg.WanArch(**ARCH, rope_fused=True)
    tarch = tcfg.WanArch(**ARCH, rope_fused=True)
    jp = jweights.permute_qk_half(jweights.load_wan_params(wd4, jarch), jarch)
    tp = tweights.permute_qk_half(tweights.load_wan_params(wd4, tarch), tarch)
    l1 = [float(x) for x in np.array([0.0, 0.3, 0.1], np.float32)]
    kw = dict(keep_ratio=0.5, l1=0.07, block_q=128, block_k=128, l1_per_layer=l1, dense_prefix=1)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, *SHAPE)).astype(np.float32)
    ctx = (rng.standard_normal((1, 512, 256)) * 0.5).astype(np.float32)
    ctx[:, 40:] = 0.0
    t = np.array([750.0], np.float32)
    jc, js, _ = j_rope_for_shape(jarch, SHAPE)
    tc, ts, _ = t_rope_for_shape(tarch, SHAPE)
    ref = np.asarray(jmodel.wan_forward(jp, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx, jnp.bfloat16), jc, js,
                                        jarch, mm_type=INT4, self_attn_type="sparge", self_attn_kwargs=dict(kw)),
                     np.float32)
    out = tmodel.wan_forward(tp, torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx).to(torch.bfloat16),
                             tc, ts, tarch, mm_type=INT4, self_attn_type="sparge",
                             self_attn_kwargs=dict(kw)).numpy()
    assert out.shape == ref.shape == (1, 16, 5, 20, 20) and np.isfinite(out).all()
    assert _rel(out, ref) < 2e-2, _rel(out, ref)


FLAGSHIP = dict(mm_config={"mm_type": INT4}, sparge=True, sparge_keep_ratio=0.3, sparge_ckpt=TABLE,
                sparse_block_q=2048, sparse_block_k=1024, t5_quantized=True, use_tiling_vae=False)


def test_flagship_runner_tiny_on_cpu():
    """The deploy config with the flagship overrides, widths cut to dim 256
    (40 blocks, so the tuned table applies); 9 frames of 64x96."""
    from lightx2v_tpu.runners.wan_runner import WanRunner as JRunner
    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.utils.config import set_config

    cfg = json.loads((ROOT / "configs/deploy/wan_t2v.json").read_text())
    cfg.update(FLAGSHIP, dim=256, ffn_dim=512, num_heads=2, text_dim=256, text_len=64, target_video_length=9,
               target_height=64, target_width=96, model_cls="wan2.1_distill", synthetic_weights=True,
               device="cpu", prompt="a red panda")
    r = infer.init_runner(set_config(cfg))
    attn, cross, kw = r._self_attn_setup()
    j_attn, j_cross, j_kw = JRunner._self_attn_setup(SimpleNamespace(config=dict(cfg), arch=r.arch))
    assert (attn, cross, kw) == (j_attn, j_cross, j_kw) == (attn, "flash_attn3", kw)
    assert kw["dense_prefix"] == 1 and len(kw["l1_per_layer"]) == 40 and kw["block_q"] == 2048
    blk = r.model["blocks"][0]
    assert blk["ffn"]["0"]["w"].dtype == torch.uint8 and blk["ffn"]["0"]["w_scale"].ndim == 2
    assert r.text_encoder.params["blocks"][0]["fc2"]["w"].dtype == torch.int8
    frames = r.run_pipeline(save_video=False)
    assert frames.shape == (9, 64, 96, 3) and np.isfinite(frames).all()
    assert len(r.timings["step_s"]) == 4


def test_vae_decode_caches_hold_only_their_frames():
    """The flagship decodes untiled, where a cache that is a view of its
    conv's whole input stream kept tens of GB alive at 480P: every cache on
    the tape owns just its CACHE_T frames."""
    from lightx2v_tpu_torch.vae import wan_vae as tvae

    cfg = tvae.WanVAEConfig(dim=16, z_dim=16, dim_mult=(1, 2, 2, 2), num_res_blocks=1)
    params = tvae.load_wan_vae_params(tvae.init_random_vae_state_dict(cfg, seed=2), cfg)
    z = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 16, 3, 4, 4)).astype(np.float32))
    tape = tvae.CacheTape(None)
    tvae.decoder_chunk(params["decoder"], cfg, z[:, :, :1], tape, first=True)
    tape = tvae.CacheTape(tape.new)
    tvae.decoder_chunk(params["decoder"], cfg, z[:, :, 1:], tape, first=False)
    assert len(tape.new) > 10
    for c in tape.new:
        assert c.shape[2] == tvae.CACHE_T
        assert c.untyped_storage().nbytes() == c.numel() * c.element_size()
