"""The i2v path on the CPU, port vs JAX package: the image conditioning of
the DiT and the ``wan2.1_distill`` runner's stages (the VAE encoder alone:
``test_torch_vae_encode.py``).

DiT: dim 256, ffn 512, 2 heads of 128, 2 layers, 36 input channels,
latents 16x3x8x12 (72 tokens) with ``y`` of 20 channels and 257 CLIP
tokens of 1280, from ``init_random_weight_dict`` with the i2v keys, bf16
activations. Bars as the t2v forwards: relative L2 1e-2 for the image
embedding and a forward (measured 1.8e-4, 4.7e-3), 5e-2 for the combined
CFG output, which carries 5x and 4x its rows' differences
(``test_torch_cfg.py``; measured 2.4e-2).

Runner: 9 frames of 64x96 (latents 16x3x8x12), a 2-entry step list, a PNG
at the target size written by the test, the JAX runner's zero CLIP tokens
(small synthetic mode), the same host weights, the initial latents from one
CPU torch stream and the JAX scheduler's re-noise draws injected into the
port. Bar: relative L2 1e-2 on the context, y, the latents and the frames,
as slice 1's (``test_torch_slice.py``; measured 5.1e-3, 3.5e-8, 1.5e-3,
1.2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.models.wan import config as jcfg
from lightx2v_tpu.models.wan import model as jmodel
from lightx2v_tpu.models.wan import weights as jweights
from lightx2v_tpu.models.wan.pipeline import rope_for_shape as j_rope_for_shape
from lightx2v_tpu.vae import wan_vae as jvae
from lightx2v_tpu_torch.models.wan import config as tcfg
from lightx2v_tpu_torch.models.wan import model as tmodel
from lightx2v_tpu_torch.models.wan import weights as tweights
from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape as t_rope_for_shape
from test_torch_vae_encode import jit_vae

TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256, task="i2v", in_dim=36, rope_fused=True)
SHAPE = (16, 3, 8, 12)
CFG = dict(model_cls="wan2.1_distill", task="i2v", synthetic_weights=True, prompt="the image comes alive",
           seed=42, enable_cfg=False, target_video_length=9, target_height=64, target_width=96, sample_shift=5,
           rope_fused=True, use_tiling_vae=True, latent_init="torch", denoising_step_list=[1000, 500],
           dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256, text_len=64,
           self_attn_1_type="flash_attn3", cross_attn_1_type="flash_attn3")


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


@pytest.fixture(scope="module")
def dit_pair():
    jarch, tarch = jcfg.WanArch(**TINY), tcfg.WanArch(**TINY)
    wd = jweights.init_random_weight_dict(jarch, seed=0)
    twd = tweights.init_random_weight_dict(tarch, seed=0)
    assert set(twd) == set(wd) and "blocks.1.cross_attn.k_img.weight" in wd and "img_emb.proj.3.bias" in wd
    for k in ("img_emb.proj.1.weight", "blocks.1.cross_attn.v_img.bias", "blocks.1.ffn.0.weight"):
        np.testing.assert_array_equal(np.asarray(wd[k], np.float32), twd[k])
    jp = jweights.permute_qk_half(jweights.load_wan_params(wd, jarch), jarch)
    tp = tweights.permute_qk_half(tweights.load_wan_params(wd, tarch), tarch)
    rng = np.random.default_rng(1)
    inputs = dict(lat=rng.standard_normal((1, *SHAPE)).astype(np.float32),
                  y=rng.standard_normal((1, 20, *SHAPE[1:])).astype(np.float32),
                  clip=rng.standard_normal((1, 257, 1280)).astype(np.float32),
                  ctx=(rng.standard_normal((1, 64, 256)) * 0.5).astype(np.float32),
                  ctx_null=(rng.standard_normal((1, 64, 256)) * 0.5).astype(np.float32),
                  t=np.array([750.0], np.float32))
    inputs["ctx"][:, 40:] = 0.0
    inputs["ctx_null"][:, 5:] = 0.0
    return jarch, tarch, jp, tp, inputs


def test_img_embeddings_matches_jax(dit_pair):
    _, _, jp, tp, inp = dit_pair
    ref = np.asarray(jmodel.img_embeddings(jp, jnp.asarray(inp["clip"]), jmodel.resolve_mm("Default")), np.float32)
    out = tmodel.img_embeddings(tp, torch.from_numpy(inp["clip"]), tmodel.resolve_mm("Default"))
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape == (1, 257, 256)
    assert _rel(out.float().numpy(), ref) < 1e-2, _rel(out.float().numpy(), ref)


def test_i2v_forward_and_cfg_match_jax(dit_pair):
    """One i2v forward (the image cross-attention beside the text one, y on
    the patch embedding's channels) and one CFG forward at batch 2, whose y
    and CLIP tokens double with the batch."""
    jarch, tarch, jp, tp, inp = dit_pair
    jc, js, _ = j_rope_for_shape(jarch, SHAPE)
    tc, ts, _ = t_rope_for_shape(tarch, SHAPE)
    j = {k: jnp.asarray(v, jnp.bfloat16 if k.startswith("ctx") else None) for k, v in inp.items()}
    t = {k: torch.from_numpy(v).to(torch.bfloat16) if k.startswith("ctx") else torch.from_numpy(v)
         for k, v in inp.items()}
    ref = np.asarray(jmodel.wan_forward(jp, j["lat"], j["t"], j["ctx"], jc, js, jarch, y=j["y"], clip_fea=j["clip"]))
    out = tmodel.wan_forward(tp, t["lat"], t["t"], t["ctx"], tc, ts, tarch, y=t["y"], clip_fea=t["clip"]).numpy()
    assert out.shape == ref.shape == (1, *SHAPE) and np.isfinite(out).all()
    assert _rel(out, ref) < 1e-2, _rel(out, ref)
    no_img = tmodel.wan_forward(tp, t["lat"], t["t"], t["ctx"], tc, ts, tarch, y=t["y"]).numpy()
    assert _rel(no_img, out) > 1e-2  # the image context moves the output

    ref = np.asarray(jmodel.wan_forward_cfg(jp, j["lat"], j["t"], j["ctx"], j["ctx_null"], 5.0, jc, js, jarch,
                                            y=j["y"], clip_fea=j["clip"]))
    out = tmodel.wan_forward_cfg(tp, t["lat"], t["t"], t["ctx"], t["ctx_null"], 5.0, tc, ts, tarch, y=t["y"],
                                 clip_fea=t["clip"]).numpy()
    assert out.shape == ref.shape == (1, *SHAPE)
    assert _rel(out, ref) < 5e-2, _rel(out, ref)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from PIL import Image

    from lightx2v_tpu.runners import wan_runner as jrunner
    from lightx2v_tpu.runners.wan_runner import WanDistillRunner as JRunner
    from lightx2v_tpu.utils.config import set_config as jset
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    path = tmp_path_factory.mktemp("i2v") / "cond.png"
    Image.fromarray(np.random.default_rng(7).integers(0, 256, (64, 96, 3), np.uint8)).save(path)
    cfg = dict(CFG, image_path=str(path))
    jr = JRunner(jset(dict(cfg)))
    # the JAX runner's encode as one compiled program
    mp = pytest.MonkeyPatch()
    mp.setattr(jrunner, "vae_encode", lambda params, x, cfg: jnp.asarray(jit_vae(jvae.vae_encode, params, x, cfg)))
    tr = tinfer.init_runner(tset(dict(cfg, device="cpu")))
    j_enc, t_enc = jr.run_input_encoder(), tr.run_input_encoder()
    mp.undo()
    j_lat = jr.run_dit(j_enc)
    shape = tuple(tr.set_target_shape())
    rng, noises = jax.random.PRNGKey(CFG["seed"] + 1), []
    for _ in range(len(CFG["denoising_step_list"])):
        rng, sub = jax.random.split(rng)
        noises.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    t_lat = tr.run_dit(t_enc, noises=noises)
    return dict(tr=tr, j_enc=j_enc, t_enc=t_enc, j_lat=j_lat, t_lat=t_lat,
                j_frames=jr.run_vae_decoder(j_lat), t_frames=tr.run_vae_decoder(t_lat))


def test_i2v_encode_stage(runs):
    j, t = runs["j_enc"], runs["t_enc"]
    ctx_j = np.asarray(j["text_encoder_output"]["context"], np.float32)
    ctx_t = t["text_encoder_output"]["context"].float().numpy()
    assert _rel(ctx_t, ctx_j) < 1e-2
    y_j = np.asarray(j["image_encoder_output"]["vae_encode_out"])
    y_t = t["image_encoder_output"]["vae_encode_out"].numpy()
    assert y_t.shape == y_j.shape == (1, 20, 3, 8, 12)
    np.testing.assert_array_equal(y_t[0, :4, 0], 1.0)
    np.testing.assert_array_equal(y_t[0, :4, 1:], 0.0)
    assert _rel(y_t, y_j) < 1e-2, _rel(y_t, y_j)
    clip_t = t["image_encoder_output"]["clip_encoder_out"]
    assert clip_t.shape == (1, 257, 1280) and not clip_t.any()  # the JAX runner's zero tokens
    assert {"t5_s", "clip_s", "vae_encode_s"} <= set(runs["tr"].timings)


def test_i2v_denoise_stage(runs):
    j, t = np.asarray(runs["j_lat"]), runs["t_lat"].numpy()
    assert t.shape == j.shape == SHAPE and np.isfinite(t).all()
    assert _rel(t, j) < 1e-2, _rel(t, j)


def test_i2v_decode_stage(runs):
    j, t = runs["j_frames"], runs["t_frames"]
    assert t.shape == j.shape == (9, 64, 96, 3) and np.isfinite(t).all()
    assert _rel(t, j) < 1e-2, _rel(t, j)


def test_i2v_needs_an_image():
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    r = tinfer.init_runner(tset(dict(CFG, device="cpu", num_layers=1)))
    with pytest.raises(ValueError, match="image_path"):
        r.run_input_encoder()
