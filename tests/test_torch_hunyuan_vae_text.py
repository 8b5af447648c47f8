"""HunyuanVideo's VAE decoder and text encoders on the CPU, port vs JAX
package: the causal 3D VAE decode whole, spatially tiled and temporally +
spatially tiled (small VAE, small tiles, so that every blend runs), the
llava-llama-3-8b-class encoder (cropped, with padding) and the CLIP-L text
tower at tiny arches from one state dict each, the synthetic tokenizers of
the full-width runner, the device synthesizers' layouts against the
loaders', and the ``.pt`` loaders of the DiT and the VAE on files the test
writes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.encoders import clip as jclip
from lightx2v_tpu.encoders import llama as jllama
from lightx2v_tpu.models.hunyuan import config as jc
from lightx2v_tpu.models.hunyuan import weights as jw
from lightx2v_tpu.vae import hunyuan_vae as jv
from lightx2v_tpu_torch.encoders import clip as tclip
from lightx2v_tpu_torch.encoders import llama as tllama
from lightx2v_tpu_torch.models.hunyuan import config as tc
from lightx2v_tpu_torch.models.hunyuan import weights as tw
from lightx2v_tpu_torch.runners import hunyuan_runner as hr
from lightx2v_tpu_torch.vae import hunyuan_vae as tv

VAE = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, latent_channels=4, norm_num_groups=4)
LLAMA = dict(vocab_size=256, dim=128, num_layers=4, num_heads=4, num_kv_heads=2, ffn_dim=256, crop_start=5)
CLIP = dict(vocab_size=100, dim=64, num_heads=4, num_layers=2, max_positions=16)


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


@pytest.fixture(scope="module")
def vae():
    sd = jv.init_random_hunyuan_vae_state_dict(jv.HunyuanVAEConfig(**VAE), seed=0)
    cfg_j, cfg_t = jv.HunyuanVAEConfig(**VAE), tv.HunyuanVAEConfig(**VAE)
    return sd, cfg_j, cfg_t, jv.load_hunyuan_vae_params(sd, cfg_j), tv.load_hunyuan_vae_params(sd, cfg_t)


def test_vae_state_dict_matches_jax():
    """The host state dict (encoder drawn first) is the JAX package's, value
    for value; the per-stage scales match."""
    jsd = jv.init_random_hunyuan_vae_state_dict(jv.HunyuanVAEConfig(**VAE), seed=5)
    tsd = tv.init_random_hunyuan_vae_state_dict(tv.HunyuanVAEConfig(**VAE), seed=5)
    assert set(jsd) == set(tsd) and all(np.array_equal(jsd[k], tsd[k]) for k in jsd)
    assert tv.HunyuanVAEConfig().up_scales() == jv.HunyuanVAEConfig().up_scales() == [(1, 2, 2), (2, 2, 2),
                                                                                      (2, 2, 2), None]


def test_vae_decode_vs_jax(vae):
    """The untiled decode of 3 latent frames (the first frame upsampled in
    space only), scaled. Bar: fp32 convolutions in another order, relative
    L2 1e-4 (measured 5.9e-6)."""
    _, cfg_j, cfg_t, jp, tp = vae
    z = np.random.default_rng(1).standard_normal((1, 3, 4, 6, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, z_: jv.hunyuan_vae_decode(p, z_, cfg_j, scale=True))(jp, jnp.asarray(z)))
    out = tv.hunyuan_vae_decode(tp, torch.from_numpy(z), cfg_t, scale=True)
    assert out.shape == ref.shape == (1, 9, 32, 48, 3)
    assert _rel(out.numpy(), ref) < 1e-4, _rel(out.numpy(), ref)


@pytest.mark.parametrize("mode", ["spatial", "temporal_spatial"])
def test_vae_tiled_decode_vs_jax(vae, mode, monkeypatch):
    """The tilings and their cascading blends against the JAX package's
    tiling code, both sides decoding each tile with the port's
    ``hunyuan_vae_decode`` (held to JAX's above; a JAX compile per tile
    shape would take most of a minute). spatial: 3 x 10 x 14 latents in
    tiles of 6 (step 4: a 3 x 4 grid with edge tiles, both blends, each
    blended tile replacing its original); temporal_spatial: 9 x 8 x 10
    latents in temporal tiles of 4 (step 3: each tile past the first carries
    an extra leading frame whose output is dropped; the temporal blend) of
    spatial tiles of 6. Bar: fp32 blends, 1e-6."""
    _, cfg_j, cfg_t, _, tp = vae
    decodes = []

    def port_tile(params, tile, cfg, scale):
        decodes.append(tuple(tile.shape))
        return jnp.asarray(tv.hunyuan_vae_decode(tp, torch.from_numpy(np.array(tile)), cfg_t, scale=scale).numpy())

    monkeypatch.setattr(jv, "hunyuan_vae_decode", port_tile)
    shape = {"spatial": (1, 3, 10, 14, 4), "temporal_spatial": (1, 9, 8, 10, 4)}[mode]
    z = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    if mode == "spatial":
        ref = jv.hunyuan_vae_decode_spatial_tiled(None, jnp.asarray(z), cfg_j, scale=False, tile_latent=6)
        out = tv.hunyuan_vae_decode_spatial_tiled(tp, torch.from_numpy(z), cfg_t, scale=False, tile_latent=6)
        assert len(decodes) == 12
    else:
        ref = jv.hunyuan_vae_decode_tiled(None, jnp.asarray(z), cfg_j, scale=False, t_tile_latent=4,
                                          spatial_tile_latent=6)
        out = tv.hunyuan_vae_decode_tiled(tp, torch.from_numpy(z), cfg_t, scale=False, t_tile_latent=4,
                                          spatial_tile_latent=6)
        assert len(decodes) == 3 * 6 and sorted({d[1] for d in decodes}) == [3, 5]
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (1, 4 * (shape[1] - 1) + 1, 8 * shape[2], 8 * shape[3], 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def _llama_sd(arch, seed=0):
    """A random HF LlamaModel state dict (``model.`` keys)."""
    rng = np.random.default_rng(seed)
    d, dkv = arch.dim, arch.num_kv_heads * arch.head_dim
    r = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)  # noqa: E731
    sd = {"model.embed_tokens.weight": r(arch.vocab_size, d), "model.norm.weight": 1 + r(d)}
    for i in range(arch.num_layers):
        p = f"model.layers.{i}"
        sd.update({f"{p}.input_layernorm.weight": 1 + r(d), f"{p}.post_attention_layernorm.weight": 1 + r(d),
                   f"{p}.self_attn.q_proj.weight": r(d, d), f"{p}.self_attn.k_proj.weight": r(dkv, d),
                   f"{p}.self_attn.v_proj.weight": r(dkv, d), f"{p}.self_attn.o_proj.weight": r(d, d),
                   f"{p}.mlp.gate_proj.weight": r(arch.ffn_dim, d), f"{p}.mlp.up_proj.weight": r(arch.ffn_dim, d),
                   f"{p}.mlp.down_proj.weight": r(d, arch.ffn_dim)})
    return sd


def test_llama_cropped_vs_jax():
    """A 4-layer Llama with GQA (4 query heads, 2 KV heads of 32) runs 2
    blocks, no final norm, on two padded prompts (12 and 20 of 24 tokens),
    then the crop of the first 5. Bar: relative L2 1e-2 on the bf16 states
    (measured 6.3-6.8e-3 over four seeds: bf16 activations, each package
    ~8.5e-3 from an fp64 run of the same weights); the masks equal."""
    ja, ta = jllama.LlamaArch(**LLAMA), tllama.LlamaArch(**LLAMA)
    sd = _llama_sd(ta)
    ids = np.random.default_rng(2).integers(1, ta.vocab_size, (2, 24)).astype(np.int32)
    mask = np.zeros((2, 24), np.int32)
    mask[0, :12], mask[1, :20] = 1, 1
    ids[mask == 0] = 0
    jx, jm_ = jax.jit(lambda p, i, m: jllama.llama_encode_cropped(p, i, m, ja))(
        jllama.load_llama_params(sd, ja), jnp.asarray(ids), jnp.asarray(mask))
    tp = tllama.load_llama_params(sd, ta)
    assert len(tp["blocks"]) == ta.run_layers == 2
    tx, tm_ = tllama.llama_encode_cropped(tp, torch.from_numpy(ids), torch.from_numpy(mask), ta)
    assert tx.dtype == torch.bfloat16 and tx.shape == (2, 19, 128)
    np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))
    assert _rel(tx.float().numpy(), np.asarray(jx, np.float32)) < 1e-2


def test_llama_encoder_model_template_and_tokenizer_vs_jax():
    """The encoder model (video template, tokenizer, encode, crop) with the
    runner's synthetic Llama tokenizer on both packages: the template's text
    before the prompt is ``crop_start`` ids, so the crop keeps exactly the
    prompt's words and its end id. Bar as above."""
    assert tllama.PROMPT_TEMPLATE == jllama.LlamaEncoderModel.PROMPT_TEMPLATE
    ja, ta = jllama.LlamaArch(**LLAMA), tllama.LlamaArch(**LLAMA)
    sd = _llama_sd(ta, seed=1)
    tok = hr._SyntheticLlamaTokenizer(ta)
    prompt = "a red panda climbing a bamboo tree"
    ids, mask = tok([tllama.PROMPT_TEMPLATE.format(prompt)], return_mask=True)
    assert ids.shape == (1, ta.max_length) and mask[0, :ta.crop_start].all()
    assert mask.sum() == ta.crop_start + len(prompt.split()) + 1
    jstates, jmask = jllama.LlamaEncoderModel(0, ja, jllama.load_llama_params(sd, ja), tok).infer([prompt])
    tstates, tmask = tllama.LlamaEncoderModel(ta, tllama.load_llama_params(sd, ta), tok).infer([prompt])
    assert tstates.shape == (1, 256, 128) and tmask.shape == (1, 256) and tmask.sum() == 8
    np.testing.assert_array_equal(tmask, np.asarray(jmask))
    assert _rel(tstates.float().numpy(), np.asarray(jstates, np.float32)) < 1e-2


def _clip_text_sd(arch, seed=0):
    """A random HF CLIPTextModel state dict (``text_model.`` keys)."""
    rng = np.random.default_rng(seed)
    d, md = arch.dim, arch.mlp_ratio * arch.dim
    r = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)  # noqa: E731
    sd = {"embeddings.token_embedding.weight": r(arch.vocab_size, d),
          "embeddings.position_embedding.weight": r(arch.max_positions, d),
          "final_layer_norm.weight": 1 + r(d), "final_layer_norm.bias": r(d)}
    for i in range(arch.num_layers):
        p = f"encoder.layers.{i}"
        for m, (o, k) in (("self_attn.q_proj", (d, d)), ("self_attn.k_proj", (d, d)), ("self_attn.v_proj", (d, d)),
                          ("self_attn.out_proj", (d, d)), ("mlp.fc1", (md, d)), ("mlp.fc2", (d, md))):
            sd[f"{p}.{m}.weight"], sd[f"{p}.{m}.bias"] = r(o, k), r(o)
        for m in ("layer_norm1", "layer_norm2"):
            sd[f"{p}.{m}.weight"], sd[f"{p}.{m}.bias"] = 1 + r(d), r(d)
    return {f"text_model.{k}": v for k, v in sd.items()}


def test_clip_text_vs_jax():
    """A 2-layer CLIP text tower on two padded prompts through the runner's
    synthetic CLIP tokenizer (the end-of-text id, the vocabulary's highest,
    closes each prompt and appears nowhere else, so the pooled row is the
    prompt's last). Bar: relative L2 1e-2 on the bf16 hidden states and the
    pooled vector (measured 5.7e-3 and 5.3e-3)."""
    ja, ta = jclip.ClipTextArch(**CLIP), tclip.ClipTextArch(**CLIP)
    sd = _clip_text_sd(ta)
    ids, mask = hr._SyntheticClipTokenizer(ta)(["a red panda", "a bamboo tree in the rain"], return_mask=True)
    assert ids.shape == (2, 16) and (ids == ta.vocab_size - 1).sum() == 2
    assert list(ids.argmax(axis=1)) == [3, 6] and list(mask.sum(axis=1)) == [4, 7]
    jh, jpool = jax.jit(lambda p, i, m: jclip.clip_text_forward(p, i, m, ja))(
        jclip.load_clip_text_params(sd, ja), jnp.asarray(ids), jnp.asarray(mask))
    th, tpool = tclip.clip_text_forward(tclip.load_clip_text_params(sd, ta), torch.from_numpy(ids),
                                        torch.from_numpy(mask), ta)
    assert th.dtype == torch.bfloat16 and tpool.shape == (2, 64) and tpool.dtype == torch.float32
    assert _rel(th.float().numpy(), np.asarray(jh, np.float32)) < 1e-2
    assert _rel(tpool.numpy(), np.asarray(jpool)) < 1e-2
    model = tclip.CLIPTextModel(ta, tclip.load_clip_text_params(sd, ta), hr._SyntheticClipTokenizer(ta))
    torch.testing.assert_close(model.infer(["a red panda", "a bamboo tree in the rain"]), tpool)


def _tree(p, prefix=""):
    if isinstance(p, dict):
        return {k: v for key, sub in p.items() for k, v in _tree(sub, f"{prefix}{key}.").items()}
    if isinstance(p, list):
        return {k: v for i, sub in enumerate(p) for k, v in _tree(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: None if p is None else (tuple(p.shape), p.dtype)}


def test_device_synthesizers_match_loader_layouts():
    """The device synthesizers (run here on the CPU at small widths) give the
    loaders' layout, shape and dtype for shape and dtype: the DiT, the Llama
    (only the blocks that run) and the CLIP text tower."""
    ta = tc.HunyuanArch(hidden_size=256, heads_num=2, double_blocks=1, single_blocks=2, mlp_hidden_dim=512,
                        text_states_dim=64, text_states_dim_2=32)
    loaded = tw.load_hunyuan_params(tw.init_random_hunyuan_state_dict(ta), ta)
    assert _tree(tw.init_random_hunyuan_params_on_device(ta, device="cpu")) == _tree(loaded)
    la = tllama.LlamaArch(**LLAMA)
    assert _tree(tllama.init_random_llama_params_on_device(la, device="cpu")) == \
        _tree(tllama.load_llama_params(_llama_sd(la), la))
    ca = tclip.ClipTextArch(**CLIP)
    assert _tree(tclip.init_random_clip_text_params_on_device(ca, device="cpu")) == \
        _tree(tclip.load_clip_text_params(_clip_text_sd(ca), ca))


def test_pt_loaders(tmp_path, vae):
    """load_hunyuan_from_path on a reference-style ``.pt`` (bf16 tensors under
    ``"module"``) equals load_hunyuan_params on the dict, and the JAX loader
    reads the same file to the same values; load_hunyuan_vae_from_path on a
    ``.pt`` with ``"state_dict"`` and ``vae.``-prefixed keys equals the
    decoder params from the dict."""
    arch = tc.HunyuanArch(hidden_size=256, heads_num=2, double_blocks=1, single_blocks=1, mlp_hidden_dim=512,
                          text_states_dim=64, text_states_dim_2=32)
    sd = tw.init_random_hunyuan_state_dict(arch, seed=1)
    path = tmp_path / "mp_rank_00_model_states.pt"
    torch.save({"module": {k: torch.from_numpy(v).to(torch.bfloat16 if v.ndim > 1 else torch.float32)
                           for k, v in sd.items()}}, path)
    got, ref = tw.load_hunyuan_from_path(str(path), arch), tw.load_hunyuan_params(sd, arch)
    assert _tree(got) == _tree(ref)
    torch.testing.assert_close(got["single_blocks"][0]["linear1"]["w"], ref["single_blocks"][0]["linear1"]["w"])
    torch.testing.assert_close(got["final_layer"]["linear"]["w"], ref["final_layer"]["linear"]["w"])
    jp = jw.load_hunyuan_from_path(str(path), jc.HunyuanArch(**dataclasses.asdict(arch)))
    np.testing.assert_array_equal(got["double_blocks"][0]["img_attn_qkv"]["w"].float().numpy(),
                                  np.asarray(jp["double_blocks"]["img_attn_qkv"]["w"][0], np.float32))

    vsd, _, cfg_t, _, tp = vae
    vpath = tmp_path / "pytorch_model.pt"
    torch.save({"state_dict": {f"vae.{k}": torch.from_numpy(v) for k, v in vsd.items()}}, vpath)
    vgot = tv.load_hunyuan_vae_from_path(str(vpath), cfg_t)
    assert _tree(vgot) == _tree(tp)
    torch.testing.assert_close(vgot["decoder"]["mid"]["attn"]["to_q"]["w"], tp["decoder"]["mid"]["attn"]["to_q"]["w"])
