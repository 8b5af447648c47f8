"""Checkpoint I/O on the CPU, port vs JAX package: the safetensors reader
and writer, ``load_sharded``, LoRA folding and extraction, the converter's
three layouts, the device quantizer, the T5 / CLIP / VAE ``.pth`` loaders,
the runner from ``model_path`` and ``dit_quantized_ckpt``, and dynamic CFG.

Tiny arches (DiT dim 256, 2 heads of 128, 2 layers; the synthetic runner's
T5 and VAE; the CLIP test's tower). Bars: bytes and codes exact; LoRA
folds exact, or one bf16 ulp where the fp32 ``b @ a`` sums in another order
(at most 1% of the entries); ``extract_lora``'s ``b @ a`` relative L2 1e-4
(SVD factors differ in sign, their product does not); the T5, CLIP and
runner comparisons at the bars of their module tests (relative L2 1e-2 on
bf16 outputs; the int8 runner 3e-2, whose JAX CPU path quantizes
differently, ROADMAP difference a); the VAE decode 1e-4 (fp32)."""

import functools
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lightx2v_tpu.encoders import clip as jclip
from lightx2v_tpu.encoders import t5 as jt5
from lightx2v_tpu.models.wan import config as jcfg
from lightx2v_tpu.models.wan import model as jmodel
from lightx2v_tpu.models.wan import weights as jweights
from lightx2v_tpu.models.wan.pipeline import rope_for_shape as j_rope_for_shape
from lightx2v_tpu.ops import rope as jrope
from lightx2v_tpu.tools import convert as jconv
from lightx2v_tpu.tools import lora as jlora
from lightx2v_tpu.utils import safetensors_io as jst
from lightx2v_tpu.vae import wan_vae as jvae
from lightx2v_tpu_torch.encoders import clip as tclip
from lightx2v_tpu_torch.encoders import t5 as tt5
from lightx2v_tpu_torch.models.wan import config as tcfg
from lightx2v_tpu_torch.models.wan import model as tmodel
from lightx2v_tpu_torch.models.wan import weights as tweights
from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape as t_rope_for_shape
from lightx2v_tpu_torch.ops import rope as trope
from lightx2v_tpu_torch.tools import convert as tconv
from lightx2v_tpu_torch.tools import lora as tlora
from lightx2v_tpu_torch.utils import safetensors_io as tst
from lightx2v_tpu_torch.vae import wan_vae as tvae
from test_torch_t5_vae import _jax_decode

TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)
SMALL_T5 = dict(vocab_size=4096, dim=256, dim_attn=256, dim_ffn=512, num_heads=8, num_layers=2)
SMALL_VAE = dict(dim=16, z_dim=16, dim_mult=(1, 2, 2, 2), num_res_blocks=1)
TINY_CLIP = dict(image_size=28, patch_size=14, dim=64, mlp_ratio=2, num_heads=4, num_layers=3, use_blocks=2)
INT8 = "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops: one torch thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _bytes(a) -> np.ndarray:
    """The bytes of a numpy array (any dtype, ml_dtypes included) or tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _same(t: torch.Tensor, a: np.ndarray):
    assert tuple(t.shape) == a.shape and str(t.dtype).split(".")[-1].startswith(
        {"bfloat16": "bfloat16", "float8_e4m3fn": "float8_e4m3fn"}.get(a.dtype.name, a.dtype.name)), (t.dtype, a.dtype)
    np.testing.assert_array_equal(_bytes(t), _bytes(a))


def _sample() -> dict:
    """bf16, e4m3, int8, packed uint8 and fp32 tensors; the 15-byte int8
    tensor first puts the bf16 and fp32 tensors after it at odd offsets."""
    rng = np.random.default_rng(0)
    return {"a_int8": rng.integers(-127, 128, (3, 5), dtype=np.int8),
            "b_bf16_odd": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
            "c_e4m3": np.clip(rng.standard_normal((2, 8)) * 50, -448, 448).astype(ml_dtypes.float8_e4m3fn),
            "d_packed_u8": rng.integers(0, 256, (7,), dtype=np.uint8),
            "e_f32_odd": rng.standard_normal((3,)).astype(np.float32),
            "f_bf16": rng.standard_normal((2, 2, 2)).astype(ml_dtypes.bfloat16)}


def test_safetensors_jax_writes_port_reads(tmp_path):
    arrs = _sample()
    path = str(tmp_path / "j.safetensors")
    jst.save_file(arrs, path, metadata={"format": "pt"})
    with tst.SafetensorsFile(path) as f:
        assert f.metadata == {"format": "pt"} and f.keys() == list(arrs)
        assert f.offsets("b_bf16_odd")[0] == 15 and f.offsets("e_f32_odd")[0] % 4 != 0
        assert f.get_shape_dtype("c_e4m3") == ((2, 8), torch.float8_e4m3fn)
    got = tst.load_file(path)
    for k, a in arrs.items():
        _same(got[k], a)
    assert float(got["b_bf16_odd"][1, 2]) == float(arrs["b_bf16_odd"][1, 2])


def test_safetensors_port_writes_jax_reads(tmp_path):
    arrs = _sample()
    tensors = {k: tst.as_tensor(a).clone() for k, a in arrs.items()}
    path = str(tmp_path / "t.safetensors")
    tst.save_file(tensors, path)
    with open(path, "rb") as f:
        assert (8 + int.from_bytes(f.read(8), "little")) % 8 == 0  # the header pads to 8 bytes, as JAX's
    got = jst.load_file(path)
    for k, a in arrs.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape
        np.testing.assert_array_equal(_bytes(got[k]), _bytes(a))
    # a caller's buffer and a scatter read of several tensors
    with tst.SafetensorsFile(path) as f:
        out = [torch.empty(f.nbytes(k), dtype=torch.uint8) for k in ("e_f32_odd", "b_bf16_odd", "a_int8")]
        assert f.read_runs(["e_f32_odd", "b_bf16_odd", "a_int8"], out) == sum(o.numel() for o in out)
        np.testing.assert_array_equal(out[1].numpy(), _bytes(arrs["b_bf16_odd"]))


def test_load_sharded_index_and_original(tmp_path):
    wd = {f"blocks.{i}.w": np.full((64, 64), i, np.float32) for i in range(5)}
    jconv.save_quantized(dict(wd), str(tmp_path / "chunked"), layout="chunked", chunk_gb=20e3 / 2**30)
    files = sorted(os.listdir(tmp_path / "chunked"))
    assert "model.safetensors.index.json" in files and sum(f.endswith(".safetensors") for f in files) == 3
    got = tst.load_sharded(str(tmp_path / "chunked"))
    assert list(got) == list(wd)
    for k in wd:
        _same(got[k], wd[k])
    (tmp_path / "orig" / "original").mkdir(parents=True)
    jst.save_file(wd, str(tmp_path / "orig" / "original" / "model.safetensors"))
    assert sorted(tst.load_sharded(str(tmp_path / "orig"))) == sorted(wd)
    with pytest.raises(FileNotFoundError):
        tst.load_sharded(str(tmp_path))


def _lora_dicts():
    rng = np.random.default_rng(3)
    bf = lambda *s: (rng.standard_normal(s) * 0.05).astype(ml_dtypes.bfloat16)  # noqa: E731
    wd = {"blocks.0.self_attn.q.weight": bf(64, 48), "blocks.0.self_attn.q.bias": bf(64),
          "blocks.0.ffn.0.weight": bf(96, 48), "blocks.0.cross_attn.o.weight": bf(48, 48),
          "blocks.1.ffn.2.weight": bf(48, 96)}
    f32 = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    lora = {"diffusion_model.blocks.0.self_attn.q.lora_A.weight": f32(8, 48),
            "diffusion_model.blocks.0.self_attn.q.lora_B.weight": f32(64, 8),
            "diffusion_model.blocks.0.ffn.0.lora_down.weight": f32(4, 48),
            "diffusion_model.blocks.0.ffn.0.lora_up.weight": f32(96, 4),
            "diffusion_model.blocks.0.self_attn.q.diff_b": f32(64),
            "diffusion_model.blocks.0.cross_attn.o.diff": f32(48, 48),
            "diffusion_model.blocks.9.ffn.0.lora_A.weight": f32(4, 48),  # no such base weight: skipped
            "diffusion_model.blocks.9.ffn.0.lora_B.weight": f32(96, 4)}
    return wd, lora


def test_apply_lora_matches_jax():
    wd, lora = _lora_dicts()
    jwd = {k: v.copy() for k, v in wd.items()}
    jconv.apply_lora(jwd, lora, 0.7)
    twd = {k: tst.as_tensor(v).clone() for k, v in wd.items()}
    assert tconv.apply_lora(twd, {k: torch.from_numpy(v) for k, v in lora.items()}, 0.7) == 4
    for k in wd:
        assert twd[k].dtype == torch.bfloat16
        out, ref = twd[k].float().numpy(), np.asarray(jwd[k], np.float32)
        if k in ("blocks.0.self_attn.q.weight", "blocks.0.ffn.0.weight"):  # the b @ a folds
            off = out != ref  # b @ a summed in another order: a rare one-ulp rounding flip
            assert off.mean() <= 0.01 and np.all(np.abs(out - ref)[off] <= np.abs(ref[off]) * 2 ** -7), k
        else:
            np.testing.assert_array_equal(out, ref, err_msg=k)
    np.testing.assert_array_equal(twd["blocks.1.ffn.2.weight"].float().numpy(),
                                  np.asarray(wd["blocks.1.ffn.2.weight"], np.float32))


def test_extract_lora_matches_jax():
    rng = np.random.default_rng(4)
    base = {"a.weight": rng.standard_normal((40, 24)).astype(np.float32),
            "a.bias": rng.standard_normal(40).astype(np.float32),
            "n.weight": np.ones(24, np.float32), "same.weight": np.ones((8, 8), np.float32)}
    delta = (rng.standard_normal((40, 3)) @ rng.standard_normal((3, 24))).astype(np.float32)
    tuned = {"a.weight": base["a.weight"] + delta, "a.bias": base["a.bias"] + 0.5,
             "n.weight": base["n.weight"] * 2, "same.weight": base["same.weight"]}
    jl = jlora.extract_lora(base, tuned, rank=4)
    tl = tlora.extract_lora({k: torch.from_numpy(v) for k, v in base.items()},
                            {k: torch.from_numpy(v) for k, v in tuned.items()}, rank=4)
    assert sorted(tl) == sorted(jl)
    a, b = "diffusion_model.a.lora_A.weight", "diffusion_model.a.lora_B.weight"
    assert tl[a].shape == (4, 24) and tl[b].shape == (40, 4)
    prod = (tl[b] @ tl[a]).numpy()
    assert _rel(prod, jl[b] @ jl[a]) < 1e-4 and _rel(prod, delta) < 1e-4
    for k in ("diffusion_model.a.diff_b", "diffusion_model.n.diff"):
        np.testing.assert_array_equal(tl[k].numpy(), jl[k])
    merged = {k: torch.from_numpy(v.copy()) for k, v in base.items()}
    tconv.apply_lora(merged, tl)
    assert _rel(merged["a.weight"].numpy(), tuned["a.weight"]) < 1e-5


def test_lora_on_quantized_weight_raises():
    """ROADMAP difference z: the port refuses a LoRA on int8 or e4m3 codes (fold
    first, then quantize)."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    lora = {"diffusion_model.l.lora_A.weight": torch.ones((2, 8)), "diffusion_model.l.lora_B.weight": torch.ones((16, 2))}
    for scheme in ("int8", "fp8"):
        q, s = tconv.quantize_weight(w, scheme)
        with pytest.raises(ValueError, match="tools.convert"):
            tconv.apply_lora({"l.weight": q, "l.weight_scale": s}, lora)
    with pytest.raises(ValueError, match="quantized"):  # a float weight beside a scale is a quantized one
        tconv.apply_lora({"l.weight": w, "l.weight_scale": torch.ones(16)}, lora)


def test_jax_apply_lora_adds_to_codes():
    """The JAX behaviour the port refuses: ``b @ a`` is added to the int8
    codes without their scale, and the sum is cast back to int8."""
    rng = np.random.default_rng(6)
    codes, scale = jconv.quantize_tensor(rng.standard_normal((16, 8)).astype(np.float32), "int8")
    a = rng.standard_normal((2, 8)).astype(np.float32)
    b = rng.standard_normal((16, 2)).astype(np.float32) * 3
    wd = {"l.weight": codes.copy(), "l.weight_scale": scale}
    jconv.apply_lora(wd, {"l.lora_A.weight": a, "l.lora_B.weight": b})
    assert wd["l.weight"].dtype == np.int8
    np.testing.assert_array_equal(wd["l.weight"], (codes.astype(np.float32) + b @ a).astype(np.int8))
    np.testing.assert_array_equal(wd["l.weight_scale"], scale)


@pytest.fixture(scope="module")
def int8_dicts():
    """The tiny DiT quantized to int8 by each package (equal bit for bit)."""
    arch = jcfg.WanArch(**TINY)
    wd = jweights.init_random_weight_dict(arch, seed=0)
    jq = jconv.quantize_model(wd, "int8")
    tq = tconv.quantize_model({k: tst.as_tensor(v) for k, v in wd.items()}, "int8")
    assert list(tq) == list(jq)
    for k in jq:
        _same(tq[k], np.asarray(jq[k]))
    return jq, tq


def _read_layout(read, root, layout):
    if layout != "blocks":
        return read(root)
    out = {}
    for f in sorted(os.listdir(root)):
        if f.endswith(".safetensors"):
            out.update((tst if read is tst.load_sharded else jst).load_file(os.path.join(root, f)))
    return out


@pytest.mark.parametrize("layout", ["single", "chunked", "blocks"])
def test_converter_layouts_cross_read(tmp_path, int8_dicts, layout):
    """Each package's converter output, read back by the other."""
    jq, tq = int8_dicts
    jconv.save_quantized(dict(jq), str(tmp_path / "j"), layout=layout, scheme="int8", chunk_gb=0.5 / 2**10)
    tconv.save_quantized(tq, str(tmp_path / "t"), layout=layout, scheme="int8", chunk_gb=0.5 / 2**10)
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t"))
    if layout == "chunked":
        assert len(os.listdir(tmp_path / "t")) > 3
    if layout == "blocks":
        assert sorted(os.listdir(tmp_path / "t")) == ["block_0.safetensors", "block_1.safetensors", "config.json",
                                                      "non_block.safetensors"]
    for d in ("j", "t"):
        assert json.loads((tmp_path / d / "config.json").read_text()) == {"mm_type": INT8}
    by_port = _read_layout(tst.load_sharded, str(tmp_path / "j"), layout)
    by_jax = _read_layout(jst.load_sharded, str(tmp_path / "t"), layout)
    assert sorted(by_port) == sorted(by_jax) == sorted(jq)
    for k in jq:
        _same(by_port[k], np.asarray(jq[k]))
        np.testing.assert_array_equal(_bytes(by_jax[k]), _bytes(tq[k]))


def test_converter_cli_on_cpu(tmp_path):
    """``python -m lightx2v_tpu_torch.tools.convert``: a LoRA folded, int8,
    the blocks layout; an mx scheme writes its codes, scales and mm_type."""
    arch = tcfg.WanArch(**dict(TINY, num_layers=1))
    wd = tweights.init_random_weight_dict(arch, seed=0)
    (tmp_path / "src").mkdir()
    tst.save_file({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in wd.items()},
                  str(tmp_path / "src" / "model.safetensors"))
    lora = {"diffusion_model.blocks.0.ffn.0.lora_A.weight": torch.full((2, 256), 0.01),
            "diffusion_model.blocks.0.ffn.0.lora_B.weight": torch.full((512, 2), 0.01)}
    tst.save_file(lora, str(tmp_path / "lora.safetensors"))
    tconv.main(["--source", str(tmp_path / "src"), "--output", str(tmp_path / "out"), "--quant", "int8",
                "--layout", "blocks", "--lora", f"{tmp_path / 'lora.safetensors'}:2", "--device", "cpu"])
    blk = tst.load_file(str(tmp_path / "out" / "block_0.safetensors"))
    w = torch.from_numpy(wd["blocks.0.ffn.0.weight"]).to(torch.bfloat16).float() + 2 * 2 * 0.01 * 0.01
    q, s = tconv.quantize_weight(w.to(torch.bfloat16), "int8")
    assert torch.equal(blk["blocks.0.ffn.0.weight"], q) and torch.equal(blk["blocks.0.ffn.0.weight_scale"], s)
    tconv.main(["--source", str(tmp_path / "src"), "--output", str(tmp_path / "o2"), "--quant", "mxfp8",
                "--device", "cpu"])
    mx = tst.load_file(str(tmp_path / "o2" / "model.safetensors"))
    assert mx["blocks.0.ffn.0.weight"].dtype == torch.float8_e4m3fn
    assert mx["blocks.0.ffn.0.weight_scale"].shape == (512, 8)
    assert json.loads((tmp_path / "o2" / "config.json").read_text()) == {"mm_type": "W-mxfp8-A-mxfp8-dynamic-Tpu"}


@pytest.mark.parametrize("scheme", ["int8", "fp8", "int4"])
def test_device_quantizer_matches_numpy(scheme):
    """``quantize_weight`` (torch) equals the JAX package's numpy
    ``quantize_tensor`` bit for bit: an all-zero row, a row of exact halves
    (round-half-even ties) and a wide normal range."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((48, 1024)) * np.exp(rng.uniform(-6, 3, (48, 1)))).astype(np.float32)
    w[3] = 0.0
    w[5] = np.arange(1024, dtype=np.float32) % 255 - 127 + 0.5
    w[5, 0] = 127.0  # absmax 127: the scale is 1, so every other entry is a tie
    q, s = tconv.quantize_weight(torch.from_numpy(w), scheme)
    jq, js = jconv.quantize_tensor(w, scheme)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js, np.float32))
    np.testing.assert_array_equal(_bytes(q), _bytes(np.asarray(jq)))
    assert q.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "int4": torch.uint8}[scheme]


def _save_pth(sd, path, dtype):
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype) for k, v in sd.items()}, path)


def test_t5_loader_vs_jax(tmp_path):
    """The bf16 ``.pth`` the reference ships, read by both loaders; the
    encodes agree at the T5 module test's bar."""
    sd = jt5.init_random_t5_state_dict(jt5.T5Config(**SMALL_T5), seed=1)
    path = str(tmp_path / "t5.pth")
    _save_pth(sd, path, torch.bfloat16)
    jenc = jt5.T5EncoderModel(64, checkpoint_path=path, cfg=jt5.T5Config(**SMALL_T5))
    tenc = tt5.T5EncoderModel(64, cfg=tt5.T5Config(**SMALL_T5), checkpoint_path=path)
    direct = tt5.load_t5_params({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()},
                                tt5.T5Config(**SMALL_T5))
    assert torch.equal(tenc.params["blocks"][1]["fc2"], direct["blocks"][1]["fc2"])
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 4096, (2, 64)).astype(np.int32)
    mask = np.zeros((2, 64), np.int32)
    mask[0, :20], mask[1, :45] = 1, 1
    jenc.tokenizer = tenc.tokenizer = lambda texts, return_mask=True: (ids, mask)
    ref = np.asarray(jenc.infer(["a", "b"]), np.float32)
    out = tenc.infer(["a", "b"]).float().numpy()
    assert out.shape == ref.shape == (2, 64, 256) and _rel(out, ref) < 1e-2, _rel(out, ref)


def test_t5_without_tokenizer_raises(tmp_path):
    """No injected tokenizer and no tokenizer files: infer names item 6
    (it never falls back to the hash tokenizer)."""
    params = tt5.load_t5_params(tt5.init_random_t5_state_dict(tt5.T5Config(**SMALL_T5), seed=1),
                                tt5.T5Config(**SMALL_T5))
    enc = tt5.T5EncoderModel(8, cfg=tt5.T5Config(**SMALL_T5), params=params, tokenizer_path=str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="item 6"):
        enc.infer(["a prompt"])
    with pytest.raises(ValueError):
        tt5.T5EncoderModel(8, cfg=tt5.T5Config(**SMALL_T5))


def test_clip_loader_vs_jax(tmp_path):
    """The CLIP ``.pth`` with a text tower beside the vision one: both
    loaders skip the ``textual`` keys; the tokens agree at the CLIP test's
    bar."""
    sd = jclip.init_random_clip_state_dict(jclip.ClipVisionArch(**TINY_CLIP), seed=0, scale=0.05)
    sd["textual.token_embedding.weight"] = np.ones((8, 64), np.float32)
    path = str(tmp_path / "clip.pth")
    _save_pth(sd, path, torch.bfloat16)
    img = np.random.default_rng(2).uniform(-1, 1, (64, 48, 3)).astype(np.float32)
    ref = np.asarray(jclip.CLIPVisionModel(checkpoint_path=path, arch=jclip.ClipVisionArch(**TINY_CLIP)).infer(img),
                     np.float32)
    out = tclip.CLIPVisionModel(tclip.ClipVisionArch(**TINY_CLIP), checkpoint_path=path).infer(img).float().numpy()
    assert out.shape == ref.shape == (1, 5, 64) and _rel(out, ref) < 1e-2, _rel(out, ref)


def test_vae_loader_vs_jax(tmp_path):
    """The fp32 VAE ``.pth`` read by both loaders; one decode agrees at the
    VAE test's bar."""
    sd = jvae.init_random_vae_state_dict(jvae.WanVAEConfig(**SMALL_VAE), seed=2)
    path = str(tmp_path / "vae.pth")
    _save_pth(sd, path, torch.float32)
    jp = jvae.load_wan_vae_from_path(path, jvae.WanVAEConfig(**SMALL_VAE))
    tp = tvae.load_wan_vae_from_path(path, tvae.WanVAEConfig(**SMALL_VAE))
    z = np.random.default_rng(1).standard_normal((1, 2, 6, 8, 16)).astype(np.float32)
    ref = np.asarray(_jax_decode(jvae.vae_decode, jp, jnp.asarray(z), jvae.WanVAEConfig(**SMALL_VAE)), np.float32)
    out = tvae.vae_decode(tp, torch.from_numpy(z), tvae.WanVAEConfig(**SMALL_VAE)).numpy()
    assert out.shape == ref.shape == (1, 5, 48, 64, 3) and _rel(out, ref) < 1e-4, _rel(out, ref)


RUN = dict(model_cls="wan2.1_distill", task="t2v", prompt="a red panda", seed=42, enable_cfg=False,
           target_video_length=9, target_height=64, target_width=96, sample_shift=5, latent_init="torch",
           denoising_step_list=[1000], text_len=64, self_attn_1_type="flash_attn3",
           cross_attn_1_type="flash_attn3")


def _write_model_dir(root, dit_file: bool):
    """model_path: the arch's config.json, the T5 / VAE ``.pth`` files, and
    (``dit_file``) the bf16 DiT safetensors."""
    root.mkdir()
    (root / "config.json").write_text(json.dumps(dict(TINY, freq_dim=256, text_len=64)))
    _save_pth(jt5.init_random_t5_state_dict(jt5.T5Config(**SMALL_T5), seed=1),
              str(root / "models_t5_umt5-xxl-enc-bf16.pth"), torch.bfloat16)
    _save_pth(jvae.init_random_vae_state_dict(jvae.WanVAEConfig(**SMALL_VAE), seed=2),
              str(root / "Wan2.1_VAE.pth"), torch.float32)
    wd = jweights.init_random_weight_dict(jcfg.WanArch(**TINY), seed=0)
    if dit_file:
        jst.save_file({k: np.asarray(v, np.float32).astype(ml_dtypes.bfloat16) for k, v in wd.items()},
                      str(root / "diffusion_pytorch_model.safetensors"))
    return wd


def _runner_pair(cfg, monkeypatch):
    """The JAX and port runners on one config, the T5 and VAE at the
    synthetic runner's sizes, the synthetic tokenizer injected into both;
    returns the contexts and the latents of a 1-step run (the JAX re-noise
    draw injected into the port); the port's frames must be finite."""
    import jax

    from lightx2v_tpu.runners import wan_runner as jrunner
    from lightx2v_tpu.utils.config import set_config as jset
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.runners import wan_runner as trunner
    from lightx2v_tpu_torch.utils.config import set_config as tset

    monkeypatch.setattr(jrunner, "T5EncoderModel", functools.partial(jt5.T5EncoderModel, cfg=jt5.T5Config(**SMALL_T5)))
    monkeypatch.setattr(jrunner, "WanVAEConfig", lambda: jvae.WanVAEConfig(**SMALL_VAE))
    monkeypatch.setattr(trunner, "UMT5_XXL", tt5.T5Config(**SMALL_T5))
    monkeypatch.setattr(trunner, "WanVAEConfig", lambda: tvae.WanVAEConfig(**SMALL_VAE))
    jr = jrunner.WanDistillRunner(jset(dict(cfg)))
    tr = tinfer.init_runner(tset(dict(cfg, device="cpu")))
    jr.text_encoder.tokenizer = jrunner._SyntheticTokenizer(64, 4096)
    tr.text_encoder.tokenizer = trunner._SyntheticTokenizer(64, 4096)
    j_enc, t_enc = jr.run_input_encoder(), tr.run_input_encoder()
    shape = tuple(tr.set_target_shape())
    rng, noises = jax.random.PRNGKey(cfg["seed"] + 1), []
    for _ in cfg["denoising_step_list"]:
        rng, sub = jax.random.split(rng)
        noises.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    j_lat, t_lat = np.asarray(jr.run_dit(j_enc)), tr.run_dit(t_enc, noises=noises)
    frames = tr.run_vae_decoder(t_lat)
    assert frames.shape == (9, 64, 96, 3) and np.isfinite(frames).all()
    ctx = (np.asarray(j_enc["text_encoder_output"]["context"], np.float32),
           t_enc["text_encoder_output"]["context"].float().numpy())
    return tr, ctx, (j_lat, t_lat.numpy())


@pytest.mark.parametrize("kind", ["model_path_bf16", "dit_quantized_ckpt_int8"])
def test_runner_from_checkpoints_vs_jax(tmp_path, monkeypatch, kind):
    """The runner from files: the bf16 DiT in ``model_path``, or the int8
    DiT the JAX converter wrote to ``dit_quantized_ckpt`` (one file) with
    the T5 quantized to int8 at load (``t5_quantized``: read on the host,
    quantized on its way to the device); the T5 and VAE ``.pth`` from
    ``model_path`` in both. Bars: contexts 1e-2, the int8 T5's 3e-2 (the
    int8 T5 module test's; measured 1.3e-2); latents 1e-2, int8 3e-2."""
    wd = _write_model_dir(tmp_path / "model", dit_file=kind == "model_path_bf16")
    cfg = dict(RUN, model_path=str(tmp_path / "model"))
    int8 = kind == "dit_quantized_ckpt_int8"
    if int8:
        jconv.save_quantized(jconv.quantize_model(wd, "int8"), str(tmp_path / "q"), layout="single", scheme="int8")
        cfg.update(dit_quantized_ckpt=str(tmp_path / "q"), mm_config={"mm_type": INT8}, t5_quantized=True,
                   t5_quant_scheme="int8")
    tr, (cj, ct), (lj, lt) = _runner_pair(cfg, monkeypatch)
    blk = tr.model["blocks"][0]["ffn"]["0"]
    assert blk["w"].dtype == (torch.int8 if int8 else torch.bfloat16)
    fc2 = tr.text_encoder.params["blocks"][1]["fc2"]
    assert (fc2["w"].dtype == torch.int8) if int8 else (fc2.dtype == torch.bfloat16)
    assert _rel(ct, cj) < (3e-2 if int8 else 1e-2), _rel(ct, cj)
    assert lt.shape == lj.shape == (16, 3, 8, 12)
    assert _rel(lt, lj) < (3e-2 if int8 else 1e-2), _rel(lt, lj)


def test_runner_checkpoint_refusals(tmp_path):
    """A float checkpoint under a quantized mm_type (difference aa) and a
    LoRA on a quantized one (difference z) raise, pointing at the
    converter; without model_path the encoders cannot load."""
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    wd = _write_model_dir(tmp_path / "model", dit_file=True)
    with pytest.raises(ValueError, match="tools.convert"):
        tinfer.init_runner(tset(dict(RUN, device="cpu", model_path=str(tmp_path / "model"),
                                     mm_config={"mm_type": INT8})))
    tconv.save_quantized(tconv.quantize_model({k: tst.as_tensor(v) for k, v in wd.items()}, "int8"),
                         str(tmp_path / "q"), scheme="int8")
    tst.save_file({"diffusion_model.blocks.0.ffn.0.lora_A.weight": torch.ones((2, 256)),
                   "diffusion_model.blocks.0.ffn.0.lora_B.weight": torch.ones((512, 2))}, str(tmp_path / "l.safetensors"))
    with pytest.raises(ValueError, match="tools.convert"):
        tinfer.init_runner(tset(dict(RUN, device="cpu", dit_quantized_ckpt=str(tmp_path / "q"),
                                     model_path=str(tmp_path / "model"), mm_config={"mm_type": INT8},
                                     lora_configs=[{"path": str(tmp_path / "l.safetensors")}])))


def test_dynamic_cfg_matches_jax():
    """``enable_dynamic_cfg``: the guidance-scale embedding (tight: fp32
    sin/cos of another library) and a forward through a checkpoint's
    ``cfg_cond_proj`` (the whole-model bar, 1e-2); another scale moves the
    output."""
    w = np.array([1.0, 4.0, 7.5], np.float32)
    np.testing.assert_allclose(trope.guidance_scale_embedding(torch.from_numpy(w)).numpy(),
                               np.asarray(jrope.guidance_scale_embedding(jnp.asarray(w))), rtol=0, atol=2e-4)
    arch_kw = dict(TINY, enable_dynamic_cfg=True)
    jarch, tarch = jcfg.WanArch(**arch_kw), tcfg.WanArch(**arch_kw)
    wd = jweights.init_random_weight_dict(jarch, seed=0)
    rng = np.random.default_rng(8)
    wd["cfg_cond_proj.weight"] = (rng.standard_normal((256, 256)) * 0.05).astype(np.float32)
    wd["cfg_cond_proj.bias"] = (rng.standard_normal(256) * 0.05).astype(np.float32)
    jp, tp = jweights.load_wan_params(wd, jarch), tweights.load_wan_params(wd, tarch)
    assert tp["cfg_cond_proj"]["w"].dtype == torch.float32
    shape = (16, 2, 4, 6)
    lat = rng.standard_normal((1, *shape)).astype(np.float32)
    ctx = (rng.standard_normal((1, 16, 256)) * 0.5).astype(np.float32)
    jc, js, _ = j_rope_for_shape(jarch, shape)
    tc, ts, _ = t_rope_for_shape(tarch, shape)
    ref = np.asarray(jmodel.wan_forward(jp, jnp.asarray(lat), jnp.asarray([750.0]), jnp.asarray(ctx, jnp.bfloat16),
                                        jc, js, jarch, cfg_scale=jnp.asarray([6.0])))
    outs = [tmodel.wan_forward(tp, torch.from_numpy(lat), torch.tensor([750.0]),
                               torch.from_numpy(ctx).to(torch.bfloat16), tc, ts, tarch,
                               cfg_scale=torch.tensor([scale])).numpy() for scale in (6.0, 3.0)]
    assert _rel(outs[0], ref) < 1e-2, _rel(outs[0], ref)
    assert _rel(outs[1], outs[0]) > 1e-3  # the guidance scale moves the prediction
