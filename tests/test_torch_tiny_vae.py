"""The tiny VAE (TAEHV / taew2_1) on the CPU, port vs JAX package: the
synthesizer (bit for bit), the decode and encode from one
``init_random_tiny_vae_params(seed=0)``, the chunked decode against the
whole one, causality, the converter and loader on a taehv-style state dict
that the test writes (``.pth`` and ``.safetensors``), and a small
``tiny_vae`` runner (``configs/wan_t2v_tiny_vae.json``'s keys) against the
JAX runner.

Bars: the weights bit for bit; decode and encode fp32 on both sides, max
abs err 1e-5 of the output's max (different convolution algorithms sum in
another order; measured 2.5e-6 on the decode, whose random-weight outputs
reach ~1.5e3); the chunked decode 1e-5 of the max (per-batch algorithm
choice); the runner's latents relative L2 5e-2, as ``test_torch_cfg.py``
(three UniPC steps with CFG at 6), and its decoder's frames 1e-4 on the
same latents (the random decoder's outputs reach ~1e3 before the clip, so
the latents' 5e-2 is not a bar for the frames)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.vae import tiny_vae as jtiny
from lightx2v_tpu_torch.vae import tiny_vae as ttiny


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jtiny.init_random_tiny_vae_params(seed=0), ttiny.init_random_tiny_vae_params(seed=0)


def _hwio(w: torch.Tensor) -> np.ndarray:
    return w.numpy().transpose(2, 3, 1, 0) if w.dim() == 4 else w.numpy()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _max_err(out, ref) -> float:
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def test_synthesizer_bitwise(params):
    jp, tp = params
    j, t = dict(_leaves(jp)), dict(_leaves(tp))
    assert set(j) == set(t) and len(t) > 100
    for k in j:
        assert t[k].dtype == torch.float32 and np.array_equal(_hwio(t[k]), np.asarray(j[k])), k
    assert sum(v.numel() for v in t.values()) > 9_000_000


@pytest.mark.parametrize("t", [1, 3])
def test_decode_vs_jax(params, t):
    jp, tp = params
    lat = np.random.default_rng(t).standard_normal((1, t, 4, 6, 16)).astype(np.float32)
    ref = np.asarray(jtiny.tiny_decode(jp, jnp.asarray(lat)))
    out = ttiny.tiny_decode(tp, torch.from_numpy(lat)).numpy()
    assert out.shape == ref.shape == (1, 4 * t - 3, 32, 48, 3)
    assert _max_err(out, ref) < 1e-5, _max_err(out, ref)
    wan = ttiny.tiny_decode_wan_latents(tp, torch.from_numpy(lat[0]).permute(3, 0, 1, 2)).numpy()
    jwan = np.asarray(jtiny.tiny_decode_wan_latents(jp, jnp.asarray(lat[0]).transpose(3, 0, 1, 2)))
    assert wan.shape == jwan.shape == out.shape[1:] and _max_err(wan, jwan) < 1e-5


def test_encode_vs_jax(params):
    jp, tp = params
    vid = np.random.default_rng(1).uniform(0, 1, (1, 8, 32, 48, 3)).astype(np.float32)
    ref = np.asarray(jtiny.tiny_encode(jp, jnp.asarray(vid)))
    out = ttiny.tiny_encode(tp, torch.from_numpy(vid)).numpy()
    assert out.shape == ref.shape == (1, 2, 4, 6, 16)
    assert _max_err(out, ref) < 1e-5, _max_err(out, ref)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_chunked_decode_equals_whole(params, chunk):
    """Each MemBlock carries its input's last frame across chunks (3 does
    not divide 5: the last chunk is shorter)."""
    _, tp = params
    lat = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 5, 4, 4, 16)).astype(np.float32))
    whole = ttiny.tiny_decode(tp, lat).numpy()
    out = ttiny.tiny_decode(tp, lat, chunk=chunk).numpy()
    assert out.shape == whole.shape == (1, 17, 32, 32, 3)
    assert _max_err(out, whole) < 1e-5, _max_err(out, whole)


def test_decode_is_temporally_causal(params):
    """Perturbing latent frame 3 leaves the output frames before 9 (its
    first after the trim) unchanged, as ``tests/test_tiny_vae.py``."""
    _, tp = params
    lat = np.random.default_rng(2).standard_normal((1, 4, 4, 4, 16)).astype(np.float32)
    base = ttiny.tiny_decode(tp, torch.from_numpy(lat), chunk=2).numpy()
    lat[:, 3] += 10.0
    out = ttiny.tiny_decode(tp, torch.from_numpy(lat), chunk=2).numpy()
    assert np.array_equal(out[:, :9], base[:, :9])
    assert np.abs(out[:, 9:] - base[:, 9:]).max() > 1e-3


def _taehv_state_dict(jp):
    """The reference's ``encoder.N`` / ``decoder.N`` keys, OIHW, from JAX
    params (a decoder MemBlock of equal widths has no skip)."""
    sd = {}

    def put(key, w, b=None):
        sd[key + ".weight"] = np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))
        if b is not None:
            sd[key + ".bias"] = np.asarray(b, np.float32)

    def mem(key, mp):
        put(f"{key}.conv.0", mp["c0_w"], mp["c0_b"])
        put(f"{key}.conv.2", mp["c1_w"], mp["c1_b"])
        put(f"{key}.conv.4", mp["c2_w"], mp["c2_b"])

    e, d = jp["encoder"], jp["decoder"]
    put("encoder.0", e["in_w"], e["in_b"])
    for i, (pool_i, down_i, mems) in enumerate(ttiny.ENC_SEQ):
        put(f"encoder.{pool_i}.conv", e[f"s{i}_pool"]["w"])
        put(f"encoder.{down_i}", e[f"s{i}_down_w"])
        for j, m in enumerate(mems):
            mem(f"encoder.{m}", e[f"s{i}_mem{j}"])
    put("encoder.17", e["out_w"], e["out_b"])
    put("decoder.1", d["in_w"], d["in_b"])
    for i, (mems, grow_i, out_i) in enumerate(ttiny.DEC_SEQ):
        for j, m in enumerate(mems):
            mem(f"decoder.{m}", d[f"s{i}_mem{j}"])
        put(f"decoder.{grow_i}.conv", d[f"s{i}_grow"]["w"])
        put(f"decoder.{out_i}", d[f"s{i}_out_w"])
    put("decoder.22", d["out_w"], d["out_b"])
    return sd


@pytest.mark.parametrize("suffix", [".pth", ".safetensors"])
def test_loader_roundtrip(params, tmp_path, suffix):
    """A taew2_1-style file written by the test reads back to the
    synthesizer's weights, bit for bit (the port's own readers)."""
    from lightx2v_tpu_torch.utils.safetensors_io import save_file

    jp, tp = params
    sd = _taehv_state_dict(jp)
    path = str(tmp_path / f"taew2_1{suffix}")
    if suffix == ".pth":
        torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    else:
        save_file(sd, path)
    got = dict(_leaves(ttiny.load_tiny_vae_params(path)))
    for k, v in _leaves(tp):
        assert torch.equal(got[k], v), k


def test_converter_tgrow_slice_vs_jax(params):
    """With time upscale off, a checkpoint's 2x TGrow weight keeps its last
    C output channels, as the JAX converter keeps them; the decode then
    keeps T frames."""
    jp, _ = params
    cfg_j = jtiny.TinyVAEConfig(decoder_time_upscale=(False, False))
    cfg_t = ttiny.TinyVAEConfig(decoder_time_upscale=(False, False))
    sd = _taehv_state_dict(jp)
    jc, tc = jtiny.convert_taehv_state_dict(sd, cfg_j), ttiny.convert_taehv_state_dict(sd, cfg_t)
    for k, v in _leaves(jc):
        assert np.array_equal(_hwio(dict(_leaves(tc))[k]), np.asarray(v)), k
    assert tc["decoder"]["s1_grow"]["w"].shape[0] == 128
    lat = np.random.default_rng(4).standard_normal((1, 2, 4, 4, 16)).astype(np.float32)
    out = ttiny.tiny_decode(tc, torch.from_numpy(lat), cfg_t).numpy()
    ref = np.asarray(jtiny.tiny_decode(jc, jnp.asarray(lat), cfg_j))
    assert out.shape == ref.shape == (1, 2, 32, 32, 3) and _max_err(out, ref) < 1e-5


# configs/wan_t2v_tiny_vae.json's keys (CFG at 6, shift 8) at a tiny size, 3 UniPC steps
TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)
RUN = dict(model_cls="wan2.1", task="t2v", synthetic_weights=True, prompt="a red panda climbing",
           negative_prompt="blurry", seed=42, enable_cfg=True, sample_guide_scale=6, sample_shift=8,
           infer_steps=3, target_video_length=9, target_height=64, target_width=96, latent_init="torch",
           text_len=64, self_attn_1_type="flash_attn3", cross_attn_1_type="flash_attn3", tiny_vae=True,
           tiny_vae_path="taew2_1.pth", use_tiling_vae=True, **TINY)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def test_tiny_vae_runner_vs_jax():
    """The synthetic runner draws the tiny VAE from seed 2 (the path is not
    read under ``synthetic_weights``), ignores ``use_tiling_vae`` and clips
    to [-1, 1]; latents and frames against the JAX runner."""
    from lightx2v_tpu.runners.wan_runner import WanRunner as JRunner
    from lightx2v_tpu.utils.config import set_config as jset
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    jr = JRunner(jset(dict(RUN)))
    tr = tinfer.init_runner(tset(dict(RUN, device="cpu")))
    assert torch.equal(tr.vae["decoder"]["out_w"], ttiny.init_random_tiny_vae_params(seed=2)["decoder"]["out_w"])
    j_lat, t_lat = np.asarray(jr.run_dit(jr.run_input_encoder())), tr.run_dit(tr.run_input_encoder())
    assert t_lat.shape == j_lat.shape == (16, 3, 8, 12) and _rel(t_lat.numpy(), j_lat) < 5e-2
    j_frames = jr.run_vae_decoder(jnp.asarray(j_lat))
    t_frames = tr.run_vae_decoder(torch.from_numpy(j_lat))
    assert t_frames.shape == j_frames.shape == (9, 64, 96, 3) and t_frames.dtype == np.float32
    assert t_frames.min() >= -1.0 and t_frames.max() <= 1.0
    assert _rel(t_frames, j_frames) < 1e-4, _rel(t_frames, j_frames)
    own = tr.run_vae_decoder(t_lat)
    assert own.shape == (9, 64, 96, 3) and np.isfinite(own).all()


def test_tiny_vae_refuses_i2v():
    """i2v encodes its image with the Wan VAE, which a ``tiny_vae`` runner
    does not load: the runner says so at load."""
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    with pytest.raises(ValueError, match="tiny_vae decodes only"):
        tinfer.init_runner(tset(dict(RUN, device="cpu", task="i2v", image_path="unused.png")))
