"""Audio-driven i2v on the CPU, port vs JAX package: the audio features, the
adapter (its checkpoint loader, carry-over, projection, time embedding and
Perceiver injection), the PIL mux against the JAX mux, and the runner over
two segments.

The features are host numpy on both sides: equal bit for bit. The adapter
from one reference-keyed state dict (the port reads it from a
``.safetensors`` and a ``.pt`` file the test writes, the JAX loader takes
the dict):
weights equal, the time embedding within 1e-5 relative L2 (fp32; measured
5.1e-8), the projection and one injection within 1e-2 (bf16 operands, fp32
sums in another order; measured 0 and 4.4e-8). The mux: the same box tree,
every box but the JPEG-sized ones byte for byte, and the PCM bytes of
``mux_mp4_pcm``; the frames decoded back within a mean 3% of full scale of
the input (quality 92 on noisy frames: measured 1.8%). Where PIL and cv2
link the same libjpeg the two files are equal byte for byte; the test holds
only what does not depend on the JPEG encoder. The RIFF-AVI mux
the same way.

Runner: the tiny arch (dim 256, 2 heads of 128, 2 layers, 36 input
channels: 16 latent + 16 previous-segment + 4 mask, as the JAX test), 9
frames of 64 x 96 a segment, 2 Euler steps, a 1 s wav and
``video_duration`` 13/16 s: 2 segments (9 frames, then 4 more after the
5-frame overlap), the second conditioned on the first's last frames. The
latents of each segment from the CPU torch stream on both sides
(``latent_init: "torch"``); bars relative L2 1e-2 on each segment's latents
and on the stitched frames (measured 1.5e-3 / 1.6e-3, 1.4e-4)."""

import io
import struct
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.encoders import audio as jaudio
from lightx2v_tpu.models.wan import audio_adapter as jad
from lightx2v_tpu.utils import media as jmedia
from lightx2v_tpu.utils.config import set_config as jset
from lightx2v_tpu_torch.encoders import audio as taudio
from lightx2v_tpu_torch.models.wan import audio_adapter as tad
from lightx2v_tpu_torch.utils import media as tmedia
from lightx2v_tpu_torch.utils.config import set_config as tset
from lightx2v_tpu_torch.utils.safetensors_io import save_file

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)
CFG = dict(model_cls="wan2.1_audio", task="t2v", synthetic_weights=True, prompt="a person talking", seed=42,
           enable_cfg=False, target_video_length=9, target_height=64, target_width=96, infer_steps=2,
           sample_shift=5, text_len=64, latent_init="torch", self_attn_1_type="radial_attn",
           cross_attn_1_type="flash_attn3", in_dim=36, video_duration=13 / 16, target_fps=16, **TINY)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _write_wav(path, seconds, sr=16000, channels=1):
    t = np.arange(int(seconds * sr)) / sr
    s = np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    s = (s * 18000 + np.random.default_rng(0).normal(0, 500, t.shape)).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.repeat(s[:, None], channels, axis=1).tobytes())
    return str(path)


def test_features_bit_for_bit(tmp_path):
    path = _write_wav(tmp_path / "s.wav", 0.7, sr=22050, channels=2)
    (jw, jsr), (tw, tsr) = jaudio.read_wav(path), taudio.read_wav(path)
    assert jsr == tsr == 22050
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(taudio.resample_linear(tw, tsr), jaudio.resample_linear(jw, jsr))
    for frames in (9, 81):  # 81: rows past the waveform's end stay zero
        np.testing.assert_array_equal(taudio.envelope_features(tw, tsr, frames),
                                      jaudio.envelope_features(jw, jsr, frames))
    np.testing.assert_array_equal(taudio.AudioEncoder(None).infer(path, 9), jaudio.AudioEncoder(None).infer(path, 9))
    hidden = np.random.default_rng(1).standard_normal((35, 16)).astype(np.float32)
    for n in (35, 9, 81):
        np.testing.assert_array_equal(taudio._interp_time(hidden, n), jaudio._interp_time(hidden, n))


def test_wav2vec_encoder_refused():
    with pytest.raises(NotImplementedError, match="item 20"):
        taudio.AudioEncoder("/nonexistent/wav2vec")


def _reference_state_dict(dim=64, kv_dim=16, feat=40, ntok=4, n_ca=2, freq=32):
    """The reference adapter's keys (``tests/test_df_causvid.py``'s loader
    test), with a real time embedding and ``audio_pe``."""
    rng = np.random.default_rng(0)
    r = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)  # noqa: E731
    sd = {}
    for idx, (i, o) in zip((0, 2, 4), [(feat * 5, 32), (32, 32), (32, ntok * kv_dim)]):
        sd[f"audio_proj.mlp.{idx}.weight"], sd[f"audio_proj.mlp.{idx}.bias"] = r(o, i), r(o)
    sd["audio_proj.norm.weight"], sd["audio_proj.norm.bias"] = 1 + r(kv_dim), r(kv_dim)
    sd["audio_pe"] = r(4 * ntok, kv_dim)
    for i in range(n_ca):
        sd[f"ca.{i}.norm_kv.weight"], sd[f"ca.{i}.norm_kv.bias"] = 1 + r(kv_dim), r(kv_dim)
        for name, (o, k) in dict(to_q=(dim, dim), to_kv=(2 * dim, kv_dim), to_out=(dim, dim)).items():
            sd[f"ca.{i}.{name}.weight"], sd[f"ca.{i}.{name}.bias"] = r(o, k), r(o)
        sd[f"ca.{i}.shift_scale_gate"] = r(1, 3, dim)
    sd["time_embedding.time_embedder.linear_1.weight"], sd["time_embedding.time_embedder.linear_1.bias"] = \
        r(dim, freq), r(dim)
    sd["time_embedding.time_embedder.linear_2.weight"], sd["time_embedding.time_embedder.linear_2.bias"] = \
        r(dim, dim), r(dim)
    sd["time_embedding.time_proj.weight"], sd["time_embedding.time_proj.bias"] = r(3 * dim, dim), r(3 * dim)
    return sd


def test_adapter_from_safetensors_vs_jax(tmp_path):
    sd = _reference_state_dict()
    path = str(tmp_path / "audio_adapter.safetensors")
    save_file(sd, path)
    from lightx2v_tpu_torch.utils.safetensors_io import read_state_dict

    jp = jad.load_audio_adapter(sd, interval=1, heads=4)
    tp = tad.load_audio_adapter(read_state_dict(path), interval=1, heads=4)
    pt = str(tmp_path / "audio_adapter.pt")  # the torch checkpoint form
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt)
    tp_pt = tad.load_audio_adapter(read_state_dict(pt), interval=1, heads=4)
    assert torch.equal(tp_pt["ca_blocks"][0]["to_out"]["w"], tp["ca_blocks"][0]["to_out"]["w"])
    assert torch.equal(tp_pt["time_embedding"]["time_proj"]["b"], tp["time_embedding"]["time_proj"]["b"])
    assert tp["num_tokens"] == jp["num_tokens"] == 4 and len(tp["ca_blocks"]) == 2
    np.testing.assert_array_equal(tp["ca_blocks"][1]["to_kv"]["w"].numpy(),
                                  np.asarray(jp["ca_blocks"]["to_kv"]["w"][1]))
    np.testing.assert_array_equal(tp["proj"]["audio_pe"].numpy(), np.asarray(jp["proj"]["audio_pe"]))

    t = np.array([217.0], np.float32)
    j_temb = jad.audio_time_embedding(jp["time_embedding"], jnp.asarray(t), freq_dim=32)
    t_temb = tad.audio_time_embedding(tp["time_embedding"], torch.from_numpy(t), freq_dim=32)
    assert tuple(t_temb.shape) == j_temb.shape == (1, 3, 64)
    assert _rel(t_temb, np.asarray(j_temb)) < 1e-5, _rel(t_temb, np.asarray(j_temb))

    feats = np.random.default_rng(2).standard_normal((1, 9, 40)).astype(np.float32)
    j_tok = jad.audio_projection(jp["proj"], jnp.asarray(feats), 3, num_tokens=4)
    t_tok = tad.audio_projection(tp["proj"], torch.from_numpy(feats), 3, num_tokens=4)
    assert tuple(t_tok.shape) == j_tok.shape == (1, 3, 16, 16) and t_tok.dtype == torch.bfloat16
    assert _rel(t_tok.float(), np.asarray(j_tok, np.float32)) < 1e-2, _rel(t_tok.float(), np.asarray(j_tok, np.float32))

    lat = np.random.default_rng(3).standard_normal((1, 3, 6, 64)).astype(np.float32)
    j_ca = jax.tree_util.tree_map(lambda a: a[1], jp["ca_blocks"])
    j_delta = jad.perceiver_ca(j_ca, j_tok, jnp.asarray(lat, jnp.bfloat16), j_temb, heads=4)
    t_delta = tad.perceiver_ca(tp["ca_blocks"][1], t_tok, torch.from_numpy(lat).to(torch.bfloat16), t_temb, heads=4)
    assert tuple(t_delta.shape) == j_delta.shape == (1, 3, 6, 64) and t_delta.dtype == torch.float32
    assert _rel(t_delta, np.asarray(j_delta)) < 1e-2, _rel(t_delta, np.asarray(j_delta))


def test_adapter_carry_over_and_synthesizer():
    """The JAX synthesizer's pytree carried across equals the port's host
    synthesizer bit for bit, in the JAX dtypes (fp32)."""
    j = jad.init_random_audio_adapter(dim=256, kv_dim=768, num_layers=2, interval=1, heads=2, seed=7)
    carried, made = tad.adapter_from_tree(j), tad.init_random_audio_adapter(dim=256, num_layers=2, heads=2, seed=7)
    assert len(carried["ca_blocks"]) == len(made["ca_blocks"]) == 2
    flat = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])  # noqa: E731
    fc, fm = flat(carried), flat(made)
    assert fc.keys() == fm.keys()
    for key, v in fc.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == torch.float32 and torch.equal(v, fm[key]), key
        else:
            assert v == fm[key], key
    np.testing.assert_array_equal(carried["ca_blocks"][1]["to_q"]["w"].numpy(),
                                  np.asarray(j["ca_blocks"]["to_q"]["w"][1]))
    assert tad.adapter_bytes(made) == 4 * sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(j)
                                             if hasattr(a, "shape"))


def _boxes(raw, lo=0, hi=None, depth=0):
    """The ISO BMFF box tree: (depth, fourcc, payload) for every box."""
    hi, out = len(raw) if hi is None else hi, []
    while lo < hi:
        size, cc = struct.unpack(">I4s", raw[lo:lo + 8])
        out.append((depth, cc, raw[lo + 8:lo + size]))
        if cc in (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf"):
            out += _boxes(raw, lo + 8, lo + size, depth + 1)
        lo += size
    return out


def test_mux_vs_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:48, 0:64] / 64.0
    frames = np.stack([np.stack([np.sin(yy * 6 + i), np.cos(xx * 5 - i), yy - xx], -1) for i in range(5)])
    frames = np.clip(frames + rng.normal(0, 0.05, frames.shape), -1, 1).astype(np.float32)
    audio = (np.sin(np.arange(5000) / 7.0) * 0.6).astype(np.float32)
    j_raw = open(jmedia.mux_mp4_pcm(frames, audio, 16000, str(tmp_path / "j.av.mp4"), fps=16), "rb").read()
    t_raw = open(tmedia.mux_mp4_pcm(frames, audio, 16000, str(tmp_path / "t.av.mp4"), fps=16), "rb").read()
    jb, tb = _boxes(j_raw), _boxes(t_raw)
    assert [(d, c) for d, c, _ in tb] == [(d, c) for d, c, _ in jb]
    jpeg_sized = (b"mdat", b"stsz", b"stco")  # the JPEG sizes move these; the rest is byte for byte
    for (_, c, tp), (_, _, jp) in zip(tb, jb):
        if c not in jpeg_sized + (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
            assert tp == jp, c
    t_mdat, j_mdat = [p for _, c, p in tb if c == b"mdat"][0], [p for _, c, p in jb if c == b"mdat"][0]
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    assert t_mdat.endswith(pcm) and j_mdat.endswith(pcm)
    stsz = [p for _, c, p in tb if c == b"stsz"]
    sizes = struct.unpack(">%dI" % 5, stsz[0][12:12 + 20])
    assert stsz[1] == [p for _, c, p in jb if c == b"stsz"][1]  # the audio table: constant size 2, n samples
    want = tmedia.to_uint8_frames(frames).astype(np.float64)
    off = 0
    for i, n in enumerate(sizes):  # the port's JPEGs, decoded back
        got = np.asarray(Image.open(io.BytesIO(t_mdat[off:off + n])).convert("RGB"), np.float64)
        assert np.abs(got - want[i]).mean() < 0.03 * 255, np.abs(got - want[i]).mean()
        off += n
    assert off + len(pcm) == len(t_mdat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from lightx2v_tpu.runners.wan_audio_runner import WanAudioRunner as JRunner
    from lightx2v_tpu.vae import wan_vae as jvae
    from lightx2v_tpu_torch import infer as tinfer
    from test_torch_vae_encode import jit_vae

    cfg = dict(CFG, audio_path=_write_wav(tmp_path_factory.mktemp("audio") / "a.wav", 1.0))
    out = {}
    for side, make in (("jax", lambda: JRunner(jset(dict(cfg)))),
                       ("torch", lambda: tinfer.init_runner(tset(dict(cfg, device="cpu"))))):
        r = make()
        lat, orig = [], r.run_dit
        r.run_dit = lambda enc, orig=orig, lat=lat: lat.append(orig(enc)) or lat[-1]
        mp = pytest.MonkeyPatch()
        if side == "jax":  # the JAX encode as one compiled program
            enc = jvae.vae_encode
            mp.setattr(jvae, "vae_encode", lambda params, x, c, scale: jnp.asarray(
                jit_vae(enc, params, x, c, scale=scale)))
        out[side] = dict(runner=r, frames=r.run_pipeline(save_video=False), latents=lat)
        mp.undo()
    return out


def test_runner_two_segments_vs_jax(runs):
    j, t = runs["jax"], runs["torch"]
    assert len(t["latents"]) == len(j["latents"]) == 2
    for tl, jl in zip(t["latents"], j["latents"]):
        assert tuple(tl.shape) == jl.shape == (16, 3, 8, 12) and torch.isfinite(tl).all()
        assert _rel(tl, np.asarray(jl)) < 1e-2, _rel(tl, np.asarray(jl))
    assert t["frames"].shape == j["frames"].shape == (13, 64, 96, 3)
    assert _rel(t["frames"], j["frames"]) < 1e-2, _rel(t["frames"], j["frames"])
    tr = t["runner"]
    audio, sr = tr.audio_track
    assert sr == 16000 and len(audio) == round(13 * sr / 16)
    assert len(tr.timings["step_s"]) == 4 and {"prev_cond_s_1", "dit_s", "decode_s"} <= set(tr.timings)


def test_runner_mux(runs, tmp_path):
    tr = runs["torch"]["runner"]
    tr.config["save_video_path"] = str(tmp_path / "out.mp4")
    raw = open(tr._mux_av(runs["torch"]["frames"], *tr.audio_track), "rb").read()
    assert raw[4:8] == b"ftyp" and b"sowt" in raw and (tmp_path / "out.av.mp4").is_file()


@pytest.mark.parametrize("extra,err,match", [
    (dict(cpu_offload=True), NotImplementedError, "resident"),
    (dict(feature_caching="Tea"), NotImplementedError, "caching"),
    (dict(changing_resolution=True), NotImplementedError, "one resolution"),
    (dict(mesh_shape={"seq": 2}), NotImplementedError, "item 14"),
    (dict(lazy_load=True), NotImplementedError, "resident"),
    (dict(synthetic_weights=False, model_path="/nonexistent"), NotImplementedError, "item 20"),
])
def test_runner_refusals(extra, err, match, tmp_path):
    """What the JAX audio runner does not run raises before any weight is
    made; so does a real (wav2vec) audio encoder, which the port lacks."""
    from lightx2v_tpu_torch import infer as tinfer

    with pytest.raises(err, match=match):
        tinfer.init_runner(tset(dict(CFG, device="cpu", audio_path=_write_wav(tmp_path / "a.wav", 0.1), **extra)))


def test_entry_point_smoke_config(tmp_path):
    """``infer.init_runner`` on the JAX tests' smoke config (the small
    synthetic stack) with a 1 s wav, as ``tests/test_df_causvid.py``."""
    from lightx2v_tpu_torch import infer

    args = infer.build_parser().parse_args([
        "--model_cls", "wan2.1_audio", "--config_json", str(ROOT / "configs/wan_t2v_synthetic_smoke.json"),
        "--prompt", "a person talking", "--audio_path", _write_wav(tmp_path / "a.wav", 1.0),
        "--synthetic_weights", "--device", "cpu"])
    cfg = tset(args)
    cfg["enable_cfg"] = False
    frames = infer.init_runner(cfg).run_pipeline(save_video=False)
    assert frames.shape == (9, 64, 96, 3) and np.isfinite(frames).all()


def _riff(raw, lo, hi):
    """The RIFF chunk list: (fourcc, payload), LIST payloads expanded."""
    out = []
    while lo < hi:
        cc, size = raw[lo:lo + 4], struct.unpack("<I", raw[lo + 4:lo + 8])[0]
        if cc in (b"RIFF", b"LIST"):
            out.append((cc + raw[lo + 8:lo + 12], b""))
            out += _riff(raw, lo + 12, lo + 8 + size)
        else:
            out.append((cc, raw[lo + 8:lo + 8 + size]))
        lo += 8 + size + (size & 1)
    return out


def test_avi_mux_vs_jax(tmp_path):
    """The RIFF-AVI mux (``mux_container: "avi"``): the chunk sequence of
    ``mux_avi_pcm``, its interleaved PCM chunks byte for byte."""
    frames = np.random.default_rng(5).uniform(-1, 1, (3, 16, 24, 3)).astype(np.float32)
    audio = (np.sin(np.arange(3000) / 5.0) * 0.5).astype(np.float32)
    j = open(jmedia.mux_avi_pcm(frames, audio, 16000, str(tmp_path / "j.avi"), fps=16), "rb").read()
    t = open(tmedia.mux_avi_pcm(frames, audio, 16000, str(tmp_path / "t.avi"), fps=16), "rb").read()
    jc, tc = _riff(j, 0, len(j)), _riff(t, 0, len(t))
    assert [c for c, _ in tc] == [c for c, _ in jc]
    fixed = (b"01wb", b"strh", b"strf")
    assert [p for c, p in tc if c in fixed] == [p for c, p in jc if c in fixed]
