"""The wav2vec-class audio encoder read from HF directories, port vs JAX
package (``lightx2v_tpu.encoders.audio.AudioEncoder(path).infer_array``,
which runs ``transformers``' ``AutoFeatureExtractor`` and ``AutoModel``),
on tiny ``Wav2Vec2Model``, ``HubertModel`` and ``WavLMModel`` directories
the test writes with ``transformers``: group and layer conv norms, post-LN
and stable (pre-LN) encoders, conv biases on and off, an even and an odd
positional kernel, HuBERT without its projection LayerNorm, both weight-norm
key layouts (``parametrizations.weight.original0/1`` as ``transformers``
4.57 saves, ``weight_g`` / ``weight_v`` of older checkpoints), a task
model's ``wav2vec2.`` prefix and head, ``do_normalize`` off, a 768-wide
tower zero-padded to 1024 features, and the ``audio_encoder/`` subfolder
rule. Every parameter, norms included, is randomized.

Both sides run fp32 on the CPU. Bar: max abs difference 1e-4 of the
features' max abs (measured up to 1.9e-6), on 22,050 Hz input resampled to
16 kHz, for 9 and 21 frames at 16 fps (the waveform padded for 21). Also
the WavLM bucket table against HF's, the device synthesizer's layout
against the loader's, and an unknown ``model_type`` refused."""

from __future__ import annotations

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from lightx2v_tpu.encoders import audio as jaudio  # noqa: E402
from lightx2v_tpu_torch.encoders import audio as taudio  # noqa: E402
from lightx2v_tpu_torch.encoders import wav2vec as tw  # noqa: E402
from lightx2v_tpu_torch.utils.safetensors_io import load_file, save_file  # noqa: E402

SMALL = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
             conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4)
CASES = {
    "wav2vec2_group": ("wav2vec2", {}),
    "wav2vec2_layer_stable": ("wav2vec2", dict(feat_extract_norm="layer", do_stable_layer_norm=True,
                                               conv_bias=True, num_conv_pos_embeddings=15)),
    "hubert_layer_stable": ("hubert", dict(feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True)),
    "hubert_no_proj_norm": ("hubert", dict(feat_proj_layer_norm=False)),
    "wavlm_group": ("wavlm", dict(num_buckets=32, max_bucket_distance=64)),
    "wavlm_layer_stable": ("wavlm", dict(feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True,
                                         num_buckets=32, max_bucket_distance=64)),
    "wavlm_768": ("wavlm", dict(hidden_size=768, num_attention_heads=12, num_hidden_layers=1,
                                num_conv_pos_embedding_groups=16, num_buckets=32, max_bucket_distance=64)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, model_type, extra, seed, do_normalize=True):
    from transformers import (HubertConfig, HubertModel, Wav2Vec2Config, Wav2Vec2FeatureExtractor, Wav2Vec2Model,
                              WavLMConfig, WavLMModel)

    cls = {"wav2vec2": (Wav2Vec2Config, Wav2Vec2Model), "hubert": (HubertConfig, HubertModel),
           "wavlm": (WavLMConfig, WavLMModel)}[model_type]
    torch.manual_seed(seed)
    model = cls[1](cls[0](**{**SMALL, **extra}))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    model.save_pretrained(path)
    Wav2Vec2FeatureExtractor(do_normalize=do_normalize, return_attention_mask=True).save_pretrained(path)
    return str(path)


def _wave(n=13_000, sr=22_050, seed=0):
    t = np.arange(n) / sr
    noise = np.random.default_rng(seed).standard_normal(n)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * noise + 0.1).astype(np.float32), sr


def _check(path, jpath=None, frames=(9, 21)):
    wave, sr = _wave()
    jenc, tenc = jaudio.AudioEncoder(jpath or path), taudio.AudioEncoder(path, device="cpu")
    for n in frames:
        want = jenc.infer_array(wave, sr, n)
        got = tenc.infer_array(wave, sr, n)
        assert got.shape == want.shape == (1, n, 1024) and got.dtype == np.float32
        err = float(np.abs(got - want).max())
        assert err < 1e-4 * float(np.abs(want).max()), (err, float(np.abs(want).max()))
    return tenc


@pytest.mark.parametrize("case", list(CASES))
def test_encoder_vs_jax(case, tmp_path):
    model_type, extra = CASES[case]
    enc = _check(_write(tmp_path / case, model_type, extra, seed=len(case)))
    assert enc.model.arch.model_type == model_type and enc.model.arch.hidden_size == extra.get("hidden_size", 32)


def test_old_weight_norm_keys_and_task_prefix(tmp_path):
    """The pos conv as ``weight_g`` / ``weight_v`` under the task model's
    ``wav2vec2.`` prefix, with a CTC head the base model never reads;
    ``do_normalize`` off."""
    path = _write(tmp_path / "w2v", "wav2vec2", {}, seed=5, do_normalize=False)
    sd = load_file(f"{path}/model.safetensors")
    renamed = {"wav2vec2." + k.replace("parametrizations.weight.original0", "weight_g")
               .replace("parametrizations.weight.original1", "weight_v"): v for k, v in sd.items()}
    assert sum(k.endswith(("weight_g", "weight_v")) for k in renamed) == 2
    renamed["lm_head.weight"] = torch.zeros((8, 32))
    save_file(renamed, f"{path}/model.safetensors")
    cfg = json.load(open(f"{path}/config.json"))
    (tmp_path / "w2v" / "config.json").write_text(json.dumps({**cfg, "architectures": ["Wav2Vec2ForCTC"]}))
    assert not tw.Wav2VecModel(path, "cpu").preprocessor["do_normalize"]
    _check(path)


def test_audio_encoder_subfolder(tmp_path):
    """A model directory with an ``audio_encoder/`` subfolder reads the
    subfolder, as the JAX encoder does."""
    _write(tmp_path / "model" / "audio_encoder", "hubert", {}, seed=7)
    (tmp_path / "model" / "config.json").write_text(json.dumps({"model_type": "not-an-audio-model"}))
    _check(str(tmp_path / "model"), frames=(9,))


def test_wavlm_buckets_vs_hf():
    from transformers.models.wavlm.modeling_wavlm import WavLMAttention

    attn = WavLMAttention(32, 4, num_buckets=320, max_distance=800)
    pos = torch.arange(300)
    want = attn._relative_positions_bucket(pos[None, :] - pos[:, None])
    torch.testing.assert_close(tw.relative_position_buckets(300, 320, 800, "cpu"), want, rtol=0, atol=0)


@pytest.mark.parametrize("published", [tw.WAVLM_BASE_PLUS, tw.HUBERT_LARGE], ids=["wavlm", "hubert"])
def test_device_synthesizer_layout(published, tmp_path):
    """``write_random_wav2vec_dir`` (here on the CPU at a small width, with
    the published arch's norms and layer order) writes a directory that HF's
    model and the port's loader both read: every key of HF's state dict, the
    same shapes, and the two forwards within the bar."""
    from transformers import AutoModel

    arch = dataclasses.replace(published, **SMALL, num_buckets=32, max_bucket_distance=64)
    tw.write_random_wav2vec_dir(str(tmp_path / "syn"), arch, seed=3, device="cpu")
    ref = AutoModel.from_pretrained(str(tmp_path / "syn")).state_dict()
    got = load_file(str(tmp_path / "syn" / "model.safetensors"))
    assert set(got) == set(ref) and all(got[k].shape == ref[k].shape for k in ref)
    _check(str(tmp_path / "syn"), frames=(9,))
    shutil.rmtree(tmp_path / "syn")


def test_unknown_model_type(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "data2vec-audio"}))
    with pytest.raises(NotImplementedError, match="item 23"):
        taudio.AudioEncoder(str(tmp_path), device="cpu")
