"""HunyuanVideo from a model directory on the CPU, port vs JAX package: the
DiT and VAE ``.pt`` files of the reference layout
(``hunyuan-video-t2v-720p/transformers/mp_rank_00_model_states.pt``,
``.../vae/pytorch_model.pt``) read by both packages' loaders to equal
params, and the port's state-dict writer mapping loaded params back to
the reference's keys; the runner with ``text_encoder_path`` (tiny HF Llama and CLIP-text
directories the test writes with ``transformers``, the recipe of
``tests/test_hf_text_encoders.py`` copied) against the JAX runner, as that
file's end-to-end test drives the JAX one; and the runner from a
``model_path`` layout (the small arch and VAE patched into the runner
module) against the small synthetic runner with the same text encoders.

Bars (relative L2 against the JAX runner, whose encoders run
``transformers`` in fp16 where the port's towers run bf16): the Llama
states 2e-2 and the pooled vector 2e-2 (measured 4.1e-3 and 6.2e-3), the
masks equal, the latents after 2 Euler steps 2e-2 (measured 1.2e-3: the
states' difference through the bf16 DiT). From ``model_path`` the latents
equal the synthetic runner's bit for bit: the same weights, read from
files."""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from lightx2v_tpu.encoders import hf_text as jhf  # noqa: E402
from lightx2v_tpu.models.hunyuan import config as jc  # noqa: E402
from lightx2v_tpu.models.hunyuan import weights as jw  # noqa: E402
from lightx2v_tpu.utils.config import set_config as jset  # noqa: E402
from lightx2v_tpu.vae import hunyuan_vae as jv  # noqa: E402
from lightx2v_tpu_torch.models.hunyuan import weights as tw  # noqa: E402
from lightx2v_tpu_torch.runners import hunyuan_runner as hr  # noqa: E402
from lightx2v_tpu_torch.utils.config import set_config as tset  # noqa: E402
from lightx2v_tpu_torch.vae import hunyuan_vae as tv  # noqa: E402

TOKEN_RE = r"<\|[a-z_]+\|>|<image>|\n\n|\n| |[A-Za-z0-9'{}]+|[^\sA-Za-z0-9]"
PROMPT = "a red panda climbing a tree"
RUN = dict(model_cls="hunyuan", task="t2v", prompt=PROMPT, seed=3, infer_steps=2, target_video_length=5,
           target_height=32, target_width=32, attention_type="xla", latent_init="torch",
           text_encoder_crop_start=7)
DIT_PT = ("hunyuan-video-t2v-720p", "transformers", "mp_rank_00_model_states.pt")
VAE_PT = ("hunyuan-video-t2v-720p", "vae", "pytorch_model.pt")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model directory in the reference's layout: ``text_encoder/`` (a
    4-layer Llama, width 32 = the small DiT's text states), ``text_encoder_2/``
    (a 2-layer CLIP text tower, width 16), and the small synthetic runner's
    DiT and VAE as ``.pt`` files."""
    from tokenizers import Regex, Tokenizer, models, pre_tokenizers
    from transformers import CLIPTextConfig, CLIPTextModel, LlamaConfig, LlamaModel, PreTrainedTokenizerFast

    root = tmp_path_factory.mktemp("hunyuan_model")
    words = sorted(set(re.findall(TOKEN_RE, jhf.PROMPT_TEMPLATE_VIDEO + PROMPT)))
    vocab = {"[PAD]": 0, "[UNK]": 1, **{w: i + 2 for i, w in enumerate(words)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Split(Regex(TOKEN_RE), behavior="isolated")
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]", unk_token="[UNK]")
    torch.manual_seed(0)
    LlamaModel(LlamaConfig(vocab_size=len(vocab) + 4, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
                           num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=2048)
               ).save_pretrained(root / "text_encoder")
    CLIPTextModel(CLIPTextConfig(vocab_size=len(vocab) + 4, hidden_size=16, intermediate_size=32,
                                 num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=77)
                  ).save_pretrained(root / "text_encoder_2")
    for d in ("text_encoder", "text_encoder_2"):
        fast.save_pretrained(root / d)
    sd = tw.init_random_hunyuan_state_dict(hr.SMALL_ARCH, seed=0, scale=0.05)
    os.makedirs(root.joinpath(*DIT_PT[:-1]))
    torch.save({"module": {k: torch.from_numpy(v) for k, v in sd.items()}}, root.joinpath(*DIT_PT))
    vsd = tv.init_random_hunyuan_vae_state_dict(hr.SMALL_VAE, seed=2)
    os.makedirs(root.joinpath(*VAE_PT[:-1]))
    torch.save({"state_dict": {f"vae.{k}": torch.from_numpy(v) for k, v in vsd.items()}}, root.joinpath(*VAE_PT))
    return root


def _flat(tree, prefix=""):
    """Leaves by dotted path; the JAX DiT's stacked blocks unstacked."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}.").items()}
    return {} if tree is None else {prefix[:-1]: np.asarray(tree.float() if torch.is_tensor(tree) else tree,
                                                           np.float32)}


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return None if tree is None else tree[i]


def _unstack(jp, n_double, n_single):
    return {**jp, "double_blocks": [_index(jp["double_blocks"], i) for i in range(n_double)],
            "single_blocks": [_index(jp["single_blocks"], i) for i in range(n_single)]}


def test_pt_loaders_vs_jax(model_dir):
    """Every leaf the port's ``.pt`` loaders give equals the JAX loaders'
    (bf16 linears, fp32 the rest; the VAE's conv kernels transposed to the
    JAX layout), encoder and decoder."""
    arch = hr.SMALL_ARCH
    got = _flat(tw.load_hunyuan_from_path(str(model_dir.joinpath(*DIT_PT)), arch))
    jp = jw.load_hunyuan_from_path(str(model_dir.joinpath(*DIT_PT)), jc.HunyuanArch(**dataclasses.asdict(arch)))
    want = _flat(_unstack(jp, arch.double_blocks, arch.single_blocks))
    assert set(got) == set(want) and len(got) > 100
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    vcfg = hr.SMALL_VAE
    got = _flat(tv.load_hunyuan_vae_from_path(str(model_dir.joinpath(*VAE_PT)), vcfg, encoder=True))
    want = _flat(jv.load_hunyuan_vae_from_path(str(model_dir.joinpath(*VAE_PT)),
                                               jv.HunyuanVAEConfig(**dataclasses.asdict(vcfg))))
    assert set(got) == set(want) and len(got) > 50
    for k, w in want.items():
        g = got[k].transpose(2, 3, 4, 1, 0) if got[k].ndim == 5 else got[k]
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_state_dict_writer_inverts_loader():
    """``hunyuan_params_to_state_dict`` (what writes the full-width DiT file
    on the card) maps the params ``load_hunyuan_params`` makes from a
    reference-layout state dict back to exactly its keys, shapes and
    (bf16-rounded) values."""
    arch = hr.SMALL_ARCH
    sd = tw.init_random_hunyuan_state_dict(arch, seed=1, scale=0.05)
    back = tw.hunyuan_params_to_state_dict(tw.load_hunyuan_params(sd, arch), arch)
    assert set(back) == set(sd) and len(sd) > 100
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].float().numpy(), v, err_msg=k)


@pytest.fixture(scope="module")
def runs(model_dir):
    """The port's runner with ``text_encoder_path`` (synthetic DiT and VAE),
    encoded and denoised; the JAX runner the same way."""
    from lightx2v_tpu.runners.hunyuan_runner import HunyuanRunner as JRunner
    from lightx2v_tpu_torch import infer as tinfer

    tr = tinfer.init_runner(tset(dict(RUN, synthetic_weights=True, text_encoder_path=str(model_dir), device="cpu")))
    t_enc = tr.run_input_encoder()
    jr = JRunner(jset(dict(RUN, synthetic_weights=True, text_encoder_path=str(model_dir))))
    j_enc = jr.run_input_encoder()
    return tr, t_enc, tr.run_dit(t_enc), j_enc, np.asarray(jr.run_dit(j_enc))


def test_runner_text_encoder_path_vs_jax(runs):
    tr, t_enc, t_lat, j_enc, j_lat = runs
    assert tr.text_encoder["llama"].arch.crop_start == 7 and tr.text_encoder["clip"].arch.dim == 16
    t, j = t_enc["text_encoder_output"], j_enc["text_encoder_output"]
    states, jstates = t["text_encoder_1_text_states"], np.asarray(j["text_encoder_1_text_states"])
    assert states.shape == jstates.shape == (1, 256, 32)
    assert _rel(states.float().numpy(), jstates) < 2e-2, _rel(states.float().numpy(), jstates)
    np.testing.assert_array_equal(t["text_encoder_1_attention_mask"], np.asarray(j["text_encoder_1_attention_mask"]))
    pooled, jpooled = t["text_encoder_2_text_states"], np.asarray(j["text_encoder_2_text_states"])
    assert pooled.shape == jpooled.shape == (1, 16)
    assert _rel(pooled.numpy(), jpooled) < 2e-2, _rel(pooled.numpy(), jpooled)
    assert tr.timings["kv_len"] == 2 * 2 * 2 + int(t["text_encoder_1_attention_mask"].sum())
    assert t_lat.shape == j_lat.shape == (16, 2, 4, 4)
    assert _rel(t_lat.numpy(), j_lat) < 2e-2, _rel(t_lat.numpy(), j_lat)


def test_runner_from_model_path_bit_for_bit(runs, model_dir, monkeypatch):
    """No ``synthetic_weights``: the DiT, the VAE and both text encoders from
    ``model_path`` (the small arch and VAE config patched in for
    ``HunyuanArch(task)`` and ``HunyuanVAEConfig()``); the latents equal the
    synthetic runner's bit for bit, and the decode (scaled, as from real
    weights) gives finite frames of the configured shape."""
    from lightx2v_tpu_torch import infer as tinfer

    monkeypatch.setattr(hr, "HunyuanArch", lambda task="t2v": dataclasses.replace(hr.SMALL_ARCH, task=task))
    monkeypatch.setattr(hr, "HunyuanVAEConfig", lambda: hr.SMALL_VAE)
    tr = tinfer.init_runner(tset(dict(RUN, model_path=str(model_dir), device="cpu")))
    assert tr.arch == hr.SMALL_ARCH and tr.vae_cfg == hr.SMALL_VAE
    lat = tr.run_dit(tr.run_input_encoder())
    assert torch.equal(lat, runs[2])
    frames = tr.run_vae_decoder(lat)
    assert frames.shape == (5, 32, 32, 3) and np.isfinite(frames).all()
