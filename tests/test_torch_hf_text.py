"""HunyuanVideo's HF text encoders read from model directories, port vs JAX
package, on tiny directories the test writes with ``transformers`` (the
recipe of ``tests/test_hf_text_encoders.py``, copied): a word-level
tokenizer covering the prompt templates, a Llama saved as ``LlamaModel``
(one ``model.safetensors``, no prefix) and as ``LlamaForCausalLM`` sharded
with a small ``max_shard_size`` (``model.safetensors.index.json``, keys under
``model.`` and an ``lm_head``), and ``CLIPTextModel``s at three
``eos_token_id``s.

The JAX encoders run ``transformers`` in fp16; the port's towers run bf16
(the dtype they run on the card). Bars, relative L2 against the JAX
output: the Llama states 2e-2 (measured 4.9e-3 to 5.3e-3 over the four
cases), the CLIP pooled vectors 2e-2 (measured 6.9e-3 to 1.1e-2); masks
and ids equal. The port's reader never reads the Llama blocks past
``num_layers - hidden_state_skip_layer``, the final norm or ``lm_head``.
Also: the port's HF config and state-dict writers, the inverses of its
readers, against what ``transformers`` wrote; the T5's ``encode_prompts``
on a tokenizer directory, equal to the JAX one (Queue 1 ID 6), and the
refusals: a Llama ``rope_scaling``, the
Llava encoder."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from lightx2v_tpu.encoders import hf_text as jhf  # noqa: E402
from lightx2v_tpu.encoders import tokenizer as jtok  # noqa: E402
from lightx2v_tpu_torch.encoders import hf_text as thf  # noqa: E402
from lightx2v_tpu_torch.encoders import clip as tclip  # noqa: E402
from lightx2v_tpu_torch.encoders import llama as tllama  # noqa: E402
from lightx2v_tpu_torch.encoders.clip import clip_pool_index  # noqa: E402
from lightx2v_tpu_torch.encoders import tokenizer as ttok  # noqa: E402
from lightx2v_tpu_torch.utils import safetensors_io  # noqa: E402

TOKEN_RE = r"<\|[a-z_]+\|>|<image>|\n\n|\n| |[A-Za-z0-9'{}]+|[^\sA-Za-z0-9]"
SAMPLE_TEXTS = ["a red panda climbing a tree", "two cats on the grass , realistic"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _build_tokenizer(tmpdir: str):
    """A tiny offline WordLevel fast tokenizer covering the Hunyuan prompt
    templates."""
    from tokenizers import Regex, Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    text = jhf.PROMPT_TEMPLATE_VIDEO + jhf.PROMPT_TEMPLATE_I2V + " ".join(SAMPLE_TEXTS)
    words = sorted(set(re.findall(TOKEN_RE, text)))
    vocab = {"[PAD]": 0, "[UNK]": 1}
    for w in words:
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Split(Regex(TOKEN_RE), behavior="isolated")
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]", unk_token="[UNK]")
    fast.save_pretrained(tmpdir)
    return fast, vocab


def _perturb(model, seed):
    """Random norms too (HF initializes them to ones and zeros)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return model


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from transformers import CLIPTextConfig, CLIPTextModel, LlamaConfig, LlamaForCausalLM, LlamaModel

    root = tmp_path_factory.mktemp("hf_text")
    fast, vocab = _build_tokenizer(str(root / "tok"))
    torch.manual_seed(0)
    llama_cfg = LlamaConfig(vocab_size=len(vocab) + 4, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
                            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=2048,
                            rope_theta=5e5, rms_norm_eps=1e-5)
    out = {"root": root, "vocab": vocab}
    out["llama"] = str(root / "llama")
    _perturb(LlamaModel(llama_cfg), 1).save_pretrained(out["llama"])
    out["llama_sharded"] = str(root / "llama_sharded")
    _perturb(LlamaForCausalLM(llama_cfg), 2).save_pretrained(out["llama_sharded"], max_shard_size="20KB")
    for eos in (2, vocab["tree"], 49407):  # legacy argmax; a token the prompts hold; one they lack (row 0)
        clip_cfg = CLIPTextConfig(vocab_size=len(vocab) + 4, hidden_size=16, intermediate_size=32,
                                  num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=77,
                                  eos_token_id=eos)
        out[f"clip_{eos}"] = str(root / f"clip_{eos}")
        _perturb(CLIPTextModel(clip_cfg), 3).save_pretrained(out[f"clip_{eos}"])
    for d in [v for k, v in out.items() if k.startswith(("llama", "clip"))]:
        fast.save_pretrained(d)
    return out


@pytest.mark.parametrize("which,crop", [("llama", 7), ("llama", None), ("llama_sharded", 7),
                                        ("llama_sharded", None)])
def test_llama_dir_vs_jax(dirs, which, crop, monkeypatch):
    """The video template, the crop (7, and the default 95) and the states
    after 2 of 4 blocks; the sharded ``LlamaForCausalLM`` directory read
    through its index with the ``model.`` prefix, blocks 2-3, the final norm
    and ``lm_head`` never read."""
    assert thf.PROMPT_TEMPLATE == jhf.PROMPT_TEMPLATE_VIDEO
    path = dirs[which]
    if which == "llama_sharded":
        index = json.load(open(f"{path}/model.safetensors.index.json"))["weight_map"]
        assert len(set(index.values())) > 1 and "lm_head.weight" in index and "model.norm.weight" in index
    kw = {} if crop is None else {"crop_start": crop}
    jstates, jmask = jhf.TextEncoderHFLlamaModel(path, "cpu", **kw).infer([SAMPLE_TEXTS[0]], None)
    read = []
    get = safetensors_io.SafetensorsFile.get_tensor
    monkeypatch.setattr(safetensors_io.SafetensorsFile, "get_tensor", lambda f, k: read.append(k) or get(f, k))
    enc = thf.TextEncoderHFLlamaModel(path, "cpu", **kw)
    assert enc.arch.max_length == (crop or 95) + 256 and enc.arch.run_layers == 2 and enc.arch.num_kv_heads == 2
    assert len(read) == 1 + 2 * 9 and not [k for k in read if "layers.2" in k or "layers.3" in k or "head" in k]
    states, mask = enc.infer([SAMPLE_TEXTS[0]])
    assert states.dtype == torch.bfloat16 and states.shape == jstates.shape == (1, 256, 32)
    np.testing.assert_array_equal(mask, jmask)
    assert _rel(states.float().numpy(), jstates) < 2e-2, _rel(states.float().numpy(), jstates)


@pytest.mark.parametrize("eos", ["2", "tree", "49407"])
def test_clip_dir_vs_jax(dirs, eos):
    """The pooled vector by HF's rule for the config's ``eos_token_id``: the
    argmax of the ids at the legacy 2, else the first ``eos_token_id`` (the
    word "tree", in one of the two prompts), row 0 where the ids lack it."""
    eos_id = dirs["vocab"]["tree"] if eos == "tree" else int(eos)
    path = dirs[f"clip_{eos_id}"]
    jpool = jhf.TextEncoderHFClipModel(path, "cpu").infer(SAMPLE_TEXTS, None)
    enc = thf.TextEncoderHFClipModel(path, "cpu")
    assert enc.arch.eos_token_id == eos_id and enc.arch.dim == 16 and enc.arch.mlp_ratio == 2
    ids, _ = enc.tokenizer(SAMPLE_TEXTS, return_mask=True)
    want_rows = {"2": ids.argmax(-1), "tree": [(ids[0] == eos_id).argmax(), 0], "49407": [0, 0]}[eos]
    assert list(clip_pool_index(torch.from_numpy(ids), eos_id).numpy()) == list(want_rows)
    pooled = enc.infer(SAMPLE_TEXTS)
    assert pooled.dtype == torch.float32 and pooled.shape == jpool.shape == (2, 16)
    assert _rel(pooled.numpy(), jpool) < 2e-2, _rel(pooled.numpy(), jpool)


@pytest.mark.parametrize("which", ["llama_sharded", "clip_2"])
def test_hf_writers_invert_readers(dirs, which):
    """``llama_hf_config`` / ``clip_text_hf_config`` and
    ``llama_params_to_hf_state_dict`` / ``clip_text_params_to_hf_state_dict``
    (what writes a full-width directory on the card) against the directory
    ``transformers`` wrote: the config keys with HF's values, the arch read
    back unchanged, and the loaded params mapped back to exactly the keys the
    loader reads, each value the file's in the loader's dtype."""
    path = dirs[which]
    hf_cfg = safetensors_io.read_config(path)
    if which == "llama_sharded":
        arch = tllama.llama_arch_from_config(hf_cfg, 7, 2)
        cfg = tllama.llama_hf_config(arch)
        assert tllama.llama_arch_from_config(cfg, 7, 2) == arch
        files = safetensors_io.load_dir(path)
        back = tllama.llama_params_to_hf_state_dict(tllama.load_llama_params(files, arch))
        read = {k for k in files if k.startswith(("model.embed_tokens.", "model.layers.0.", "model.layers.1."))}
    else:
        arch = tclip.clip_text_arch_from_config(hf_cfg)
        cfg = tclip.clip_text_hf_config(arch)
        assert tclip.clip_text_arch_from_config(cfg) == arch
        files = safetensors_io.load_dir(path)
        back = tclip.clip_text_params_to_hf_state_dict(tclip.load_clip_text_params(files, arch))
        read = {k for k in files if not k.endswith("position_ids")}
    assert {k: hf_cfg.get(k) for k in cfg if k != "torch_dtype"} == {k: v for k, v in cfg.items() if k != "torch_dtype"}
    assert set(back) == read and len(read) > 10
    for k, v in back.items():
        assert v.shape == files[k].shape, k
        assert torch.equal(v, files[k].to(v.dtype)), k


def test_t5_tokenizer_dir_vs_jax(dirs):
    """``encode_prompts`` (the T5's tokenizer call: the prompt cleaned, padded
    to the text length) on a tokenizer directory equals the JAX one; the HF
    encoders' call does not clean the prompt."""
    path = str(dirs["root"] / "tok")
    prompts = ["a red  panda &amp;amp; a tree", "two cats on the grass , realistic"]
    for got, want in zip(ttok.encode_prompts(path, prompts, 16), jtok.encode_prompts(path, prompts, 16)):
        assert got.shape == (2, 16)
        np.testing.assert_array_equal(got, want)
    ids, mask = ttok.hf_tokenize(path, prompts[:1], 16)
    assert mask.sum() > ttok.encode_prompts(path, prompts[:1], 16)[1].sum()  # the double space stays a token


def test_refusals(dirs, tmp_path):
    """A Llama ``rope_scaling`` (and biased projections) and the Llava
    encoder raise ``NotImplementedError`` naming their Queue 1 items."""
    cfg = json.load(open(f"{dirs['llama']}/config.json"))
    for extra in ({"rope_scaling": {"rope_type": "llama3", "factor": 8.0}}, {"attention_bias": True}):
        d = tmp_path / next(iter(extra))
        d.mkdir()
        (d / "config.json").write_text(json.dumps({**cfg, **extra}))
        with pytest.raises(NotImplementedError, match="item 22"):
            thf.TextEncoderHFLlamaModel(str(d), "cpu")
    with pytest.raises(NotImplementedError, match="item 21"):
        thf.TextEncoderHFLlavaModel(dirs["llama"], "cpu")
