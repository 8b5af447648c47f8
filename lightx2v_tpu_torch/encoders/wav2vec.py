"""wav2vec-class audio tower in plain PyTorch: what the JAX package runs
through ``transformers.AutoModel`` for the audio encoders of the reference
(``lightx2v_tpu.encoders.audio``; ``wav2vec2``, ``hubert`` and ``wavlm``, the
last its default, wavlm-base-plus). ``last_hidden_state`` of a 16 kHz
waveform, in fp32 on the card or the CPU, as the JAX encoder runs it.

The tower, as HF's ``Wav2Vec2Model`` / ``HubertModel`` / ``WavLMModel``
compute it at inference:

- the conv feature encoder: seven conv1d layers of 512 channels (kernels 10,
  3, 3, 3, 3, 2, 2; strides 5, 2, ...: 320 samples a frame, 50 frames a
  second), bias when ``conv_bias``, exact GELU after each; with
  ``feat_extract_norm`` "group" a GroupNorm of one channel a group on the
  first layer only, with "layer" a LayerNorm over the channels on every
  layer;
- the feature projection: LayerNorm (HuBERT: when ``feat_proj_layer_norm``),
  then a linear to ``hidden_size``;
- the positional conv: kernel 128 over ``num_conv_pos_embedding_groups``
  groups with weight norm over ``dim=2`` (read from ``weight_g`` /
  ``weight_v`` or from ``parametrizations.weight.original0`` /
  ``original1``, the layout ``transformers`` 4.57 saves), the last frame
  dropped (even kernel), GELU, added to the projection;
- the encoder layers: post-LN (a LayerNorm before the first layer), or
  pre-LN with a LayerNorm after the last when ``do_stable_layer_norm``;
  attention with biases, softmax over all frames; a GELU MLP. ``wavlm``
  adds its relative position bias: ``num_buckets`` log buckets up to
  ``max_bucket_distance``, embedded per head by the first layer and shared
  by every layer, each layer gating it per query with its GRU-style gate
  (``gru_rel_pos_linear``, ``gru_rel_pos_const``).

Attention is plain torch (the JAX package has no Pallas kernel here: it
runs inside ``transformers``). Matmuls and convolutions run full fp32 (no
TF32) for the length of a forward. One unpadded waveform at a time, as the
JAX encoder feeds it, so no padding mask is needed.

``load_wav2vec_dir`` reads an HF directory (``config.json``,
``preprocessor_config.json``, safetensors; keys with or without the
task model's ``wav2vec2.`` / ``hubert.`` / ``wavlm.`` prefix);
``write_random_wav2vec_dir`` writes one at published widths from a seeded
``torch.Generator`` on the device. Any other ``model_type`` raises
``NotImplementedError``."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.safetensors_io import load_dir, read_config, save_file

Params = Dict[str, Any]

MODEL_TYPES = ("wav2vec2", "hubert", "wavlm")


@dataclass(frozen=True)
class Wav2VecArch:
    """The keys of an HF wav2vec2 / HuBERT / WavLM config the tower reads,
    at wavlm-base-plus's values."""
    model_type: str = "wavlm"
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"
    feat_proj_layer_norm: bool = True
    do_stable_layer_norm: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    num_buckets: int = 320
    max_bucket_distance: int = 800

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


WAVLM_BASE_PLUS = Wav2VecArch()
# hubert-large-ll60k's widths: 24 pre-LN layers of 1024, LayerNorm conv features with biases
HUBERT_LARGE = Wav2VecArch(model_type="hubert", hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                           intermediate_size=4096, conv_bias=True, feat_extract_norm="layer",
                           do_stable_layer_norm=True)

# the config keys that select a computation the tower does not run, with the value it runs
_RUNS = {"hidden_act": "gelu", "feat_extract_activation": "gelu", "add_adapter": False, "conv_pos_batch_norm": False}


def wav2vec_arch_from_config(cfg: Dict[str, Any]) -> Wav2VecArch:
    """An HF ``config.json`` (as a dict) -> ``Wav2VecArch`` (the HF
    defaults where it leaves a key out); another ``model_type``, or a key
    that selects what the tower does not run, raises
    ``NotImplementedError``."""
    mt = cfg.get("model_type")
    if mt not in MODEL_TYPES:
        raise NotImplementedError(f"audio encoder model_type {mt!r}: the port's wav2vec-class tower runs "
                                  f"{MODEL_TYPES} (ROADMAP.md, Queue 1 item 23)")
    off = {k: cfg[k] for k, v in _RUNS.items() if cfg.get(k, v) != v}
    if off:
        raise NotImplementedError(f"audio encoder config {off}: the port's tower runs {_RUNS} "
                                  "(ROADMAP.md, Queue 1 item 23)")
    fields = {f.name for f in dataclasses.fields(Wav2VecArch)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items() if k in fields}
    return Wav2VecArch(**kw)


# -- forward ------------------------------------------------------------------


@contextlib.contextmanager
def _full_fp32():
    """fp32 matmuls and convolutions without TF32, restored afterwards."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd


def _ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["w"], p["b"], eps)


def _lin(x, p):
    return F.linear(x, p["w"], p["b"])


def relative_position_buckets(length: int, num_buckets: int, max_distance: int, device) -> torch.Tensor:
    """(length, length) bucket of key j - query i: WavLM's bidirectional log
    buckets (HF ``WavLMAttention._relative_positions_bucket``)."""
    pos = torch.arange(length, dtype=torch.long, device=device)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    out = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    max_exact = half // 2
    large = torch.log(rel.float() / max_exact) / math.log(max_distance / max_exact) * (half - max_exact)
    large = torch.clamp((max_exact + large).to(torch.long), max=half - 1)
    return out + torch.where(rel < max_exact, rel, large)


def _attention(lp: Params, x: torch.Tensor, arch: Wav2VecArch, bias: Optional[torch.Tensor]) -> torch.Tensor:
    b, t, d = x.shape
    n, hd = arch.num_attention_heads, arch.head_dim
    q, k, v = (_lin(x, lp[m]).reshape(b, t, n, hd).transpose(1, 2) for m in ("q", "k", "v"))
    logits = q @ k.transpose(-1, -2) * hd ** -0.5
    if bias is not None:  # WavLM: the shared bias (n, t, t), gated per head and query by this layer's input
        gate = _lin(x.reshape(b, t, n, hd).transpose(1, 2), lp["gru"]).reshape(b, n, t, 2, 4).sum(-1).sigmoid()
        gate = gate[..., :1] * (gate[..., 1:] * lp["gru_const"] - 1.0) + 2.0
        logits = logits + gate * bias[None]
    out = torch.softmax(logits, dim=-1) @ v
    return _lin(out.transpose(1, 2).reshape(b, t, d), lp["o"])


def _ffn(lp: Params, x: torch.Tensor) -> torch.Tensor:
    return _lin(F.gelu(_lin(x, lp["ffn_in"])), lp["ffn_out"])


def wav2vec_forward(params: Params, wave: torch.Tensor, arch: Wav2VecArch) -> torch.Tensor:
    """wave (B, samples) fp32 -> last_hidden_state (B, frames, hidden) fp32,
    on the params' device."""
    eps = arch.layer_norm_eps
    with _full_fp32():
        x = wave.to(params["proj"]["w"].device, torch.float32)[:, None]
        for i, cp in enumerate(params["conv"]):
            x = F.conv1d(x, cp["w"], cp["b"], stride=arch.conv_stride[i])
            if arch.feat_extract_norm == "layer":
                x = _ln(x.transpose(1, 2), cp["norm"], 1e-5).transpose(1, 2)
            elif i == 0:
                x = F.group_norm(x, x.shape[1], cp["norm"]["w"], cp["norm"]["b"], 1e-5)
            x = F.gelu(x)
        x = x.transpose(1, 2)
        if params["proj_norm"] is not None:
            x = _ln(x, params["proj_norm"], eps)
        x = _lin(x, params["proj"])
        k = arch.num_conv_pos_embeddings
        pos = F.conv1d(x.transpose(1, 2), params["pos_conv"]["w"], params["pos_conv"]["b"], padding=k // 2,
                       groups=arch.num_conv_pos_embedding_groups)
        if k % 2 == 0:
            pos = pos[..., :-1]
        x = x + F.gelu(pos).transpose(1, 2)
        if not arch.do_stable_layer_norm:
            x = _ln(x, params["enc_norm"], eps)
        bias = None
        if arch.model_type == "wavlm":
            buckets = relative_position_buckets(x.shape[1], arch.num_buckets, arch.max_bucket_distance, x.device)
            bias = params["rel_embed"][buckets].permute(2, 0, 1)
        for lp in params["layers"]:
            if arch.do_stable_layer_norm:
                x = x + _attention(lp, _ln(x, lp["ln1"], eps), arch, bias)
                x = x + _ffn(lp, _ln(x, lp["ln2"], eps))
            else:
                x = _ln(x + _attention(lp, x, arch, bias), lp["ln1"], eps)
                x = _ln(x + _ffn(lp, x), lp["ln2"], eps)
        if arch.do_stable_layer_norm:
            x = _ln(x, params["enc_norm"], eps)
    return x


# -- weights ------------------------------------------------------------------


def _weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The conv weight of ``weight_norm(dim=2)``: v scaled per kernel tap to
    the norm g."""
    return v * (g / torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True))


def load_wav2vec_params(sd: Dict[str, torch.Tensor], arch: Wav2VecArch, device="cpu") -> Params:
    """An HF state dict (base-model keys) -> fp32 params on ``device``."""

    def t(key):
        return sd[key].to(device=device, dtype=torch.float32)

    def lin(key):
        return {"w": t(f"{key}.weight"), "b": t(f"{key}.bias") if f"{key}.bias" in sd else None}

    conv = []
    for i in range(len(arch.conv_dim)):
        p = f"feature_extractor.conv_layers.{i}"
        norm = arch.feat_extract_norm == "layer" or i == 0
        conv.append({**lin(f"{p}.conv"), "norm": lin(f"{p}.layer_norm") if norm else None})
    pc = "encoder.pos_conv_embed.conv"
    if f"{pc}.weight_g" in sd:
        g, v = t(f"{pc}.weight_g"), t(f"{pc}.weight_v")
    else:
        g, v = t(f"{pc}.parametrizations.weight.original0"), t(f"{pc}.parametrizations.weight.original1")
    has_proj_norm = arch.model_type != "hubert" or arch.feat_proj_layer_norm
    layers = []
    for i in range(arch.num_hidden_layers):
        p = f"encoder.layers.{i}"
        lp = {"q": lin(f"{p}.attention.q_proj"), "k": lin(f"{p}.attention.k_proj"),
              "v": lin(f"{p}.attention.v_proj"), "o": lin(f"{p}.attention.out_proj"),
              "ln1": lin(f"{p}.layer_norm"), "ffn_in": lin(f"{p}.feed_forward.intermediate_dense"),
              "ffn_out": lin(f"{p}.feed_forward.output_dense"), "ln2": lin(f"{p}.final_layer_norm")}
        if arch.model_type == "wavlm":
            lp.update(gru=lin(f"{p}.attention.gru_rel_pos_linear"), gru_const=t(f"{p}.attention.gru_rel_pos_const"))
        layers.append(lp)
    params = {"conv": conv, "proj_norm": lin("feature_projection.layer_norm") if has_proj_norm else None,
              "proj": lin("feature_projection.projection"), "pos_conv": {"w": _weight_norm(g, v), "b": t(f"{pc}.bias")},
              "enc_norm": lin("encoder.layer_norm"), "layers": layers}
    if arch.model_type == "wavlm":
        params["rel_embed"] = t("encoder.layers.0.attention.rel_attn_embed.weight")
    return params


_BASE_KEYS = ("feature_extractor.", "feature_projection.", "encoder.")


def load_wav2vec_dir(path: str, device="cpu") -> Tuple[Wav2VecArch, Params]:
    """An HF wav2vec2 / HuBERT / WavLM directory -> (arch, fp32 params on
    ``device``): the base model's tensors only (a task model's heads and its
    ``wav2vec2.`` / ``hubert.`` / ``wavlm.`` prefix dropped), each moved to
    the device as it is read."""
    arch = wav2vec_arch_from_config(read_config(path))
    prefix = arch.model_type + "."
    sd = load_dir(path, lambda k: k.removeprefix(prefix).startswith(_BASE_KEYS), device)
    sd = {k.removeprefix(prefix): v for k, v in sd.items()}
    return arch, load_wav2vec_params(sd, arch, device)


class Wav2VecModel:
    """An HF audio encoder directory on ``device``: ``normalize`` (its
    ``preprocessor_config.json``'s feature extractor) and ``__call__``
    (one waveform -> last_hidden_state (frames, hidden) fp32 numpy)."""

    def __init__(self, path: str, device="cuda"):
        pre = "preprocessor_config.json"
        self.preprocessor = read_config(path, pre) if os.path.exists(os.path.join(path, pre)) else {}
        if self.preprocessor.get("sampling_rate", 16000) != 16000:
            raise ValueError(f"{path}/{pre}: sampling_rate {self.preprocessor['sampling_rate']}; the audio encoder "
                             "feeds 16 kHz, as the JAX encoder does")
        self.arch, self.params = load_wav2vec_dir(path, resolve_device(device))

    def normalize(self, wav: np.ndarray) -> np.ndarray:
        """The feature extractor's arithmetic on one unpadded waveform: fp32,
        and zero mean, unit variance (eps 1e-7) when ``do_normalize``."""
        x = np.asarray(wav, np.float32)
        if self.preprocessor.get("do_normalize", True):
            x = (x - x.mean()) / np.sqrt(x.var() + 1e-7)
        return x

    def __call__(self, wav: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(self.normalize(wav)))[None]
        with torch.no_grad():
            return wav2vec_forward(self.params, x, self.arch)[0].cpu().numpy()


def init_random_wav2vec_state_dict_on_device(arch: Wav2VecArch, seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """A random HF base-model state dict (fp32, the pos conv in the
    ``parametrizations`` weight-norm layout) made on ``device`` from a seeded
    ``torch.Generator``: normal * 0.02 weights and biases (the feature
    encoder's convs at unit gain over their fan-in), unit norms, unit gate
    constants."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd: Dict[str, torch.Tensor] = {}

    def nrm(*shape, scale=0.02):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).mul_(scale)

    def lin(key, i, o, bias=True):
        sd[f"{key}.weight"] = nrm(o, i)
        if bias:
            sd[f"{key}.bias"] = nrm(o)

    def norm(key, c):
        sd[f"{key}.weight"] = torch.ones(c, device=dev)
        sd[f"{key}.bias"] = torch.zeros(c, device=dev)

    d, c_in = arch.hidden_size, 1
    for i, (c, k) in enumerate(zip(arch.conv_dim, arch.conv_kernel)):
        p = f"feature_extractor.conv_layers.{i}"
        sd[f"{p}.conv.weight"] = nrm(c, c_in, k, scale=1 / math.sqrt(c_in * k))
        if arch.conv_bias:
            sd[f"{p}.conv.bias"] = nrm(c)
        if arch.feat_extract_norm == "layer" or i == 0:
            norm(f"{p}.layer_norm", c)
        c_in = c
    if arch.model_type != "hubert" or arch.feat_proj_layer_norm:
        norm("feature_projection.layer_norm", c_in)
    lin("feature_projection.projection", c_in, d)
    pc, k, grp = "encoder.pos_conv_embed.conv", arch.num_conv_pos_embeddings, arch.num_conv_pos_embedding_groups
    sd[f"{pc}.parametrizations.weight.original0"] = torch.ones((1, 1, k), device=dev)
    sd[f"{pc}.parametrizations.weight.original1"] = nrm(d, d // grp, k)
    sd[f"{pc}.bias"] = nrm(d)
    norm("encoder.layer_norm", d)
    sd["masked_spec_embed"] = nrm(d)  # training-time masking only: written for a complete HF layout, never read
    for i in range(arch.num_hidden_layers):
        p = f"encoder.layers.{i}"
        for m in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{p}.attention.{m}", d, d)
        if arch.model_type == "wavlm":
            lin(f"{p}.attention.gru_rel_pos_linear", arch.head_dim, 8)
            sd[f"{p}.attention.gru_rel_pos_const"] = torch.ones((1, arch.num_attention_heads, 1, 1), device=dev)
            if i == 0:
                sd[f"{p}.attention.rel_attn_embed.weight"] = nrm(arch.num_buckets, arch.num_attention_heads)
        norm(f"{p}.layer_norm", d)
        lin(f"{p}.feed_forward.intermediate_dense", d, arch.intermediate_size)
        lin(f"{p}.feed_forward.output_dense", arch.intermediate_size, d)
        norm(f"{p}.final_layer_norm", d)
    return sd


def write_random_wav2vec_dir(path: str, arch: Wav2VecArch = WAVLM_BASE_PLUS, seed: int = 0,
                             device="cuda") -> Dict[str, torch.Tensor]:
    """Write an HF-layout directory at ``path`` (``config.json``,
    ``preprocessor_config.json`` with ``do_normalize`` on, as the published
    directories have it, ``model.safetensors``) from
    ``init_random_wav2vec_state_dict_on_device``; returns the state dict."""
    os.makedirs(path, exist_ok=True)
    sd = init_random_wav2vec_state_dict_on_device(arch, seed=seed, device=device)
    cfg = {k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(arch).items()}
    cfg.update(hidden_act="gelu", feat_extract_activation="gelu")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({"feature_extractor_type": "Wav2Vec2FeatureExtractor", "feature_size": 1, "sampling_rate": 16000,
                   "padding_value": 0.0, "padding_side": "right", "do_normalize": True,
                   "return_attention_mask": True}, f, indent=1)
    save_file(sd, os.path.join(path, "model.safetensors"))
    return sd
