"""Audio adapter: per-block Perceiver cross-attention injection (counterpart
of ``lightx2v_tpu.models.wan.audio_adapter``).

Audio features (1024-d a video frame) are projected to token groups per
latent frame (``audio_projection``: neighbour stacking, an MLP, frame 0
repeated 4 times, a LayerNorm), and every ``interval``-th DiT block adds a
gated cross-attention from the video tokens of each latent frame to that
frame's audio tokens (``perceiver_ca``), with an AdaLN shift / scale / gate
from the timestep (``audio_time_embedding``) or zeros. Plain torch, as the
JAX package runs it in XLA einsums (no Pallas kernel): bf16 operands, fp32
sums and logits, bf16 probabilities.

The adapter keeps the weight dtypes that the JAX synthesizer and loader
give it: fp32 weights, so its projections are fp32 GEMMs of bf16-rounded
inputs. Params: ``ca_blocks`` (a list, one dict per injection),
``proj``, ``interval``, ``num_tokens``, ``heads`` and, from a checkpoint
that has one, ``time_embedding``. ``adapter_from_tree`` carries the JAX
package's pytree (``init_random_audio_adapter`` / ``load_audio_adapter``
there, stacked ``ca_blocks``) across."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.norms import layer_norm
from .weights import to_tensor

Params = Dict[str, Any]
KV_DIM = 768  # audio token width of the reference adapter


def _dot(x: torch.Tensor, p: Params) -> torch.Tensor:
    """bf16 x times the (out, in) weight in its own dtype, fp32 sums and
    result, plus the bias."""
    return torch.matmul(x.to(torch.bfloat16).float(), p["w"].float().t()) + p["b"].float()


def perceiver_ca(p: Params, audio_tokens: torch.Tensor, latents: torch.Tensor, t_emb: torch.Tensor,
                 heads: int = 16) -> torch.Tensor:
    """audio_tokens (B, F, A, kv_dim) bf16; latents (B, F, T, D), the video
    tokens grouped per latent frame; t_emb (B, 3, D) -> delta (B, F, T, D)
    fp32."""
    b, f, a, _ = audio_tokens.shape
    t, d = latents.shape[2:]
    hd = d // heads
    kv = layer_norm(audio_tokens, p["norm_kv"]["w"], p["norm_kv"]["b"], eps=1e-5)
    ssg = t_emb.float() + p["shift_scale_gate"].float()
    shift, scale, gate = (ssg[:, i][:, None, None, :] for i in range(3))
    q_in = layer_norm(latents, p["norm_q"].get("w"), p["norm_q"].get("b"), eps=1e-5).float() * (1.0 + scale) + shift
    q = _dot(q_in, p["to_q"]).to(torch.bfloat16).reshape(b, f, t, heads, hd)
    del q_in
    k, v = _dot(kv, p["to_kv"]).to(torch.bfloat16).reshape(b, f, a, 2, heads, hd).unbind(3)
    logits = torch.einsum("bftnd,bfand->bfnta", q.float(), k.float()) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1).to(torch.bfloat16)
    out = torch.einsum("bfnta,bfand->bftnd", probs.float(), v.float()).to(torch.bfloat16).reshape(b, f, t, d)
    return _dot(out, p["to_out"]) * gate


def audio_time_embedding(p: Params, t: torch.Tensor, freq_dim: int = 256) -> torch.Tensor:
    """timestep (B,) -> (B, 3, D) fp32: [cos | sin] sinusoids ->
    linear / silu / linear -> silu -> time_proj."""
    half = freq_dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    lin = lambda q, x: x @ q["w"].float().t() + q["b"].float()  # noqa: E731
    h = lin(p["linear_2"], F.silu(lin(p["linear_1"], emb)))
    return lin(p["time_proj"], F.silu(h)).reshape(t.shape[0], 3, -1)


def audio_projection(p: Params, features: torch.Tensor, latent_frames: int, num_tokens: int = 32) -> torch.Tensor:
    """(B, T_video, feat_dim) frame-aligned features -> (B, latent_frames,
    4 * num_tokens, token_dim) bf16: 2 left / 2 right neighbours stacked,
    the MLP, video frames grouped 4 a latent frame (frame 0 repeated 4
    times), a LayerNorm and the learned ``audio_pe``."""
    b, tv, _ = features.shape
    padded = torch.cat([features[:, :1].expand(b, 2, -1), features, features[:, -1:].expand(b, 2, -1)], dim=1)
    h = torch.cat([padded[:, i:i + tv] for i in range(5)], dim=-1).to(torch.bfloat16)
    for i, layer in enumerate(p["mlp"]):
        h = _dot(h, layer)
        if i != len(p["mlp"]) - 1:
            h = torch.relu(h)
        h = h.to(torch.bfloat16)
    token_dim = h.shape[-1] // num_tokens
    h = h.reshape(b, tv, num_tokens, token_dim)
    groups = h[:, :1].repeat(1, 1, 4, 1)
    if latent_frames > 1:
        groups = torch.cat([groups, h[:, 1:].reshape(b, latent_frames - 1, 4 * num_tokens, token_dim)], dim=1)
    out = layer_norm(groups, p["norm"]["w"], p["norm"]["b"], eps=1e-5)
    if "audio_pe" in p:
        out = out + p["audio_pe"].to(out.dtype)
    return out.to(torch.bfloat16)


def _tensors(node, device):
    if isinstance(node, dict):
        return {k: _tensors(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tensors(v, device) for v in node]
    if isinstance(node, (int, float, str)):
        return node
    return to_tensor(np.asarray(node), None, device)


def adapter_from_tree(tree: Params, device="cpu") -> Params:
    """The JAX package's adapter pytree (numpy or JAX arrays; ``ca_blocks``
    stacked along a leading injection axis) -> the port's adapter on
    ``device``, dtypes kept."""
    out = _tensors({k: v for k, v in tree.items() if k != "ca_blocks"}, device)
    stacked = _tensors(tree["ca_blocks"], device)
    pick = lambda node, i: {k: pick(v, i) for k, v in node.items()} if isinstance(node, dict) else node[i]  # noqa
    out["ca_blocks"] = [pick(stacked, i) for i in range(stacked["to_q"]["w"].shape[0])]
    return out


def load_audio_adapter(sd: Dict[str, Any], interval: int = 1, heads: Optional[int] = None, device="cpu") -> Params:
    """A reference audio-adapter state dict (``audio_proj.mlp.{0,2,4}``,
    ``audio_proj.norm``, ``audio_pe``, ``ca.{i}.{norm_kv,to_q,to_kv,to_out,
    shift_scale_gate}``, ``time_embedding.{time_embedder.linear_1/2,
    time_proj}``; torch tensors or numpy) -> the adapter, fp32. The
    projection's transformer-decoder refiner keys are skipped, as in the JAX
    loader (MLP-only projection)."""

    def a(key):
        return to_tensor(sd[key], torch.float32, device)

    def lin(prefix):
        return {"w": a(f"{prefix}.weight"), "b": a(f"{prefix}.bias")}

    n_inject = 0
    while f"ca.{n_inject}.to_q.weight" in sd:
        n_inject += 1
    if not n_inject:
        raise ValueError("no ca.* blocks in the audio adapter state dict")
    ca = []
    for i in range(n_inject):
        blk = {"norm_kv": {"w": a(f"ca.{i}.norm_kv.weight"), "b": a(f"ca.{i}.norm_kv.bias")},
               "norm_q": {},  # the adaLN variant's norm_q has no affine params
               "to_q": lin(f"ca.{i}.to_q"), "to_kv": lin(f"ca.{i}.to_kv"), "to_out": lin(f"ca.{i}.to_out"),
               "shift_scale_gate": a(f"ca.{i}.shift_scale_gate").reshape(3, -1)}
        if f"ca.{i}.norm_q.weight" in sd:
            blk["norm_q"] = {"w": a(f"ca.{i}.norm_q.weight"), "b": a(f"ca.{i}.norm_q.bias")}
        ca.append(blk)
    dim = ca[0]["to_q"]["w"].shape[0]
    params: Params = {
        "ca_blocks": ca,
        "proj": {"mlp": [lin(f"audio_proj.mlp.{j}") for j in (0, 2, 4)],
                 "norm": {"w": a("audio_proj.norm.weight"), "b": a("audio_proj.norm.bias")}},
        "interval": interval,
        "heads": heads if heads is not None else dim // 128,
    }
    if "audio_pe" in sd:
        params["proj"]["audio_pe"] = a("audio_pe")
    params["num_tokens"] = params["proj"]["mlp"][-1]["w"].shape[0] // params["proj"]["norm"]["w"].shape[0]
    if "time_embedding.time_proj.weight" in sd:
        params["time_embedding"] = {"linear_1": lin("time_embedding.time_embedder.linear_1"),
                                    "linear_2": lin("time_embedding.time_embedder.linear_2"),
                                    "time_proj": lin("time_embedding.time_proj")}
    return params


def _synthetic(draw, dim: int, kv_dim: int, feat_dim: int, n_inject: int, interval: int, heads: int,
               num_tokens: int, zeros, ones) -> Params:
    """The synthetic adapter's layout, its matrices from ``draw(out, in)``
    in the JAX synthesizer's order."""

    def lin(i, o):
        return {"w": draw(o, i), "b": zeros(o)}

    ca = []
    for _ in range(n_inject):
        ssg = zeros(3, dim)
        ssg[2] = 1.0
        ca.append({"norm_kv": {"w": ones(kv_dim), "b": zeros(kv_dim)}, "norm_q": {"w": ones(dim), "b": zeros(dim)},
                   "to_q": lin(dim, dim), "to_kv": lin(kv_dim, 2 * dim), "to_out": lin(dim, dim),
                   "shift_scale_gate": ssg})
    return {"ca_blocks": ca,
            "proj": {"mlp": [lin(feat_dim * 5, 1024), lin(1024, 1024), lin(1024, num_tokens * kv_dim)],
                     "norm": {"w": ones(kv_dim), "b": zeros(kv_dim)}},
            "interval": interval, "num_tokens": num_tokens, "heads": heads}


def init_random_audio_adapter(dim: int = 1536, kv_dim: int = KV_DIM, feat_dim: int = 1024, num_layers: int = 30,
                              interval: int = 1, heads: int = 16, num_tokens: int = 4, seed: int = 0,
                              scale: float = 0.02, device="cpu") -> Params:
    """The JAX synthesizer's adapter, drawn from the same host numpy stream."""
    rng = np.random.default_rng(seed)
    tree = _synthetic(lambda *s: (rng.standard_normal(s) * scale).astype(np.float32), dim, kv_dim, feat_dim,
                      max(1, num_layers // interval), interval, heads, num_tokens,
                      lambda *s: np.zeros(s, np.float32), lambda *s: np.ones(s, np.float32))
    return _tensors(tree, device)


def init_random_audio_adapter_on_device(dim: int, kv_dim: int = KV_DIM, feat_dim: int = 1024, num_layers: int = 40,
                                        interval: int = 1, heads: int = 40, num_tokens: int = 4, seed: int = 0,
                                        scale: float = 0.02, device="cuda") -> Params:
    """The synthetic adapter's layout at a published width, drawn on the
    device from a seeded ``torch.Generator`` (fp32, as the host one)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return _synthetic(lambda *s: torch.randn(s, generator=g, device=device) * scale, dim, kv_dim, feat_dim,
                      max(1, num_layers // interval), interval, heads, num_tokens,
                      lambda *s: torch.zeros(s, device=device), lambda *s: torch.ones(s, device=device))


def adapter_bytes(adapter: Params) -> int:
    """Bytes of the adapter's tensors."""
    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        if isinstance(node, list):
            return sum(walk(v) for v in node)
        return node.numel() * node.element_size() if isinstance(node, torch.Tensor) else 0

    return walk(adapter)
