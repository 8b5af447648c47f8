"""Tensor parallelism for the Wan DiT block (counterpart of
``lightx2v_tpu.parallel.tensor_parallel``): the attention heads and the FFN
hidden dim shard over ``tp`` (the Megatron column / row pattern). q, k, v,
``ffn.0`` and i2v's ``k_img`` / ``v_img`` keep 1 / tp of their outputs; ``o``
and ``ffn.2`` keep 1 / tp of their inputs and finish with an all-reduce over
tp, the bias added once after it. The QK RMSNorm spans the full projection,
so its sum of squares is all-reduced too. Combines with ``sp`` (Ulysses or
ring on the local heads) and ``dp``.

``tp_shard_block`` slices one rank's shard out of a block once, at load, as
the JAX package's ``tp_block_specs`` (``:32-54``) and ``_expand_quant_specs``
(``models/wan/sharded.py:164-194``) shard the stacked leaves: a per-channel
``w_scale`` follows its weight's output dim; a group scale (out, nk) follows
the output dim, and on a row-parallel linear splits its groups only where tp
divides nk (else every shard keeps all of them).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.wan.config import WanArch
from ..models.wan.model import _gated_add, _norm, _split_modulation
from ..ops.linear import mm_gelu
from ..ops.norms import layer_norm
from ..ops.rope import apply_rope
from .mesh import Mesh, all_reduce_sum, mesh_axis_size

Params = Dict[str, Any]

COL = ("q", "k", "v", "k_img", "v_img")  # attention linears sharded on their outputs
ROW = ("o",)
NORMS = ("norm_q", "norm_k", "norm_k_img")  # QK-norm scales follow the outputs


def _part(t: torch.Tensor, dim: int, tp: int, i: int) -> torch.Tensor:
    c = t.shape[dim] // tp
    if t.shape[dim] % tp:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide tp = {tp}")
    return t.narrow(dim, i * c, c).contiguous()


def _shard_linear(lin: Params, kind: str, tp: int, i: int) -> Params:
    """``kind`` "col" splits the output dim (rows of w, the bias, the
    scale's first dim); "row" splits the input dim (w's last dim, and a group
    scale's groups where tp divides them)."""
    out = dict(lin)
    w = lin["w"]
    if kind == "col":
        out["w"] = _part(w, 0, tp, i)
        if lin.get("b") is not None:
            out["b"] = _part(lin["b"], 0, tp, i)
        if lin.get("w_scale") is not None and lin["w_scale"].ndim >= 1 and lin["w_scale"].shape[0] == w.shape[0]:
            out["w_scale"] = _part(lin["w_scale"], 0, tp, i)
    else:
        out["w"] = _part(w, w.ndim - 1, tp, i)
        ws = lin.get("w_scale")
        if ws is not None and ws.ndim == 2 and ws.shape[1] % tp == 0:
            out["w_scale"] = _part(ws, 1, tp, i)
    return out


def tp_shard_block(block: Params, tp: int, i: int) -> Params:
    """Rank ``i`` of ``tp``'s shard of one Wan block (any other leaf, the
    modulation, ``norm3`` and the smooth-quant affines, is kept whole)."""
    if tp == 1:
        return block
    out = dict(block)
    for name in ("self_attn", "cross_attn"):
        attn = dict(block[name])
        for key, val in block[name].items():
            if key in COL:
                attn[key] = _shard_linear(val, "col", tp, i)
            elif key in ROW:
                attn[key] = _shard_linear(val, "row", tp, i)
            elif key in NORMS:
                attn[key] = _part(val, 0, tp, i)
        out[name] = attn
    out["ffn"] = {"0": _shard_linear(block["ffn"]["0"], "col", tp, i),
                  "2": _shard_linear(block["ffn"]["2"], "row", tp, i)}
    return out


def _rms_tp(x: torch.Tensor, w: torch.Tensor, full_dim: int, mesh: Mesh, eps: float) -> torch.Tensor:
    """RMSNorm whose statistics span the full (tp-sharded) dim: the local
    sum of squares is all-reduced over tp before normalizing; fp32 inside,
    rounded to x's dtype."""
    xf = x.float()
    ssq = all_reduce_sum((xf * xf).sum(dim=-1, keepdim=True), mesh, "tp")
    return (xf * torch.rsqrt(ssq / full_dim + eps) * w.float()).to(x.dtype)


def _row_mm(p: Params, x: torch.Tensor, mm_fn, mesh: Mesh) -> torch.Tensor:
    """Row-parallel linear: the partial product, all-reduced, the bias
    added once after."""
    out = all_reduce_sum(mm_fn(dict(p, b=None), x), mesh, "tp")
    if p.get("b") is not None:
        out = out + p["b"].to(out.dtype)
    return out


def wan_block_tp(block: Params, x: torch.Tensor, embed0: torch.Tensor, context: torch.Tensor,
                 context_img: Optional[torch.Tensor], rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                 arch: WanArch, mm_fn, attn_fn, cross_attn_fn, mesh: Mesh, parts: bool = False):
    """``wan_block`` on this rank's shard (``tp_shard_block``) with the
    all-reduces of the row-parallel projections. ``arch.num_heads`` is the
    global head count; the local slice is num_heads / tp. ``attn_fn`` is the
    (possibly sequence-parallel) self-attention on the local heads;
    ``cross_attn_fn`` the dense one (the text K/V are replicated). With
    ``parts`` it returns ``wan_block_parts``' tuple (x and the three modules'
    full-width outputs)."""
    b, s, d = x.shape
    tp = mesh_axis_size(mesh, "tp")
    n_loc, hd = arch.num_heads // tp, arch.head_dim
    d_loc = n_loc * hd
    shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = _split_modulation(block, embed0)

    sa = block["self_attn"]
    norm1 = _norm(block, "smooth_norm1", x, shift_msa, scale_msa, arch.eps)
    q = _rms_tp(mm_fn(sa["q"], norm1), sa["norm_q"], d, mesh, arch.eps).reshape(b, s, n_loc, hd)
    k = _rms_tp(mm_fn(sa["k"], norm1), sa["norm_k"], d, mesh, arch.eps).reshape(b, s, n_loc, hd)
    v = mm_fn(sa["v"], norm1).reshape(b, s, n_loc, hd)
    del norm1
    if arch.rope_fused:  # q/k in the half-split layout: the rotation belongs to attn_fn
        attn_out = attn_fn(q, k, v, rope_cos=rope_cos, rope_sin=rope_sin).reshape(b, s, d_loc)
    else:
        attn_out = attn_fn(apply_rope(q, rope_cos, rope_sin), apply_rope(k, rope_cos, rope_sin),
                           v).reshape(b, s, d_loc)
    del q, k, v
    y_sa = _row_mm(sa["o"], attn_out, mm_fn, mesh)
    x = _gated_add(x, y_sa, gate_msa)

    ca = block["cross_attn"]
    norm3 = layer_norm(x, block["norm3"]["w"], block["norm3"]["b"], eps=arch.eps)
    cq = _rms_tp(mm_fn(ca["q"], norm3), ca["norm_q"], d, mesh, arch.eps).reshape(b, s, n_loc, hd)
    ck = _rms_tp(mm_fn(ca["k"], context), ca["norm_k"], d, mesh, arch.eps).reshape(b, -1, n_loc, hd)
    cv = mm_fn(ca["v"], context).reshape(b, -1, n_loc, hd)
    cross_out = cross_attn_fn(cq, ck, cv).reshape(b, s, d_loc)
    if context_img is not None and "k_img" in ca:
        ik = _rms_tp(mm_fn(ca["k_img"], context_img), ca["norm_k_img"], d, mesh, arch.eps).reshape(b, -1, n_loc, hd)
        iv = mm_fn(ca["v_img"], context_img).reshape(b, -1, n_loc, hd)
        cross_out = cross_out + cross_attn_fn(cq, ik, iv).reshape(b, s, d_loc)
    cross_proj = _row_mm(ca["o"], cross_out, mm_fn, mesh)
    x = x + cross_proj

    norm2 = _norm(block, "smooth_norm2", x, c_shift, c_scale, arch.eps)
    y_ffn = _row_mm(block["ffn"]["2"], mm_gelu(mm_fn, block["ffn"]["0"], norm2), mm_fn, mesh)
    x = _gated_add(x, y_ffn, c_gate)
    return (x, y_sa, cross_proj, y_ffn) if parts else x
