"""TaylorSeer caching (counterpart of ``lightx2v_tpu.caching.taylorseer``).

A fixed pattern computes one step in four. A calc step runs every block and
caches each block's self-attention, cross-attention and FFN outputs with
their finite-difference derivatives; a skip step rebuilds each module's
output with the first-order Taylor formula f0 + f1 * dt and applies only the
modulation gates. The per-module cache is 6 * L * B * S * D values (36.2 GB
in bf16 at Wan2.1-1.3B with CFG at 480P; 161 GB at 14B, over one 80 GB
card), updated in place layer by layer.

TaylorWS is the whole-stack variant: one (B, S, D) f0/f1 pair for the
transformer's residual.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..models.wan.config import WanArch
from ..models.wan.model import _split_modulation, wan_block_parts
from ..ops.linear import resolve_mm
from .teacache import store

MODULES = ("self_attn", "cross_attn", "ffn")


def taylor_schedule(n_steps: int, pattern: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """(is_calc (n,), step_diff (n,)): calc every ``pattern`` steps;
    step_diff is the distance from the previous calc step (1 at step 0)."""
    is_calc = np.array([i % pattern == 0 for i in range(n_steps)])
    step_diff = np.zeros(n_steps, np.float32)
    last_calc = 0
    for i in range(n_steps):
        step_diff[i] = (i - last_calc if i > 0 else 1.0) if is_calc[i] else i - last_calc
        if is_calc[i]:
            last_calc = i
    return is_calc, step_diff


def taylor_cache_bytes(arch: WanArch, batch: int, seq_len: int, dtype=torch.bfloat16) -> int:
    return 2 * len(MODULES) * arch.num_layers * batch * seq_len * arch.dim * torch.empty((), dtype=dtype).element_size()


def init_taylor_cache(arch: WanArch, batch: int, seq_len: int, dtype=torch.bfloat16, device="cpu") -> Dict:
    shape = (arch.num_layers, batch, seq_len, arch.dim)
    return {name: {"f0": torch.zeros(shape, dtype=dtype, device=device),
                   "f1": torch.zeros(shape, dtype=dtype, device=device)} for name in MODULES}


def taylor_calc_step(params, x, embed0, ctx, ctx_img, rope_cos, rope_sin, arch: WanArch, cache: Dict,
                     step_diff: float, mm_type: str = "Default", self_attn_fn=None, cross_attn_fn=None,
                     primed: bool = True, block_parts=wan_block_parts):
    """Run every block, writing each module's output (f0) and its derivative
    against the previous calc step's output (f1, in fp32 before the store)
    into ``cache`` in place, layer by layer. ``primed=False`` (the first calc
    step) stores f1 = 0: a derivative against the zero cache would double
    the residual on the first skip. ``block_parts``: ``wan_block_parts`` or
    a sharded form of it (``ShardedTransformer.block_parts``)."""
    mm_fn = resolve_mm(mm_type)
    for li, block in enumerate(params["blocks"]):
        x, y_self, y_cross, y_ffn = block_parts(block, x, embed0, ctx, ctx_img, rope_cos, rope_sin, arch,
                                                mm_fn, self_attn_fn, cross_attn_fn)
        for name, y in zip(MODULES, (y_self, y_cross, y_ffn)):
            f0, f1 = cache[name]["f0"], cache[name]["f1"]
            if primed:
                f1[li] = store((y.float() - f0[li].float()) / step_diff, f1.dtype)
            else:
                f1[li].zero_()
            f0[li] = store(y, f0.dtype)
    return x, cache


def taylor_skip_step(params, x, embed0, arch: WanArch, cache: Dict, x_diff: float):
    """x += taylor(self) * gate + taylor(cross) + taylor(ffn) * c_gate per
    block, summed in fp32 and cast back to x's dtype after each block."""

    def taylor(name, li):
        c = cache[name]
        return c["f0"][li].float() + c["f1"][li].float() * x_diff

    for li, block in enumerate(params["blocks"]):
        _, _, gate, _, _, c_gate = _split_modulation(block, embed0)
        xc = x.float() + taylor("self_attn", li) * gate
        xc = xc + taylor("cross_attn", li)
        xc = xc + taylor("ffn", li) * c_gate
        x = xc.to(x.dtype)
    return x


def init_taylor_ws_cache(batch: int, seq_len: int, dim: int, dtype=torch.bfloat16, device="cpu") -> Dict:
    z = lambda: torch.zeros((batch, seq_len, dim), dtype=dtype, device=device)  # noqa: E731
    return {"f0": z(), "f1": z(), "last_calc": 0}


def taylor_ws_calc(transformer_fn, x: torch.Tensor, cache: Dict, step_index: int):
    """Run the stack; store its residual and the first-order derivative
    (f1 = 0 at step 0). The chain runs in bf16 unless the cache is fp32."""
    x_out = transformer_fn(x)
    mdt = torch.float32 if cache["f0"].dtype == torch.float32 else torch.bfloat16
    r = (x_out - x).to(mdt)
    if step_index > 0:
        f1 = (r - cache["f0"].to(mdt)) / max(step_index - cache["last_calc"], 1)
    else:
        f1 = torch.zeros_like(r)
    return x_out, {"f0": store(r, cache["f0"].dtype), "f1": store(f1, cache["f1"].dtype), "last_calc": step_index}


def taylor_ws_skip(x: torch.Tensor, cache: Dict, step_index: int) -> torch.Tensor:
    """x + f0 + f1 * (i - last_calc), added in fp32."""
    rec = cache["f0"].float() + cache["f1"].float() * float(step_index - cache["last_calc"])
    return (x.float() + rec).to(x.dtype)
