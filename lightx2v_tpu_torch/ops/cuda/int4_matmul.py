"""Weight-only int4 GEMM: CUDA kernel wrapper and its plain PyTorch version.

Port of ``lightx2v_tpu/ops/pallas/int4_matmul.py``: ``int4_matmul`` (kernel
source ``csrc/int4_matmul.cu``) and ``unpack_int4``. Weights are
nibble-packed as ``tools.convert.quantize_int4_weight`` writes them ((N, K/2) uint8;
within each group byte j holds column j in its low nibble and column
j + group/2 in its high nibble, both stored +8) with per-(channel, group)
fp32 scales; activations stay bf16. Per group the bf16 x bf16 product is
accumulated in fp32, multiplied by ``scale[n, g]`` and added into an fp32
sum, which is rounded to the activation dtype. An optional bias is added
after that rounding, in fp32, and the result rounded again, as the linear
layer around the TPU kernel does. On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version, which repeats
that arithmetic (the order of additions inside a group differs, so the
kernel is held to a tolerance).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

LAUNCHES = {"int4_matmul": 0}


def unpack_int4_values(packed: torch.Tensor, groups: int) -> torch.Tensor:
    """(N, K/2) uint8 nibbles -> (N, K) int8 values (nibble - 8)."""
    n, half = packed.shape
    pb = packed.reshape(n, groups, half // groups).to(torch.int16)
    return torch.cat([(pb & 15) - 8, (pb >> 4) - 8], dim=-1).reshape(n, 2 * half).to(torch.int8)


def unpack_int4(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequantize: (N, K/2) uint8 + (N, groups) scales -> (N, K) fp32."""
    n, half = packed.shape
    groups = scale.shape[1]
    q = unpack_int4_values(packed, groups).float().reshape(n, groups, -1)
    return (q * scale.float()[..., None]).reshape(n, 2 * half)


def int4_matmul_plain(x, packed, scale, bias=None) -> torch.Tensor:
    *lead, k = x.shape
    n, groups = packed.shape[0], scale.shape[1]
    group = k // groups
    x2 = x.reshape(-1, k).to(torch.bfloat16).float()
    w = unpack_int4_values(packed, groups).float()
    acc = torch.zeros((x2.shape[0], n), dtype=torch.float32, device=x.device)
    for g in range(groups):
        blk = slice(g * group, (g + 1) * group)
        acc = acc + torch.matmul(x2[:, blk], w[:, blk].t()) * scale[:, g].float()[None, :]
    y = acc.to(x.dtype)
    if bias is not None:
        y = (y.float() + bias.float()[None, :]).to(x.dtype)
    return y.reshape(*lead, n)


def _lib():
    lib = _build.load("int4_matmul")
    if lib.int4_gemm.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int4_gemm.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.int4_gemm.restype = ctypes.c_int
    return lib


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) bf16 @ int4-packed w (N, K/2) -> (..., N) bf16; the group
    size is K / scale.shape[1] and must be a multiple of 128 on the card."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale, bias)
    dev = x.device
    *lead, k = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if packed.device != dev or scale.device != dev:
        raise ValueError(f"w is on {packed.device}, expected {dev}")
    if packed.dtype != torch.uint8 or packed.dim() != 2 or 2 * packed.shape[1] != k or not packed.is_contiguous():
        raise ValueError(f"w must be contiguous uint8 (N, {k // 2}), got {packed.dtype} {tuple(packed.shape)}")
    n = packed.shape[0]
    if (scale.dtype != torch.float32 or scale.dim() != 2 or scale.shape[0] != n or k % scale.shape[1]
            or not scale.is_contiguous()):
        raise ValueError(f"scale must be contiguous fp32 ({n}, groups) with groups | {k}, "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    group = k // scale.shape[1]
    if group % 128 or n % 2:
        raise ValueError(f"int4_matmul needs a quant group that is a multiple of 128 and an even N, "
                         f"got group {group}, N {n}")
    bptr = None
    if bias is not None:
        if bias.device != dev or bias.shape != (n,):
            raise ValueError(f"bias must be ({n},) on {dev}")
        bias = bias.float().contiguous()
        bptr = bias.data_ptr()
    if packed.data_ptr() % 16:
        raise ValueError("w must start on a 16-byte boundary (the kernel loads it with TMA)")
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    out = torch.empty((x2.shape[0], n), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_lib().int4_gemm(x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), bptr, out.data_ptr(),
                                  x2.shape[0], n, k, group, stream), "int4_matmul")
    LAUNCHES["int4_matmul"] += 1
    return out.reshape(*lead, n)
