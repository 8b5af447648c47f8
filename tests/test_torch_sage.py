"""Port int8-QK attention (plain version of the CUDA kernel, which the CPU
wrapper runs) vs the JAX Pallas kernel in interpret mode, same inputs made
with numpy from a seed.

Bars: both sides quantize q and k per token row from the raw bf16 values
(codes and scales compared exactly below), form the same int32 logits and
scale them in the same fp32 order, run an exp2 softmax in fp32 and round P to
bf16 before P.V; they differ only in the running maxima at which P is rounded
(one pass vs 128-key tiles) and in summation order: 1e-2 absolute + 1e-2
relative on bf16 outputs, as for the flash kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.ops.pallas import sage_attention as jsage
from lightx2v_tpu_torch.ops.cuda import sage_attention as tsage

TOL = dict(rtol=1e-2, atol=1e-2)


def _qkv(b, sq, sk, n=2, d=128, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s: (rng.standard_normal((b, s, n, d)) * 1.5).astype(np.float32)  # noqa: E731
    return mk(sq), mk(sk), mk(sk)


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


@pytest.mark.parametrize("b,sq,sk,kv_len", [(1, 256, 256, None), (2, 200, 200, None), (1, 200, 200, 150),
                                            (1, 77, 333, None), (2, 130, 64, 40)])
def test_sage_attention_vs_pallas(b, sq, sk, kv_len):
    """Block multiples, ragged Sq/Sk (the kernel's zero pad rows), a static
    kv_len below Sk, and batch 2."""
    q, k, v = _qkv(b, sq, sk, seed=sq + sk)
    ref = jsage.sage_attention(_j(q), _j(k), _j(v), kv_len=kv_len, bq=128, bk=128, interpret=True)
    before = tsage.LAUNCHES["sage_attention"]
    out = tsage.sage_attention(_t(q), _t(k), _t(v), kv_len=kv_len)
    assert tsage.LAUNCHES["sage_attention"] == before  # the plain version is no launch
    assert out.shape == (b, sq, 2, 128) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_row_quantization_contract():
    """Codes and scales: sc = max(absmax, 1e-6) / 127 per row, codes
    clip(round(x / sc)) with round-half-even; an all-zero row keeps finite
    scale and zero codes."""
    x = _qkv(1, 64, 1, seed=3)[0]
    x[0, 5] = 0.0
    xb = _t(x)
    codes, sc = tsage.quant_rows_plain(xb)
    xf = xb.float().numpy()
    want_sc = np.maximum(np.abs(xf).max(-1, keepdims=True), 1e-6).astype(np.float32) * np.float32(1.0 / 127.0)
    np.testing.assert_array_equal(sc.numpy(), want_sc)
    np.testing.assert_array_equal(codes.numpy(), np.clip(np.round(xf / want_sc), -127, 127).astype(np.int8))
    assert codes.dtype == torch.int8 and int(codes.abs().max()) == 127
    assert not codes[0, 5].any() and float(sc[0, 5].max()) == np.float32(1e-6) * np.float32(1.0 / 127.0)


def test_sage_close_to_dense_attention():
    """Int8 QK changes the logits by quantization noise only (a relative
    1/254 per code): relative L2 below 3e-2 of dense softmax attention."""
    from lightx2v_tpu_torch.ops.attention import attention, attn_plain

    q, k, v = _qkv(1, 192, 192, seed=5)
    out = _np(attention("sage_attn2", _t(q), _t(k), _t(v)))
    ref = _np(attn_plain(_t(q), _t(k), _t(v)))
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 3e-2


def test_sage_applies_rope_first():
    """A non-flash type under rope tables rotates q and k up front."""
    from lightx2v_tpu_torch.ops.attention import attention
    from lightx2v_tpu_torch.ops.rope import apply_rope_half, build_wan_rope_grid

    q, k, v = (_t(a) for a in _qkv(1, 147, 147, seed=6))
    cos, sin = (torch.from_numpy(a) for a in build_wan_rope_grid(128, 3, 7, 7))
    out = attention("sage_attn2", q, k, v, rope_cos=cos, rope_sin=sin)
    ref = tsage.sage_attention_plain(apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v)
    assert torch.equal(out, ref)
