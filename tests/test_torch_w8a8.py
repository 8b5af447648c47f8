"""Port int8 GEMMs (plain versions of the CUDA kernels, which the CPU
wrappers run) vs the JAX Pallas kernels in interpret mode, same inputs.

Bars: both sides compute the same int8 codes (scale = max(absmax, 1e-8) *
(1/127), round half to even) and the exact int32 sums, then the same fp32
epilogue, so outputs agree to within a bf16 rounding flip: rtol 2^-7 (two
bf16 ulps). The FFN also requantizes its fp32 hidden, where the two tanh
implementations can differ by an ulp and flip a rare code by one step: a
bar of 1e-2 of the output's max."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.ops.pallas.w8a8_matmul import ffn_w8a8 as jffn
from lightx2v_tpu.ops.pallas.w8a8_matmul import w8a8_matmul_fullk as jfullk
from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as tw

ULP2 = 2.0 ** -7


def _w(rng, n, k):
    wf = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    ws = (np.maximum(np.abs(wf).max(axis=1), 1e-8) / 127.0).astype(np.float32)
    return np.clip(np.round(wf / ws[:, None]), -127, 127).astype(np.int8), ws


def _x(rng, shape):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _jt(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("lead,n,bias,act", [
    ((200,), 200, True, None),        # ragged M and N
    ((2, 100), 256, True, "gelu"),     # batched leading dims, fused gelu
    ((72,), 384, False, None),         # no bias
    ((33,), 136, False, "gelu"),
])
def test_fullk_matches_pallas(lead, n, bias, act):
    rng = np.random.default_rng(sum(lead) + n)
    k = 256
    x = _x(rng, (*lead, k))
    w, ws = _w(rng, n, k)
    b = rng.standard_normal(n).astype(np.float32) * 0.1 if bias else None
    jx, tx = _jt(x)
    ref = jfullk(jx, jnp.asarray(w), jnp.asarray(ws), None if b is None else jnp.asarray(b),
                 bm=64, bn=128, act=act, interpret=True)
    out = tw.w8a8_matmul_fullk(tx, torch.from_numpy(w), torch.from_numpy(ws),
                               None if b is None else torch.from_numpy(b), act=act)
    assert out.shape == (*lead, n) and out.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=ULP2, atol=1e-6)


def test_quantization_codes_match_pallas_contract():
    """Per-row codes and scales: max(absmax, 1e-8) * (1/127), round half
    to even, clip at +-127 (exact, incl. an all-zero row)."""
    x = np.array([[0.5, -1.0, 0.25, 2.0], [0.0, 0.0, 0.0, 0.0], [1.5, -0.5, 127.0, -127.0]], np.float32)
    q, s = tw.quantize_rows_plain(torch.from_numpy(x))
    absmax = np.maximum(np.abs(x).max(axis=1), 1e-8).astype(np.float32)
    s_ref = absmax * np.float32(1.0 / 127.0)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    np.testing.assert_array_equal(q.numpy(), np.clip(np.round(x / s_ref[:, None]), -127, 127).astype(np.int8))


@pytest.mark.parametrize("m,k,h,n,bh", [(96, 256, 384, 256, 128), (16, 128, 8960, 128, 256)])
def test_ffn_matches_pallas(m, k, h, n, bh):
    """ffn_w8a8 at H=384 (bh=128) and at H=8960, where bh falls back from
    512 to 256."""
    assert tw.pick_bh(h) == bh
    rng = np.random.default_rng(h)
    x = _x(rng, (m, k))
    w0, s0 = _w(rng, h, k)
    w2, s2 = _w(rng, n, h)
    b0 = rng.standard_normal(h).astype(np.float32) * 0.1
    b2 = rng.standard_normal(n).astype(np.float32) * 0.1
    jx, tx = _jt(x)
    ref = np.asarray(jffn(jx, jnp.asarray(w0), jnp.asarray(s0), jnp.asarray(b0), jnp.asarray(w2),
                          jnp.asarray(s2), jnp.asarray(b2), bm=128, interpret=True), np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    out = tw.ffn_w8a8(tx, t(w0), t(s0), t(b0), t(w2), t(s2), t(b2)).float().numpy()
    assert out.shape == (m, n)
    np.testing.assert_allclose(out, ref, rtol=ULP2, atol=1e-2 * np.abs(ref).max())


def test_ffn_batched_no_bias():
    rng = np.random.default_rng(7)
    x = _x(rng, (2, 33, 256))
    w0, s0 = _w(rng, 384, 256)
    w2, s2 = _w(rng, 128, 384)
    jx, tx = _jt(x)
    ref = np.asarray(jffn(jx, jnp.asarray(w0), jnp.asarray(s0), None, jnp.asarray(w2), jnp.asarray(s2), None,
                          bm=128, interpret=True), np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    out = tw.ffn_w8a8(tx, t(w0), t(s0), None, t(w2), t(s2), None).float().numpy()
    assert out.shape == (2, 33, 128)
    np.testing.assert_allclose(out, ref, rtol=ULP2, atol=1e-2 * np.abs(ref).max())


def test_exact_int_dot_past_fp32_integers():
    """The plain int dot is exact where an fp32 accumulation is not
    (5120 * 127^2 > 2^24)."""
    q = torch.full((1, 5120), 127, dtype=torch.int8)
    w = torch.full((1, 5120), 127, dtype=torch.int8)
    w[0, 0] = 126
    exact = 5119 * 127 * 127 + 127 * 126
    assert tw.int_dot_exact(q, w).item() == np.float32(exact)
