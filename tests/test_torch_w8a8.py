"""Port 8-bit GEMMs (plain versions of the CUDA kernels, which the CPU
wrappers run) vs the JAX Pallas kernels in interpret mode, same inputs, for
both kinds ("int8" and "fp8", the Pallas kernels' ``kind``).

Bars: both sides compute the same codes (int8: scale = max(absmax, 1e-8) *
(1/127), round half to even; fp8: * (1/448), e4m3 round to nearest even)
and then the same fp32 epilogue. The int8 sums are exact on both sides; the
e4m3 products are exact and the Pallas dot sums them in fp32 where the port
rounds the exact sum once, a difference far below a bf16 ulp. So outputs
agree to within a bf16 rounding flip: rtol 2^-7 (two bf16 ulps). The FFN
also requantizes its fp32 hidden, where the two tanh implementations can
differ by an ulp and flip a rare code by one step: a bar of 1e-2 of the
output's max."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lightx2v_tpu.ops.pallas.w8a8_matmul import ffn_w8a8 as jffn
from lightx2v_tpu.ops.pallas.w8a8_matmul import w8a8_matmul_fullk as jfullk
from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as tw

ULP2 = 2.0 ** -7
KINDS = ("int8", "fp8")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(rng, n, k, kind="int8"):
    """Per-channel codes (numpy: int8, or ml_dtypes float8_e4m3fn) and
    scales, as the JAX converter writes them."""
    wf = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    if kind == "fp8":
        ws = (np.maximum(np.abs(wf).max(axis=1), 1e-8) / 448.0).astype(np.float32)
        return (wf / ws[:, None]).astype(ml_dtypes.float8_e4m3fn), ws
    ws = (np.maximum(np.abs(wf).max(axis=1), 1e-8) / 127.0).astype(np.float32)
    return np.clip(np.round(wf / ws[:, None]), -127, 127).astype(np.int8), ws


def _tw(w):
    """numpy codes -> torch (e4m3 crosses as its bytes)."""
    if w.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(w.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(w)


def _x(rng, shape):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _jt(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lead,n,bias,act", [
    ((200,), 200, True, None),        # ragged M and N
    ((2, 100), 256, True, "gelu"),     # batched leading dims, fused gelu
    ((72,), 384, False, None),         # no bias
    ((33,), 136, False, "gelu"),
])
def test_fullk_matches_pallas(lead, n, bias, act, kind):
    rng = np.random.default_rng(sum(lead) + n)
    k = 256
    x = _x(rng, (*lead, k))
    w, ws = _w(rng, n, k, kind)
    b = rng.standard_normal(n).astype(np.float32) * 0.1 if bias else None
    jx, tx = _jt(x)
    ref = jfullk(jx, jnp.asarray(w), jnp.asarray(ws), None if b is None else jnp.asarray(b),
                 kind=kind, bm=64, bn=128, act=act, interpret=True)
    out = tw.w8a8_matmul_fullk(tx, _tw(w), torch.from_numpy(ws),
                               None if b is None else torch.from_numpy(b), act=act, kind=kind)
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


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,k,h,n,bh", [(96, 256, 384, 256, 128), (16, 128, 8960, 128, 256)])
def test_ffn_matches_pallas(m, k, h, n, bh, kind):
    """ffn_w8a8 at H=384 (bh=128) and at H=8960, where bh falls back from
    512 to 256."""
    assert tw.pick_bh(h) == bh
    rng = np.random.default_rng(h)
    x = _x(rng, (m, k))
    w0, s0 = _w(rng, h, k, kind)
    w2, s2 = _w(rng, n, h, kind)
    b0 = rng.standard_normal(h).astype(np.float32) * 0.1
    b2 = rng.standard_normal(n).astype(np.float32) * 0.1
    jx, tx = _jt(x)
    ref = np.asarray(jffn(jx, jnp.asarray(w0), jnp.asarray(s0), jnp.asarray(b0), jnp.asarray(w2),
                          jnp.asarray(s2), jnp.asarray(b2), kind=kind, bm=128, interpret=True), np.float32)
    t = lambda a: _tw(a)  # noqa: E731
    out = tw.ffn_w8a8(tx, t(w0), t(s0), t(b0), t(w2), t(s2), t(b2), kind=kind).float().numpy()
    assert out.shape == (m, n)
    np.testing.assert_allclose(out, ref, rtol=ULP2, atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("kind", KINDS)
def test_ffn_batched_no_bias(kind):
    rng = np.random.default_rng(7)
    x = _x(rng, (2, 33, 256))
    w0, s0 = _w(rng, 384, 256, kind)
    w2, s2 = _w(rng, 128, 384, kind)
    jx, tx = _jt(x)
    ref = np.asarray(jffn(jx, jnp.asarray(w0), jnp.asarray(s0), None, jnp.asarray(w2), jnp.asarray(s2), None,
                          kind=kind, bm=128, interpret=True), np.float32)
    t = lambda a: _tw(a)  # noqa: E731
    out = tw.ffn_w8a8(tx, t(w0), t(s0), None, t(w2), t(s2), None, kind=kind).float().numpy()
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


@pytest.mark.parametrize("m,n,k,bias", [(40, 256, 3072, True), (24, 128, 2560, False)])
def test_kblocked_fp8_matches_pallas(m, n, k, bias):
    """The k-blocked kernel's fp8 kind: per-(token, k-block) e4m3 scales,
    bk 1024 at K=3072 and 512 at K=2560 (the int8 kind is held the same way
    in test_torch_w4a8.py)."""
    from lightx2v_tpu.ops.pallas.w8a8_matmul import w8a8_matmul as jkb

    rng = np.random.default_rng(k + 1)
    x = _x(rng, (m, k))
    w, ws = _w(rng, n, k, "fp8")
    b = rng.standard_normal(n).astype(np.float32) * 0.1 if bias else None
    jx, tx = _jt(x)
    ref = jkb(jx, jnp.asarray(w), jnp.asarray(ws), None if b is None else jnp.asarray(b), kind="fp8",
              bm=64, bn=128, bk=tw.pick_kblock(k), interpret=True)
    out = tw.w8a8_matmul(tx, _tw(w), torch.from_numpy(ws), None if b is None else torch.from_numpy(b), kind="fp8")
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=ULP2, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k,blocked", [(5120, False), (13824, True)])
def test_one_signed_matches_pallas(k, blocked, kind):
    """One-signed x and positive codes, where every partial sum grows, at
    the main path's K: full-K at 5120, k-blocked at 13,824 (27 blocks of
    512, the FFN's second GEMM's grouping). The plain versions, which the
    card tests hold the kernels against on such inputs, agree with the
    Pallas kernels."""
    from lightx2v_tpu.ops.pallas.w8a8_matmul import w8a8_matmul as jkb

    rng = np.random.default_rng(k)
    m, n = 16, 128
    x = np.abs(_x(rng, (m, k)))
    wf = np.abs(rng.standard_normal((n, k)).astype(np.float32)) * 0.05
    qmax = 448.0 if kind == "fp8" else 127.0
    ws = (wf.max(axis=1) / qmax).astype(np.float32)
    w = (wf / ws[:, None]).astype(ml_dtypes.float8_e4m3fn) if kind == "fp8" else \
        np.clip(np.round(wf / ws[:, None]), 0, 127).astype(np.int8)
    jx, tx = _jt(x)
    if blocked:
        assert tw.pick_kblock(k) == 512
        ref = jkb(jx, jnp.asarray(w), jnp.asarray(ws), None, kind=kind, bm=16, bn=128, bk=512, interpret=True)
        out = tw.w8a8_matmul(tx, _tw(w), torch.from_numpy(ws), kind=kind)
    else:
        ref = jfullk(jx, jnp.asarray(w), jnp.asarray(ws), None, kind=kind, bm=16, bn=128, interpret=True)
        out = tw.w8a8_matmul_fullk(tx, _tw(w), torch.from_numpy(ws), kind=kind)
    ref = np.asarray(ref, np.float32)
    assert ref.min() > 0
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=ULP2, atol=1e-6)


def test_fp8_quantization_codes_match_pallas_contract():
    """Per-row e4m3 codes and scales: max(absmax, 1e-8) * (1/448), x / s
    rounded to nearest even (ml_dtypes' cast on the same fp32 values), an
    all-zero row and subnormal codes included."""
    x = np.array([[0.5, -1.0, 0.25, 2.0], [0.0, 0.0, 0.0, 0.0], [1.5, -0.001, 448.0, -3e-3],
                  [7.0, 0.013, -0.0071, 1.1e-3]], np.float32)
    q, s = tw.quantize_rows_plain(torch.from_numpy(x), "fp8")
    s_ref = np.maximum(np.abs(x).max(axis=1), 1e-8).astype(np.float32) * np.float32(1.0 / 448.0)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    codes = (x / s_ref[:, None]).astype(ml_dtypes.float8_e4m3fn)
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(), codes.view(np.uint8))
    assert (codes.view(np.uint8)[:, :] & 0x78 == 0).any()  # a subnormal code is among them


def test_exact_e4m3_dot():
    """The plain e4m3 dot is the exact sum rounded once: the smallest product
    (2^-9 squared) followed by 13,824 of the largest (448^2) that cancel,
    where an fp32 running sum ends at 0."""
    half = 6912
    q = torch.tensor([2.0 ** -9] + [448.0] * half + [-448.0] * half).to(torch.float8_e4m3fn)[None]
    w = torch.tensor([2.0 ** -9] + [448.0] * (2 * half)).to(torch.float8_e4m3fn)[None]
    assert tw.int_dot_exact(q, w).item() == 2.0 ** -18
    running = np.float32(0.0)
    for a, c in zip(q[0].float().numpy(), w[0].float().numpy()):
        running = np.float32(running + np.float32(a * c))
    assert running == 0.0


def test_wrapper_kinds_and_launch_keys():
    """kind defaults to int8, an unknown kind raises, and each kind has its
    own launch counter."""
    with pytest.raises(ValueError, match="kind"):
        tw.w8a8_matmul_fullk(torch.zeros((2, 32), dtype=torch.bfloat16), torch.zeros((4, 32), dtype=torch.int8),
                             torch.ones(4), kind="int4")
    assert {"w8a8_matmul_fullk_fp8", "w8a8_matmul_fp8", "ffn_w8a8_fp8", "w8a8_matmul_fullk"} <= set(tw.LAUNCHES)


def test_ffn_gemm1_refuses_misaligned_scale_and_bias():
    """The FFN's first GEMM reads w0's scale and b0 in pairs, so each must
    start at an 8-byte aligned address; a view that does not is refused
    before any launch."""
    buf = torch.zeros(66, dtype=torch.float32)
    tw._check_gemm1_vectors(buf[:64], buf[2:66])
    for scale, bias in ((buf[1:65], buf[:64]), (buf[:64], buf[1:65])):
        with pytest.raises(ValueError, match="8-byte aligned"):
            tw._check_gemm1_vectors(scale, bias)
