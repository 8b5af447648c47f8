"""Port int4 x int8 GEMMs and the k-blocked int8 GEMM (plain versions of the
CUDA kernels, which the CPU wrappers run) vs the JAX Pallas kernels in
interpret mode, same inputs; and the port's int4 quantizer and weight
loading vs the JAX package.

Bars: both sides compute the same int8 activation codes per (token, group)
(scale = max(absmax, 1e-8) * (1/127), round half to even), the same exact
int32 partial per group, and add ``partial * xs * ws`` into fp32 in the same
order, so the GEMM outputs agree to a bf16 rounding flip: rtol 2^-7. The
FFN also requantizes its fp32 hidden, where the two tanh implementations
can differ by an ulp and flip a rare code by one step: 1e-2 of the output's
max."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.ops.pallas import int4_matmul as jint4
from lightx2v_tpu.ops.pallas import w8a8_matmul as jw
from lightx2v_tpu_torch.ops.cuda import w4a8_matmul as t4
from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as t8
from lightx2v_tpu_torch.tools import convert as tconvert

ULP2 = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(rng, shape):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _jt(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _int4(rng, n, k, bk=None):
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    packed, scale = tconvert.quantize_int4_weight(torch.from_numpy(w), bk)
    return packed.numpy(), scale.numpy()


@pytest.mark.parametrize("n,k,bk", [(64, 5120, None), (40, 384, None), (8, 200, None), (16, 1024, 256)])
def test_quantize_int4_bit_exact(n, k, bk):
    """Same packed bytes and scales as the JAX package (groups 512, 128,
    one per row for K=200, and a forced 256)."""
    w = np.random.default_rng(k).standard_normal((n, k)).astype(np.float32) * 0.05
    jp, js = jint4.quantize_int4(w, bk)
    tp, ts = (t.numpy() for t in tconvert.quantize_int4_weight(torch.from_numpy(w), bk))
    assert tp.dtype == np.uint8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)
    assert tconvert._pick_bk(k) == jint4._pick_bk(k)
    np.testing.assert_array_equal(t4.unpack_int4_plain(torch.from_numpy(tp), ts.shape[1]).numpy(),
                                  np.round(np.asarray(jint4.unpack_int4(jnp.asarray(jp), jnp.asarray(js)))
                                           / np.repeat(js, tp.shape[1] * 2 // ts.shape[1], axis=1)))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("lead,n,k,bias", [
    ((200,), 256, 1024, True),     # ragged M, two groups of 512
    ((2, 36), 136, 384, False),    # batched, three groups of 128, N not a tile multiple
])
def test_w4a8_matches_pallas(monkeypatch, blocked, lead, n, k, bias):
    """One plain version against both Pallas forms (full-K and k-blocked):
    they compute the same function."""
    if blocked:
        monkeypatch.setenv("LIGHTX2V_W4A8_BLOCKED", "1")
    rng = np.random.default_rng(n + k)
    x = _x(rng, (*lead, k))
    wp, ws = _int4(rng, n, k)
    b = rng.standard_normal(n).astype(np.float32) * 0.1 if bias else None
    jx, tx = _jt(x)
    ref = jw.w4a8_matmul(jx, jnp.asarray(wp), jnp.asarray(ws), None if b is None else jnp.asarray(b),
                         bm=64, bn=128, interpret=True)
    out = t4.w4a8_matmul(tx, torch.from_numpy(wp), torch.from_numpy(ws), None if b is None else torch.from_numpy(b))
    assert out.shape == (*lead, n) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=ULP2, atol=1e-6)


@pytest.mark.parametrize("m,k,h,n", [(96, 1024, 1536, 256), (40, 512, 768, 128)])
def test_ffn_w4a8_matches_pallas(m, k, h, n):
    """bh = w2's quant group: 512 at H=1536 (three hidden groups), 256 at
    H=768."""
    rng = np.random.default_rng(h)
    x = _x(rng, (m, k))
    w0, s0 = _int4(rng, h, k)
    w2, s2 = _int4(rng, n, h)
    b0 = rng.standard_normal(h).astype(np.float32) * 0.1
    b2 = rng.standard_normal(n).astype(np.float32) * 0.1
    jx, tx = _jt(x)
    ref = np.asarray(jw.ffn_w4a8(jx, jnp.asarray(w0), jnp.asarray(s0), jnp.asarray(b0), jnp.asarray(w2),
                                 jnp.asarray(s2), jnp.asarray(b2), bm=64, interpret=True), np.float32)
    t = torch.from_numpy
    out = t4.ffn_w4a8(tx, t(w0), t(s0), t(b0), t(w2), t(s2), t(b2)).float().numpy()
    assert out.shape == (m, n)
    np.testing.assert_allclose(out, ref, rtol=ULP2, atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("m,n,k,bias", [(40, 256, 3072, True), (24, 128, 2560, False)])
def test_kblocked_w8a8_matches_pallas(m, n, k, bias):
    """Per-(token, k-block) activation scales: bk 1024 at K=3072, 512 at
    K=2560 (the largest power of two <= 1024 dividing K)."""
    rng = np.random.default_rng(k)
    x = _x(rng, (m, k))
    wf = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    ws = (np.maximum(np.abs(wf).max(axis=1), 1e-8) / 127.0).astype(np.float32)
    w = np.clip(np.round(wf / ws[:, None]), -127, 127).astype(np.int8)
    b = rng.standard_normal(n).astype(np.float32) * 0.1 if bias else None
    bk = t8.pick_kblock(k)
    assert bk == (1024 if k == 3072 else 512)
    jx, tx = _jt(x)
    ref = jw.w8a8_matmul(jx, jnp.asarray(w), jnp.asarray(ws), None if b is None else jnp.asarray(b),
                         bm=64, bn=128, bk=bk, interpret=True)
    out = t8.w8a8_matmul(tx, torch.from_numpy(w), torch.from_numpy(ws), None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=ULP2, atol=1e-6)


def test_int8_linear_routes_long_k_to_kblocked(monkeypatch):
    """The int8 linear at the UMT5-XXL fc2 shape (K = 10,240 > 8192) takes
    the k-blocked GEMM, whose per-(token, 1024-block) scales differ from a
    per-token quantization."""
    from lightx2v_tpu_torch.ops import linear

    calls = []
    real = linear.w8a8_matmul
    monkeypatch.setattr(linear, "w8a8_matmul", lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_x(rng, (8, 10240))).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-127, 128, (4096, 10240)).astype(np.int8))
    ws = torch.full((4096,), 0.02 / 127)
    y = linear.resolve_mm("W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu")({"w": w, "w_scale": ws, "b": None}, x)
    assert calls == [(8, 10240)] and y.shape == (8, 4096) and y.dtype == torch.bfloat16
    torch.testing.assert_close(y, t8.w8a8_matmul_plain(x, w, ws), rtol=0, atol=0)
    q, s = t8.quantize_groups_plain(x, 1024)
    assert s.shape == (8, 10)


def test_int4_linear_dispatch_on_cpu():
    """The int4a8 mm_type runs w4a8 at every size; the FFN takes ffn_w4a8
    at min(H, K/2) >= 2048 with 2-D scales, else GEMM, GELU, GEMM."""
    from lightx2v_tpu_torch.ops import linear

    mm = linear.resolve_mm("W-int4-group-sym-A-int8-token-dynamic-Tpu")
    assert mm is linear.resolve_mm("W-nvfp4-A-nvfp4-dynamic-Tpu")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_x(rng, (1, 5, 256))).to(torch.bfloat16)
    wp, ws = _int4(rng, 512, 256)
    p0 = {"w": torch.from_numpy(wp), "w_scale": torch.from_numpy(ws), "b": None}
    wp2, ws2 = _int4(rng, 256, 512)
    p2 = {"w": torch.from_numpy(wp2), "w_scale": torch.from_numpy(ws2), "b": None}
    torch.testing.assert_close(mm(p0, x), t4.w4a8_matmul_plain(x, p0["w"], p0["w_scale"]), rtol=0, atol=0)
    h = t4.w4a8_matmul_plain(x, p0["w"], p0["w_scale"])
    ref = t4.w4a8_matmul_plain(torch.nn.functional.gelu(h.float(), approximate="tanh").to(h.dtype),
                               p2["w"], p2["w_scale"])
    torch.testing.assert_close(linear.mm_ffn(mm, p0, p2, x), ref, rtol=0, atol=0)


def test_jax_cpu_int4a8_is_weight_only():
    """Pinned difference (not a fault): the JAX package's CPU fallback for
    the int4a8 mm_type runs weight-only int4 with bf16 activations; the port
    follows the TPU kernel's contract (per-(token, group) int8 activations).
    The two differ by the activation quantization noise, measured 8.0e-3
    relative L2 here; bar 2e-2."""
    from lightx2v_tpu.ops import linear as jlinear

    rng = np.random.default_rng(2)
    x = _x(rng, (64, 1024))
    wp, ws = _int4(rng, 256, 1024)
    jx, tx = _jt(x)
    jout = np.asarray(jlinear.resolve_mm("W-int4-group-sym-A-int8-token-dynamic-Tpu")(
        {"w": jnp.asarray(wp), "w_scale": jnp.asarray(ws), "b": None}, jx), np.float32)
    np.testing.assert_array_equal(jout, np.asarray(jint4.int4_matmul_xla(jx, jnp.asarray(wp), jnp.asarray(ws)),
                                                   np.float32))
    tout = t4.w4a8_matmul(tx, torch.from_numpy(wp), torch.from_numpy(ws)).float().numpy()
    rel = np.linalg.norm(tout - jout) / np.linalg.norm(jout)
    assert 0 < rel < 2e-2, rel


def test_w4a8_x16_operand_folds_as_contract():
    """The CUDA GEMM feeds its tensor cores 16 * (nibble - 8), one LOP3 a
    word of high nibbles ((r & 0xF0) ^ 0x80) and a shift more for the low
    ones, so its group sums are 16 times the contract's; its fold then takes
    xs / 16. Both steps are exact: the bytes are 16 * (nibble - 8) for every
    packed byte, and (float(16 S) * (xs / 16)) * ws equals (float(S) * xs) *
    ws bit for bit over the group sums and scales a group of 512 can give."""
    r = np.arange(256, dtype=np.uint32)
    hi = ((r & 0xF0) ^ 0x80).astype(np.uint8).view(np.int8)
    lo = (((r << 4) & 0xF0) ^ 0x80).astype(np.uint8).view(np.int8)
    np.testing.assert_array_equal(hi, 16 * ((r >> 4).astype(np.int64) - 8))
    np.testing.assert_array_equal(lo, 16 * ((r & 15).astype(np.int64) - 8))
    rng = np.random.default_rng(16)
    s = torch.from_numpy(np.concatenate([rng.integers(-512 * 127 * 8, 512 * 127 * 8 + 1, 100_000),
                                         [512 * 127 * 8, -512 * 127 * 8, 1, -1, 0]]))
    xs = torch.clamp_min(torch.from_numpy(rng.random(s.shape[0]).astype(np.float32) * 8), 1e-8) * (1.0 / 127.0)
    ws = torch.from_numpy((0.5 + rng.random(s.shape[0]).astype(np.float32)) * (0.02 / 7))
    contract = (s.float() * xs) * ws
    kernel = ((16 * s).float() * (xs * 0.0625)) * ws
    assert torch.equal(kernel, contract)


def test_w4a8_refuses_misaligned_weights():
    """The GEMM reads the packed weights by TMA, so their start must be
    16-byte aligned; a view that is not is refused before any launch."""
    n, k = 8, 1024
    base = torch.zeros(n * k // 2 + 16, dtype=torch.uint8)
    w = base[1:1 + n * k // 2].view(n, k // 2)
    ws = torch.ones((n, 2), dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        t4._check_packed(w, ws, None, k, torch.device("cpu"), "w")
    assert t4._check_packed(base[16:16 + n * k // 2].view(n, k // 2), ws, None, k, torch.device("cpu"), "w")[0] == 512
