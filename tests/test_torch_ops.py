"""Port ops (norms, rope, linear, attention dispatch) vs their JAX
counterparts on the JAX CPU path, same numpy inputs. Each bar is stated
beside its comparison."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.ops import attention as jattn
from lightx2v_tpu.ops import linear as jlin
from lightx2v_tpu.ops import norms as jnorms
from lightx2v_tpu.ops import rope as jrope
from lightx2v_tpu_torch.ops import attention as tattn
from lightx2v_tpu_torch.ops import linear as tlin
from lightx2v_tpu_torch.ops import norms as tnorms
from lightx2v_tpu_torch.ops import rope as trope

# one bf16 ulp is 2^-8 relative; elementwise bf16 results may differ by a
# rounding flip where XLA fuses what torch rounds per op
BF16 = dict(rtol=2 ** -7, atol=1e-5)
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, bf16=True):
    return (jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32),
            torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16 if bf16 else torch.float32))


RNG = np.random.default_rng(0)
X = RNG.standard_normal((2, 37, 256)).astype(np.float32)
W = (1.0 + 0.1 * RNG.standard_normal(256)).astype(np.float32)


def test_rms_norm():
    jx, tx = _pair(X)
    ref = jnorms.rms_norm(jx, jnp.asarray(W), eps=1e-6)
    out = tnorms.rms_norm(tx, torch.from_numpy(W), eps=1e-6)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f(out), _f(ref), **BF16)


@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm(affine):
    jx, tx = _pair(X, bf16=False)
    b = RNG.standard_normal(256).astype(np.float32)
    ref = jnorms.layer_norm(jx, jnp.asarray(W) if affine else None, jnp.asarray(b) if affine else None)
    out = tnorms.layer_norm(tx, torch.from_numpy(W) if affine else None, torch.from_numpy(b) if affine else None)
    np.testing.assert_allclose(_f(out), _f(ref), **F32)


def test_modulated_layer_norm():
    jx, tx = _pair(X)
    shift = (0.1 * RNG.standard_normal((2, 1, 256))).astype(np.float32)
    scale = (0.1 * RNG.standard_normal((2, 1, 256))).astype(np.float32)
    ref = jnorms.modulated_layer_norm(jx, jnp.asarray(shift), jnp.asarray(scale))
    out = tnorms.modulated_layer_norm(tx, torch.from_numpy(shift), torch.from_numpy(scale))
    np.testing.assert_allclose(_f(out), _f(ref), **BF16)


def test_rope_tables_identical():
    for args in [(128, 5, 10, 10), (128, 21, 30, 52)]:
        jc, js = jrope.build_wan_rope_grid(*args)
        tc, ts = trope.build_wan_rope_grid(*args)
        np.testing.assert_array_equal(jc, tc)
        np.testing.assert_array_equal(js, ts)
    np.testing.assert_array_equal(jrope.rope_params_1d(64, 44), trope.rope_params_1d(64, 44))


@pytest.mark.parametrize("fn", ["apply_rope", "apply_rope_half"])
def test_apply_rope(fn):
    """fp32 rotation, cast per half: identical to a bf16 rounding flip;
    table shorter than the sequence (pass-through tail)."""
    cos, sin = jrope.build_wan_rope_grid(128, 2, 5, 5)  # 50 rows
    x = RNG.standard_normal((1, 60, 2, 128)).astype(np.float32)
    jx, tx = _pair(x)
    ref = getattr(jrope, fn)(jx, jnp.asarray(cos), jnp.asarray(sin))
    out = getattr(trope, fn)(tx, torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_allclose(_f(out), _f(ref), **BF16)


def test_rope_tables_full_and_timestep_embedding():
    cos, sin = jrope.build_wan_rope_grid(128, 2, 3, 3)
    jc, js = jrope.rope_tables_full(jnp.asarray(cos), jnp.asarray(sin))
    tc, ts = trope.rope_tables_full(torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_array_equal(_f(tc), _f(jc))
    np.testing.assert_array_equal(_f(ts), _f(js))
    t = np.array([1000.0, 750.0, 3.0], np.float32)
    # fp32 pow/cos/sin of arguments up to 1000: a few fp32 ulps of the angle
    np.testing.assert_allclose(_f(trope.sinusoidal_embedding_1d(256, torch.from_numpy(t))),
                               _f(jrope.sinusoidal_embedding_1d(256, jnp.asarray(t))), rtol=1e-4, atol=2e-4)


def _lin(n, k, seed, quant=False, kind="int8"):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    if quant:
        import ml_dtypes

        from lightx2v_tpu_torch.tools.convert import quantize_weight

        tq, ts = quantize_weight(torch.from_numpy(w), kind)
        jq = tq.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn) if kind == "fp8" else tq.numpy()
        return ({"w": jnp.asarray(jq), "w_scale": jnp.asarray(ts.numpy()), "b": jnp.asarray(b)},
                {"w": tq, "w_scale": ts, "b": torch.from_numpy(b)})
    return ({"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b)},
            {"w": torch.from_numpy(w).to(torch.bfloat16), "b": torch.from_numpy(b)})


def test_mm_default_and_fp32():
    jp, tp = _lin(96, 256, 1)
    jx, tx = _pair(X)
    # fp32 accumulation of exact bf16 products on both sides, one bf16 rounding
    np.testing.assert_allclose(_f(tlin.resolve_mm("Default")(tp, tx)),
                               _f(jlin.resolve_mm("Default")(jp, jx)), **BF16)
    jx32, tx32 = _pair(X, bf16=False)
    tp32 = {"w": tp["w"].float(), "b": tp["b"]}
    np.testing.assert_allclose(_f(tlin.resolve_mm("Default-Force-FP32")(tp32, tx32)),
                               _f(jlin.resolve_mm("Default-Force-FP32")(jp, jx32)), rtol=1e-5, atol=1e-5)


def test_mm_default_keeps_bf16_operands(monkeypatch):
    """Off the CPU, ``Default`` (and the bf16 T5 linear) hand torch.mm the
    bf16 operands and ask for an fp32 result: no fp32 copy of x or w; the
    bias is added in fp32 and the sum rounded once, as the JAX package's
    preferred_element_type=f32 dot (test_mm_default_and_fp32 holds the CPU
    branch against it, bar two bf16 ulps). Checked on the meta device, which
    takes the card's branch. ``Default-Force-FP32`` stays fp32."""
    from lightx2v_tpu_torch.encoders import t5 as tt5

    calls, real = [], torch.mm

    def recording_mm(a, b, *args, **kw):
        calls.append((a.dtype, b.dtype, kw.get("out_dtype")))
        return real(a, b, *args, **kw)

    monkeypatch.setattr(torch, "mm", recording_mm)
    meta = dict(device="meta")
    p = {"w": torch.empty((96, 256), dtype=torch.bfloat16, **meta), "b": torch.empty(96, **meta)}
    x = torch.empty((2, 37, 256), dtype=torch.bfloat16, **meta)
    y = tlin.resolve_mm("Default")(p, x)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 37, 96)
    assert tt5._lin(p["w"], x).dtype == torch.bfloat16
    assert calls == [(torch.bfloat16, torch.bfloat16, torch.float32)] * 2
    y32 = tlin.resolve_mm("Default-Force-FP32")({"w": p["w"].float(), "b": p["b"]}, x.float())
    assert y32.dtype == torch.float32 and len(calls) == 2


@pytest.mark.parametrize("alias", ["W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu",
                                   "W-int8-channel-sym-A-int8-channel-sym-dynamic-Vllm"])
def test_mm_int8_small_dims(alias):
    """min(N, K) < 4096: the per-token path (scale = absmax / 127), the same
    formula on both sides; bar two bf16 ulps."""
    jp, tp = _lin(192, 256, 2, quant=True)
    jx, tx = _pair(X)
    np.testing.assert_allclose(_f(tlin.resolve_mm(alias)(tp, tx)), _f(jlin.resolve_mm(alias)(jp, jx)), **BF16)
    # fused gelu form (mm_gelu) on the same path
    mm_t, mm_j = tlin.resolve_mm(alias), jlin.resolve_mm(alias)
    np.testing.assert_allclose(_f(tlin.mm_gelu(mm_t, tp, tx)), _f(jlin.mm_gelu(mm_j, jp, jx)), rtol=2 ** -6, atol=1e-4)


def test_mm_int8_large_dims_use_fullk_contract():
    """min(N, K) >= 4096 and K <= 8192 dispatch to w8a8_matmul_fullk: held
    against the Pallas kernel in interpret mode (the TPU contract)."""
    from lightx2v_tpu.ops.pallas.w8a8_matmul import w8a8_matmul_fullk

    jp, tp = _lin(4096, 4096, 3, quant=True)
    x = (np.random.default_rng(4).standard_normal((1, 8, 4096)) * 0.5).astype(np.float32)
    jx, tx = _pair(x)
    ref = w8a8_matmul_fullk(jx, jp["w"], jp["w_scale"], jp["b"], bm=8, bn=1024, interpret=True)
    out = tlin.resolve_mm("W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu")(tp, tx)
    np.testing.assert_allclose(_f(out), _f(ref), **BF16)


def test_mm_int8_kblocked_not_ported_raises():
    """K = 8320 (> 8192, not a multiple of 1024) now takes the k-blocked
    w8a8_matmul with 128-wide k-blocks; the fp8 block-scaled scheme
    (fp8_block128, an XLA scan in the JAX package) resolves to its own
    function (``test_torch_quant_schemes.py``)."""
    from lightx2v_tpu_torch.ops.cuda.w8a8_matmul import pick_kblock, w8a8_matmul_plain

    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.integers(-127, 128, (4096, 8320)).astype(np.int8))
    p = {"w": w, "w_scale": torch.full((4096,), 1e-4), "b": None}
    x = torch.from_numpy(rng.standard_normal((1, 8320)).astype(np.float32)).to(torch.bfloat16)
    out = tlin.resolve_mm("W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu")(p, x)
    assert pick_kblock(8320) == 128
    torch.testing.assert_close(out, w8a8_matmul_plain(x, w, p["w_scale"]), rtol=0, atol=0)
    assert tlin.resolve_mm("W-fp8-block128-sym-A-fp8-channel-group128-sym-dynamic-Tpu") is tlin._mm_fp8_block128


def test_mm_ffn_dispatch():
    """Below min(H, K) = 1024 both packages run GEMM -> GELU -> GEMM; at
    1024 the port runs ffn_w8a8 (checked against the Pallas kernel)."""
    alias = "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"
    j0, t0 = _lin(512, 256, 5, quant=True)
    j2, t2 = _lin(256, 512, 6, quant=True)
    jx, tx = _pair(X)
    # the bf16 hidden is requantized on both sides: rare code flips
    np.testing.assert_allclose(_f(tlin.mm_ffn(tlin.resolve_mm(alias), t0, t2, tx)),
                               _f(jlin.mm_ffn(jlin.resolve_mm(alias), j0, j2, jx)), rtol=2e-2, atol=2e-3)
    from lightx2v_tpu.ops.pallas.w8a8_matmul import ffn_w8a8

    j0, t0 = _lin(1024, 1024, 7, quant=True)
    j2, t2 = _lin(256, 1024, 8, quant=True)
    x = (np.random.default_rng(9).standard_normal((1, 24, 1024)) * 0.5).astype(np.float32)
    jx, tx = _pair(x)
    ref = ffn_w8a8(jx, j0["w"], j0["w_scale"], j0["b"], j2["w"], j2["w_scale"], j2["b"], bm=128, interpret=True)
    out = tlin.mm_ffn(tlin.resolve_mm(alias), t0, t2, tx)
    np.testing.assert_allclose(_f(out), _f(ref), rtol=2 ** -7, atol=1e-2 * float(np.abs(_f(ref)).max()))


FP8_ALIASES = ["W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Vllm",
               "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Q8F",
               "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Vllm-ActSgl",
               "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Sgl-ActVllm",
               "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Sgl",
               "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Tpu"]


@pytest.mark.parametrize("alias", FP8_ALIASES)
def test_mm_fp8_small_dims(alias):
    """min(N, K) < 4096: per-token e4m3 codes with scale absmax / 448 on
    both sides (the same division), exact products; the JAX dot sums them
    in fp32 where the port rounds the exact sum once: bar two bf16 ulps."""
    jp, tp = _lin(192, 256, 12, quant=True, kind="fp8")
    assert tp["w"].dtype == torch.float8_e4m3fn
    jx, tx = _pair(X)
    mm_t, mm_j = tlin.resolve_mm(alias), jlin.resolve_mm(alias)
    np.testing.assert_allclose(_f(mm_t(tp, tx)), _f(mm_j(jp, jx)), **BF16)
    # fused gelu form (mm_gelu) on the same path
    np.testing.assert_allclose(_f(tlin.mm_gelu(mm_t, tp, tx)), _f(jlin.mm_gelu(mm_j, jp, jx)), rtol=2 ** -6, atol=1e-4)


def test_quantize_per_token_fp8_matches_jax():
    """The XLA-path quantizer: same scales (absmax / 448) and the same e4m3
    codes bit for bit."""
    import ml_dtypes

    q, s = tlin.quantize_per_token_fp8(torch.from_numpy(X))
    jq, js = jlin.quantize_per_token_fp8(jnp.asarray(X))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(), np.asarray(jq).view(np.uint8))
    assert np.asarray(jq).dtype == ml_dtypes.float8_e4m3fn


@pytest.mark.parametrize("act", [None, "gelu"])
def test_mm_fp8_large_dims_use_fullk_contract(act):
    """min(N, K) >= 4096 and K <= 8192 dispatch to w8a8_matmul_fullk with
    kind fp8: held against the Pallas kernel in interpret mode (scale *
    (1/448), not / 448)."""
    from lightx2v_tpu.ops.pallas.w8a8_matmul import w8a8_matmul_fullk

    jp, tp = _lin(4096, 4096, 13, quant=True, kind="fp8")
    x = (np.random.default_rng(14).standard_normal((1, 8, 4096)) * 0.5).astype(np.float32)
    jx, tx = _pair(x)
    ref = w8a8_matmul_fullk(jx, jp["w"], jp["w_scale"], jp["b"], kind="fp8", act=act, bm=8, bn=1024, interpret=True)
    mm = tlin.resolve_mm("W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Tpu")
    out = tlin.mm_gelu(mm, tp, tx) if act else mm(tp, tx)
    np.testing.assert_allclose(_f(out), _f(ref), **BF16)


def test_mm_fp8_kblocked_route():
    """K = 10,240 (the UMT5-XXL fc2) takes the k-blocked GEMM's fp8 kind:
    the output is its plain version's, bit for bit."""
    from lightx2v_tpu_torch.ops.cuda.w8a8_matmul import w8a8_matmul_plain

    rng = np.random.default_rng(15)
    w = (torch.from_numpy(rng.standard_normal((4096, 10240)).astype(np.float32)) * 100).clamp(-448, 448)
    p = {"w": w.to(torch.float8_e4m3fn), "w_scale": torch.full((4096,), 2e-4), "b": None}
    x = torch.from_numpy(rng.standard_normal((1, 4, 10240)).astype(np.float32)).to(torch.bfloat16)
    out = tlin.resolve_mm("W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Tpu")(p, x)
    torch.testing.assert_close(out, w8a8_matmul_plain(x, p["w"], p["w_scale"], kind="fp8"), rtol=0, atol=0)
    assert out.shape == (1, 4, 4096) and torch.isfinite(out.float()).all()


def test_mm_fp8_ffn_dispatch():
    """fp8 FFN: below min(H, K) = 1024 both packages run GEMM -> GELU ->
    GEMM; at 1024 the port runs ffn_w8a8 with kind fp8 (held against the
    Pallas kernel in interpret mode)."""
    alias = "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Tpu"
    j0, t0 = _lin(512, 256, 16, quant=True, kind="fp8")
    j2, t2 = _lin(256, 512, 17, quant=True, kind="fp8")
    jx, tx = _pair(X)
    # the bf16 hidden is requantized on both sides: rare code flips
    np.testing.assert_allclose(_f(tlin.mm_ffn(tlin.resolve_mm(alias), t0, t2, tx)),
                               _f(jlin.mm_ffn(jlin.resolve_mm(alias), j0, j2, jx)), rtol=2e-2, atol=2e-3)
    from lightx2v_tpu.ops.pallas.w8a8_matmul import ffn_w8a8

    j0, t0 = _lin(1024, 1024, 18, quant=True, kind="fp8")
    j2, t2 = _lin(256, 1024, 19, quant=True, kind="fp8")
    x = (np.random.default_rng(20).standard_normal((1, 24, 1024)) * 0.5).astype(np.float32)
    jx, tx = _pair(x)
    ref = ffn_w8a8(jx, j0["w"], j0["w_scale"], j0["b"], j2["w"], j2["w_scale"], j2["b"], kind="fp8", bm=128,
                   interpret=True)
    out = tlin.mm_ffn(tlin.resolve_mm(alias), t0, t2, tx)
    np.testing.assert_allclose(_f(out), _f(ref), rtol=2 ** -7, atol=1e-2 * float(np.abs(_f(ref)).max()))


def test_unported_mm_type_raises():
    """An mm_type outside the JAX table raises; both int4 schemes (weight-only
    with bf16 activations, and int4 x int8) resolve, as different functions,
    and so does mxfp6."""
    with pytest.raises(KeyError):
        tlin.resolve_mm("W-int2-group-sym-A-bf16-Tpu")
    assert tlin.resolve_mm("W-mxfp6-A-bf16-Tpu") is tlin._mm_mxfp6
    assert tlin.resolve_mm("W-int4-group-sym-A-int8-token-dynamic-Tpu") is not None
    assert tlin.resolve_mm("W-int4-group-sym-A-bf16-Tpu") not in (
        None, tlin.resolve_mm("W-int4-group-sym-A-int8-token-dynamic-Tpu"))


def test_attention_dispatch_plain_and_rope():
    """The xla/torch_sdpa names: plain softmax attention (and xla_chunked, its
    online-softmax form); rope kwargs on a non-flash type apply the
    half-split rotation first; an unknown name raises. bar: fp32 logits,
    bf16 probabilities on both sides."""
    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal((1, 40, 2, 128)).astype(np.float32) for _ in range(3))
    cos, sin = jrope.build_wan_rope_grid(128, 2, 4, 5)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q), _pair(k), _pair(v)
    for name in ("xla", "torch_sdpa"):
        ref = jattn.attention(name, jq, jk, jv, rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin))
        out = tattn.attention(name, tq, tk, tv, rope_cos=torch.from_numpy(cos), rope_sin=torch.from_numpy(sin))
        np.testing.assert_allclose(_f(out), _f(ref), rtol=1e-2, atol=1e-2)
    ref = jattn.attention("xla", jq, jk, jv, kv_len=30)
    out = tattn.attention("xla", tq, tk, tv, kv_len=30)
    np.testing.assert_allclose(_f(out), _f(ref), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_f(tattn.attention("xla_chunked", tq, tk, tv, kv_len=30)), _f(ref), rtol=1e-2,
                               atol=1e-2)
    with pytest.raises(KeyError):
        tattn.attention("flash_attn9", tq, tk, tv)
    # sage and radial dispatch (radial without a mask map is dense flash)
    for name in ("radial_attn", "sage_attn2"):
        out = tattn.attention(name, tq, tk, tv)
        np.testing.assert_allclose(_f(out), _f(tattn.attention("flash_attn3", tq, tk, tv)), rtol=0, atol=3e-2)
