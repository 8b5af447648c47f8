"""The quant schemes and types the port took last from the JAX registries,
on the CPU, port vs JAX package: the converter's ``fp8_block128``, ``mxfp8``
and ``mxfp6`` weights (the e2m3 rounding against ``ml_dtypes`` at every
grid point and midpoint), ``unpack_fp6_e2m3``, the block-scaled fp8 GEMM in
its two layouts (128 x 128 blocks, zero-padded where in_features % 128 != 0;
the mx per-(channel, 32) scales) and its per-channel degrade, the mxfp6 GEMM,
``xla_chunked`` attention, every key of the JAX ``MM_REGISTER`` and
``ATTN_REGISTER``, and the synthesizer's layouts.

Bars: quantized codes and scales bit for bit (the same fp32 arithmetic and
round-to-nearest-even casts); the GEMMs within one bf16 ulp of the output
(2^-7 relative, 1e-2 of the output's max absolute: both sum the same exact
fp32 products per k-group, in orders that differ); the chunked attention
within 2e-2 of its max plus 1e-3 (fp32 statistics, P rounded to bf16 on
both sides)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lightx2v_tpu.ops import attention as jattn
from lightx2v_tpu.ops import linear as jlin
from lightx2v_tpu.tools import convert as jconv
from lightx2v_tpu_torch.ops import attention as tattn
from lightx2v_tpu_torch.ops import linear as tlin
from lightx2v_tpu_torch.tools import convert as tconv
from lightx2v_tpu_torch.utils.safetensors_io import as_tensor

BLOCK128 = "W-fp8-block128-sym-A-fp8-channel-group128-sym-dynamic-Tpu"
MXFP8 = "W-mxfp8-A-mxfp8-dynamic-Tpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _weights(o, i, seed=0):
    """Gaussian weights with lognormal column outliers (as a smoothed
    checkpoint's) and one all-zero row."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((o, i)) * 0.02 * np.exp(rng.standard_normal(i))[None]
    w[1] = 0.0
    return w.astype(np.float32)


@pytest.mark.parametrize("scheme,shape", [("fp8_block128", (300, 200)), ("fp8_block128", (256, 384)),
                                          ("mxfp8", (200, 320)), ("mxfp6", (200, 320)), ("mxfp6", (64, 32))])
def test_quantize_weight_vs_jax(scheme, shape):
    w = _weights(*shape)
    jq, js = jconv.quantize_tensor(w, scheme)
    tq, ts = tconv.quantize_weight(torch.from_numpy(w), scheme)
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), js)
    assert ts.dtype == torch.float32 and tuple(tq.shape) == np.asarray(jq).shape
    assert tconv.mm_type_for_scheme(scheme) == jconv.mm_type_for_scheme(scheme)


def test_fp6_encode_every_grid_point_and_midpoint():
    """e2m3: 0..0.875 by 1/8 (subnormal), 1..1.875 by 1/8, 2..3.75 by 1/4,
    4..7.5 by 1/2. Every grid value, every midpoint (ties to the even code),
    a hair either side of each midpoint, +-0 and values that round to +-0."""
    grid = np.concatenate([np.arange(8) / 8, 1 + np.arange(8) / 8, 2 + np.arange(8) / 4, 4 + np.arange(8) / 2])
    mids = (grid[1:] + grid[:-1]) / 2
    eps = np.float32(1e-4)
    pos = np.concatenate([grid, mids, mids + eps, mids - eps, [1e-9, 0.0625, 0.03, 7.49]]).astype(np.float32)
    vals = np.concatenate([pos, -pos, [np.float32(-0.0)]]).astype(np.float32)
    want = vals.astype(ml_dtypes.float6_e2m3fn).view(np.uint8)
    got = tconv.encode_fp6_e2m3(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) == 64  # every code, both zeros included


def test_unpack_fp6_vs_jax():
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 256, (17, 48), dtype=np.uint8)
    ref = np.asarray(jlin.unpack_fp6_e2m3(jnp.asarray(packed), 64))
    got = tlin.unpack_fp6_e2m3(torch.from_numpy(packed), 64).numpy()
    np.testing.assert_array_equal(got, ref)
    codes = rng.integers(0, 64, (5, 32)).astype(np.uint8)
    np.testing.assert_array_equal(tconv.pack_fp6(torch.from_numpy(codes)).numpy(), _pack_np(codes))


def _pack_np(codes):
    """The JAX converter's packing (``tools/convert.py``, mxfp6), on codes."""
    c = codes.reshape(codes.shape[0], -1, 4).astype(np.uint32)
    bits = c[..., 0] | (c[..., 1] << 6) | (c[..., 2] << 12) | (c[..., 3] << 18)
    return np.stack([bits & 255, (bits >> 8) & 255, (bits >> 16) & 255], axis=-1).astype(np.uint8).reshape(
        codes.shape[0], -1)


def _mm_pair(mm_type, params_np, x):
    jp = {k: jnp.asarray(v) for k, v in params_np.items()}
    tp = {k: as_tensor(np.asarray(v)) for k, v in params_np.items()}
    ref = np.asarray(jlin.resolve_mm(mm_type)(jp, jnp.asarray(x, jnp.bfloat16)), np.float32)
    out = tlin.resolve_mm(mm_type)(tp, torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    return out, ref


@pytest.mark.parametrize("mm_type,scheme,o,i", [
    (BLOCK128, "fp8_block128", 256, 384),  # the 128 x 128 grid
    (BLOCK128, "fp8_block128", 200, 200),  # in % 128 != 0: zero-padded to 256, the group stays 128
    (MXFP8, "mxfp8", 160, 320),  # the mx layout: w_scale rows == out_features, groups of 32
    ("W-fp8-block128-A-fp8-block128-dynamic-Tpu", "fp8", 128, 256),  # a 1-D scale: the per-channel path
    ("W-mxfp6-A-mxfp8-dynamic-Tpu", "mxfp6", 96, 320),
    ("W-mxfp6-A-bf16-Tpu", "mxfp6", 64, 64),
])
def test_block_scaled_mm_vs_jax(mm_type, scheme, o, i):
    w = _weights(o, i, seed=o + i)
    q, s = jconv.quantize_tensor(w, scheme)
    rng = np.random.default_rng(i)
    x = (rng.standard_normal((2, 9, i)) * np.exp(rng.standard_normal(i))[None, None]).astype(np.float32)
    b = (rng.standard_normal(o) * 0.1).astype(np.float32)
    out, ref = _mm_pair(mm_type, {"w": q, "w_scale": s, "b": b}, x)
    assert out.shape == ref.shape == (2, 9, o)
    np.testing.assert_allclose(out, ref, rtol=2 ** -7, atol=1e-2 * float(np.abs(ref).max()))


def test_block128_group_is_128_by_definition():
    """in = 200 with block scales of 2 columns: the second group covers
    columns 128..199, never 100..199 (a group inferred as in / 2 would)."""
    w = _weights(128, 200, seed=9)
    w[:, 128:] *= 50.0  # the second block's scale differs by far
    q, s = tconv.quantize_weight(torch.from_numpy(w), "fp8_block128")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 200)).astype(np.float32))
    out = tlin.resolve_mm(BLOCK128)({"w": q, "w_scale": s, "b": None}, x).numpy()
    np.testing.assert_allclose(out, x.numpy() @ w.T, rtol=0.1, atol=0.05 * float(np.abs(x.numpy() @ w.T).max()))


def test_registries_cover_jax():
    """Every key of the JAX package's mm and attention tables (Calib
    included) resolves in the port; none raises."""
    import lightx2v_tpu.ops.calib  # noqa: F401  (registers Calib)
    from lightx2v_tpu.utils.registry import ATTN_REGISTER as JATTN
    from lightx2v_tpu.utils.registry import MM_REGISTER as JMM
    from lightx2v_tpu_torch.utils.registry import ATTN_REGISTER, MM_REGISTER

    assert "Calib" in JMM and "xla_chunked" in JATTN
    for key in JMM.keys():
        assert callable(tlin.resolve_mm(key)), key
    for key in JATTN.keys():
        assert key in ATTN_REGISTER, key
    assert set(MM_REGISTER.keys()) == set(JMM.keys())
    with pytest.raises(KeyError):
        tlin.resolve_mm("W-int2-unknown")


def test_calib_mm_records_absmax():
    from lightx2v_tpu_torch.ops.calib import COLLECTOR

    COLLECTOR.reset()
    w = torch.randn(8, 16).to(torch.bfloat16)
    p = {"w": w, "b": None}
    x1, x2 = torch.randn(3, 5, 16), torch.randn(2, 16) * 3
    out = tlin.resolve_mm("Calib")(p, x1.to(torch.bfloat16))
    tlin.resolve_mm("Calib")(p, x2.to(torch.bfloat16))
    assert torch.equal(out, tlin.mm_default(p, x1.to(torch.bfloat16)))
    want = torch.maximum(x1.to(torch.bfloat16).float().abs().reshape(-1, 16).amax(0),
                         x2.to(torch.bfloat16).float().abs().amax(0))
    (got,) = COLLECTOR.named_stats().values()
    np.testing.assert_array_equal(got, want.numpy())
    COLLECTOR.reset()


@pytest.mark.parametrize("sq,sk,kv_len,chunk", [(300, 260, None, 64), (100, 300, 170, 64), (40, 40, None, 2048)])
def test_xla_chunked_vs_jax(sq, sk, kv_len, chunk):
    rng = np.random.default_rng(sq + sk)
    q, k, v = (rng.standard_normal((2, s, 2, 64)).astype(np.float32) for s in (sq, sk, sk))
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    ref = np.asarray(jattn.attn_xla_chunked(*j, kv_len=kv_len, q_chunk=chunk, k_chunk=chunk), np.float32)
    out = tattn.attn_chunked(*t, kv_len=kv_len, q_chunk=chunk, k_chunk=chunk).float().numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2 * float(np.abs(ref).max()) + 1e-3)
    via = tattn.attention("xla_chunked", *t, kv_len=kv_len).float().numpy()
    np.testing.assert_allclose(via, ref, rtol=0, atol=2e-2 * float(np.abs(ref).max()) + 1e-3)


def test_fp8_block128_listed_available():
    from lightx2v_tpu_torch.server import autoconfig

    assert dict(autoconfig.available_quant_schemes())["fp8_block128"] is True


@pytest.mark.parametrize("scheme,mm_type", [("fp8_block128", BLOCK128), ("mxfp8", MXFP8),
                                            ("mxfp6", "W-mxfp6-A-mxfp8-dynamic-Tpu")])
def test_synthetic_scheme_layouts(scheme, mm_type):
    """The device synthesizer's block linears have the converter's layout
    for the scheme (dtypes and shapes), and a small forward on them runs."""
    from lightx2v_tpu_torch.models.wan import config as tcfg
    from lightx2v_tpu_torch.models.wan import model as tmodel
    from lightx2v_tpu_torch.models.wan import weights as tweights
    from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape
    from lightx2v_tpu_torch.runners.wan_runner import scheme_of_mm_type

    assert scheme_of_mm_type(mm_type) == scheme
    arch = tcfg.WanArch(dim=256, ffn_dim=512, num_heads=2, num_layers=1, text_dim=256)
    params = tweights.init_random_params_on_device(arch, scheme, seed=0, device="cpu")
    lin = params["blocks"][0]["ffn"]["0"]
    q, s = tconv.quantize_weight(torch.randn(512, 256), scheme)
    assert lin["w"].dtype == q.dtype and lin["w"].shape == q.shape and lin["w_scale"].shape == s.shape
    shape = (16, 1, 4, 4)
    cos, sin, _ = rope_for_shape(arch, shape)
    out = tmodel.wan_forward(params, torch.randn(1, *shape), torch.tensor([500.0]),
                             torch.randn(1, 8, 256).to(torch.bfloat16), cos, sin, arch, mm_type=mm_type)
    assert out.shape == (1, 16, *shape[1:]) and torch.isfinite(out).all()
