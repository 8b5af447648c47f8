"""Port weight-only int4 GEMM (plain version of the CUDA kernel, which the
CPU wrapper runs) vs the JAX Pallas kernel in interpret mode, same inputs
made with numpy from a seed.

Bars: both sides multiply bf16 activations by the exact int4 values with
fp32 accumulation, rescale each group's partial product by its scale in fp32
and round the sum to bf16. Only the order of additions inside a group
differs (fp32 noise ~1e-6 relative to the sum), which moves a bf16 rounding
now and then: 2^-7 relative to max|ref| (one bf16 ulp at the top of the
range)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.ops.pallas import int4_matmul as jint4
from lightx2v_tpu_torch.ops.cuda import int4_matmul as tint4
from lightx2v_tpu_torch.tools.convert import quantize_int4_weight

BAR = 2 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(m, n, k, seed, group=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    packed, scale = quantize_int4_weight(torch.from_numpy(w), group)
    return x, packed.numpy(), scale.numpy()


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


def _close(out, ref):
    err = np.abs(_np(out) - _np(ref)).max()
    assert err <= BAR * np.abs(_np(ref)).max(), err


@pytest.mark.parametrize("m,n,k,group", [(256, 256, 1024, None), (100, 384, 512, None), (37, 256, 768, None),
                                         (64, 128, 256, 128), (8, 256, 1536, None)])
def test_int4_matmul_vs_pallas(m, n, k, group):
    """Groups of 512, 256 and 128, ragged M, N below one kernel tile."""
    x, packed, scale = _case(m, n, k, seed=m + n + k, group=group)
    assert scale.shape == (n, k // (group or jint4._pick_bk(k)))
    ref = jint4.int4_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(packed), jnp.asarray(scale),
                            bm=128, bn=128, interpret=True)
    before = tint4.LAUNCHES["int4_matmul"]
    out = tint4.int4_matmul(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(packed), torch.from_numpy(scale))
    assert tint4.LAUNCHES["int4_matmul"] == before  # the plain version is no launch
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    _close(out, ref)


def test_unpack_int4_equals_jax():
    _, packed, scale = _case(1, 96, 1024, seed=1)
    ref = np.asarray(jint4.unpack_int4(jnp.asarray(packed), jnp.asarray(scale)))
    out = tint4.unpack_int4(torch.from_numpy(packed), torch.from_numpy(scale))
    np.testing.assert_array_equal(out.numpy(), ref)
    vals = tint4.unpack_int4_values(torch.from_numpy(packed), scale.shape[1])
    assert vals.dtype == torch.int8 and int(vals.min()) >= -7 and int(vals.max()) <= 7


def test_bias_is_added_after_the_first_rounding():
    """y = bf16(bf16(x @ w) + b), not bf16(x @ w + b)."""
    x, packed, scale = _case(48, 128, 512, seed=2)
    xt, pt, st = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(packed), torch.from_numpy(scale)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(128).astype(np.float32))
    y = tint4.int4_matmul(xt, pt, st)
    yb = tint4.int4_matmul(xt, pt, st, b)
    assert torch.equal(yb, (y.float() + b[None]).to(torch.bfloat16))


@pytest.mark.parametrize("alias", ["W-int4-group-sym-A-bf16-Tpu", "W-int4-group128-sym-A-bf16", "W-nvfp4-A-bf16-Tpu"])
def test_mm_scheme_vs_jax(alias):
    """The registered scheme against the JAX package's (its CPU path
    dequantizes to bf16 weights first, so the scale rounds at another place:
    bar 2e-2 relative to max|ref|), and the FFN as GEMM, GELU, GEMM."""
    from lightx2v_tpu.ops.linear import resolve_mm as jresolve
    from lightx2v_tpu_torch.ops.linear import mm_ffn, resolve_mm

    x, packed, scale = _case(40, 256, 512, seed=4)
    b = np.random.default_rng(5).standard_normal(256).astype(np.float32) * 0.1
    jp = {"w": jnp.asarray(packed), "w_scale": jnp.asarray(scale), "b": jnp.asarray(b)}
    tp = {"w": torch.from_numpy(packed), "w_scale": torch.from_numpy(scale), "b": torch.from_numpy(b)}
    ref = _np(jresolve(alias)(jp, jnp.asarray(x, jnp.bfloat16)[None]))
    mm = resolve_mm(alias)
    out = _np(mm(tp, torch.from_numpy(x).to(torch.bfloat16)[None]))
    assert out.shape == ref.shape == (1, 40, 256)
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()

    _, p2, s2 = _case(1, 512, 256, seed=6)
    tp2 = {"w": torch.from_numpy(p2), "w_scale": torch.from_numpy(s2), "b": None}
    xt = torch.from_numpy(x).to(torch.bfloat16)
    h = torch.nn.functional.gelu(mm(tp, xt).float(), approximate="tanh").to(torch.bfloat16)
    assert torch.equal(mm_ffn(mm, tp, tp2, xt), mm(tp2, h))


def test_cuda_wrapper_rejects_bad_input_before_launch():
    """A CUDA-typed request validates before any launch (checked on the
    meta device, no card needed): fp32 activations and a group that is no
    multiple of 128 are refused."""
    w = torch.empty((64, 96), dtype=torch.uint8, device="meta")
    s = torch.empty((64, 1), dtype=torch.float32, device="meta")
    with pytest.raises(TypeError):
        tint4.int4_matmul(torch.empty((4, 192), dtype=torch.float32, device="meta"), w, s)
    with pytest.raises(ValueError, match="multiple of 128"):
        tint4.int4_matmul(torch.empty((4, 192), dtype=torch.bfloat16, device="meta"), w, s)
