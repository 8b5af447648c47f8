"""Port flash attention (plain versions of the CUDA kernels, which the CPU
wrappers run) vs the JAX Pallas kernels in interpret mode, same inputs.

Bars: both sides scale q by scale*log2(e) and round it to bf16, run an exp2
softmax in fp32 and round P to bf16 before P.V; they differ only in the
running maxima at which P is rounded (one pass vs 128-key tiles) and in
summation order, so outputs agree to ~1e-3 of bf16 attention outputs; the
bar is 1e-2 absolute + 1e-2 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.ops.pallas import flash_attention as jflash
from lightx2v_tpu_torch.ops.cuda import flash_attention as tflash

TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(sq, sk, n=2, d=128, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s: (rng.standard_normal((1, s, n, d)) * 1.5).astype(np.float32)  # noqa: E731
    return mk(sq), mk(sk), mk(sk)


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


@pytest.mark.parametrize("case", ["none", "phantom", "last", "traced"])
def test_flash_attention_mask_modes(case):
    """kv_len None on a block multiple ("none"), None with a ragged tail
    ("phantom": kv_len == sk), a static kv_len below sk ("last") and a
    traced kv_len ("all"); every mode must give the masked-softmax result."""
    sq, sk = {"none": (256, 256), "phantom": (200, 200), "last": (200, 200), "traced": (180, 200)}[case]
    q, k, v = _qkv(sq, sk)
    kv = {"none": None, "phantom": None, "last": 150, "traced": 170}[case]
    jkv = jnp.asarray(kv, jnp.int32) if case == "traced" else kv
    ref = jflash.flash_attention(_j(q), _j(k), _j(v), kv_len=jkv, bq=128, bk=128, interpret=True)
    tkv = torch.tensor(kv) if case == "traced" else kv
    out = tflash.flash_attention(_t(q), _t(k), _t(v), kv_len=tkv)
    assert out.shape == (1, sq, 2, 128) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("kv_len", [None, 160])
def test_flash_attention_fused_rope_short_table(kv_len):
    """Half-split RoPE rotated in fp32 inside the kernel, table shorter than
    the sequence (positions past it keep the identity rotation)."""
    from lightx2v_tpu.ops.rope import build_wan_rope_grid

    q, k, v = _qkv(200, 200, seed=1)
    cos, sin = build_wan_rope_grid(128, 3, 7, 7)  # 147 rows < 200 tokens
    ref = jflash.flash_attention_fused_rope(_j(q), _j(k), _j(v), jnp.asarray(cos), jnp.asarray(sin),
                                            kv_len=kv_len, bq=128, bk=128, interpret=True)
    out = tflash.flash_attention_fused_rope(_t(q), _t(k), _t(v), torch.from_numpy(cos),
                                            torch.from_numpy(sin), kv_len=kv_len)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_cross_attention_shape():
    """Cross-attention form: many queries over a short key set."""
    q, _, _ = _qkv(300, 1, seed=2)
    _, k, v = _qkv(1, 64, seed=3)
    ref = jflash.flash_attention(_j(q), _j(k), _j(v), bq=128, bk=128, interpret=True)
    out = tflash.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("b,sq,sk,kv_len", [(1, 256, 256, None), (3, 195, 330, None), (2, 70, 200, 150),
                                            (1, 130, 129, None)])
def test_flash_attention_with_lse_vs_pallas(b, sq, sk, kv_len):
    """Out and the natural-log row log-sum-exp, at block multiples, ragged
    odd lengths (Sq below two tiles, the two-pass radial far pass's form), a
    batch axis and a static kv_len. lse bar: fp32 sums in another order,
    1e-3 absolute."""
    rng = np.random.default_rng(sq + sk)
    mk = lambda s: (rng.standard_normal((b, s, 2, 128)) * 1.5).astype(np.float32)  # noqa: E731
    q, k, v = mk(sq), mk(sk), mk(sk)
    ref, ref_lse = jflash.flash_attention_with_lse(_j(q), _j(k), _j(v), kv_len=kv_len, bq=128, bk=128,
                                                   interpret=True)
    out, lse = tflash.flash_attention_with_lse(_t(q), _t(k), _t(v), kv_len=kv_len)
    assert out.shape == (b, sq, 2, 128) and out.dtype == torch.bfloat16
    assert lse.shape == (b, sq, 2) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=0, atol=1e-3)
    # and it is the log-sum-exp of the scaled logits of the bf16-rounded inputs
    kv = sk if kv_len is None else kv_len
    logits = torch.einsum("bqnd,bknd->bqnk", _t(q).double(), _t(k).double()[:, :kv]) / np.sqrt(128.0)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, dim=-1).numpy(), rtol=0, atol=3e-2)
    assert torch.equal(out, tflash.flash_attention(_t(q), _t(k), _t(v), kv_len=kv_len))


def test_flash_attention_with_lse_all_keys_masked():
    """kv_len 0: zero output and lse -inf (the TPU kernel's
    m*ln2 + log(1e-30) with m = -inf)."""
    q, k, v = _qkv(10, 20)
    out, lse = tflash.flash_attention_with_lse(_t(q), _t(k), _t(v), kv_len=0)
    assert not out.any() and torch.isinf(lse).all() and (lse < 0).all()


def test_cuda_wrapper_rejects_bad_input_before_launch():
    """On a CUDA-typed request the wrapper validates; head dims other than
    128 are refused (checked on the meta device, no card needed)."""
    q = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        tflash._check(q, "q", q.device)
    q = torch.empty((1, 8, 2, 128), dtype=torch.float32, device="meta")
    with pytest.raises(TypeError):
        tflash._check(q, "q", q.device)


@pytest.mark.parametrize("kv_len", [None, 170])
def test_fused_rope_is_rope_pass_then_dense(kv_len):
    """The card path's decomposition: the RoPE pass (q rotated and scaled,
    k rotated, both rounded to bf16) followed by the dense attention with
    gain 1 is the fused-RoPE function, bit for bit; the table (147 rows) is
    shorter than the 260 tokens."""
    from lightx2v_tpu.ops.rope import build_wan_rope_grid

    q, k, v = (_t(a) for a in _qkv(260, 260, seed=4))
    cos, sin = (torch.from_numpy(a) for a in build_wan_rope_grid(128, 3, 7, 7))
    gain = tflash._gain(128)
    qr, kr = tflash.rope_rotate(q, k, cos, sin, gain)
    assert qr.dtype == kr.dtype == torch.bfloat16 and qr.shape == q.shape and kr.shape == k.shape
    assert torch.equal(kr[:, 147:], k[:, 147:])  # identity rotation past the table
    fused = tflash.flash_attention_fused_rope_plain(q, k, v, cos, sin, kv_len)
    assert torch.equal(fused, tflash._attend_plain(qr, kr, v, tflash._kv_limit(kv_len, 260)))


@pytest.mark.parametrize("b,sq,sk,kv_len", [(1, 256, 256, None), (2, 200, 330, None), (2, 130, 257, 150),
                                            (1, 70, 129, None)])
def test_flash_attention_d64_vs_pallas(b, sq, sk, kv_len):
    """Head dim 64 (CogVideoX's 48 heads of 64): the plain version of the
    64-wide kernel against the Pallas kernel in interpret mode, at a block
    multiple, ragged sq and sk (a 74-row and a 1-key last tile), a batch
    axis and a static kv_len. Bar: as above."""
    rng = np.random.default_rng(sq + sk)
    mk = lambda s: (rng.standard_normal((b, s, 2, 64)) * 1.5).astype(np.float32)  # noqa: E731
    q, k, v = mk(sq), mk(sk), mk(sk)
    ref = jflash.flash_attention(_j(q), _j(k), _j(v), kv_len=kv_len, bq=128, bk=128, interpret=True)
    out = tflash.flash_attention(_t(q), _t(k), _t(v), kv_len=kv_len)
    assert out.shape == (b, sq, 2, 64) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_head_dim_64_only_for_the_dense_wrapper():
    """The dense wrapper takes head dim 64 (its checks pass; checked on the
    meta device, no card needed); the sage, block-sparse, fused-RoPE and LSE
    wrappers refuse it before any launch, and every wrapper refuses other
    widths and a k/v width unlike q's."""
    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as tbsa
    from lightx2v_tpu_torch.ops.cuda import sage_attention as tsage

    meta = lambda d, s=8: torch.empty((1, s, 2, d), dtype=torch.bfloat16, device="meta")  # noqa: E731
    q = meta(64)
    tflash._check_qkv(q, q, q, tflash.DENSE_HEAD_DIMS)
    for d in (32, 96):
        with pytest.raises(ValueError):
            tflash.flash_attention(meta(d), meta(d), meta(d))
    with pytest.raises(ValueError):
        tflash.flash_attention(q, meta(128), meta(128))
    cos = torch.empty((8, 32), dtype=torch.float32, device="meta")
    idx = torch.zeros((2, 1, 1), dtype=torch.int32, device="meta")
    refusals = (lambda: tsage.sage_attention(q, q, q),
                lambda: tbsa.block_sparse_attention(q, q, q, idx, idx[..., 0]),
                lambda: tflash.flash_attention_with_lse(q, q, q),
                lambda: tflash.flash_attention_fused_rope(q, q, q, cos, cos))
    for call in refusals:
        with pytest.raises(ValueError):
            call()
