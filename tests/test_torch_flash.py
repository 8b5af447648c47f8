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


def test_cuda_wrapper_rejects_bad_input_before_launch():
    """On a CUDA-typed request the wrapper validates; head dims other than
    128 are refused (checked on the meta device, no card needed)."""
    q = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        tflash._check(q, "q", q.device)
    q = torch.empty((1, 8, 2, 128), dtype=torch.float32, device="meta")
    with pytest.raises(TypeError):
        tflash._check(q, "q", q.device)
