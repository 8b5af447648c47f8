"""Port Sparge selection and per-head block-sparse attention vs the JAX
package, same inputs.

Selection must give identical indices and counts. Attention: the port's
plain version of the block-sparse kernel against the Pallas kernel in
interpret mode; both scale q by scale*log2(e) and round it to bf16, run an
exp2 softmax in fp32 and round P to bf16 before P.V, and differ only in the
running maxima at which P is rounded (one pass over the selected keys vs
one superblock at a time) and in summation order: bar 1e-2 absolute + 1e-2
relative, as for flash attention."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.ops import sparge as jsparge
from lightx2v_tpu.ops.pallas import block_sparse_attention as jbs
from lightx2v_tpu_torch.ops import sparge as tsparge
from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as tbs

TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qk(s, n=2, d=128, seed=0, structure=2.0):
    """q, k with a per-(128-block, head) offset, so block means (and the
    scores) vary and the selection is not uniform."""
    rng = np.random.default_rng(seed)
    nb = -(-s // 128)

    def one():
        off = np.repeat(rng.standard_normal((1, nb, n, d)), 128, axis=1)[:, :s] * structure
        return (rng.standard_normal((1, s, n, d)) + off).astype(np.float32)

    return one(), one(), rng.standard_normal((1, s, n, d)).astype(np.float32)


def _both(a):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("s,bq,bk,keep,l1", [
    (500, 128, 128, 0.5, 0.07),      # ragged tail block (500 = 3*128 + 116)
    (1000, 512, 256, 0.5, 0.3),      # superblocks; two diagonal key blocks per q row tie at 1e9
    (1300, 256, 128, 0.3, np.float32(0.3)),  # a per-layer (fp32) l1
    (384, 2048, 1024, 0.3, 0.3),     # superblocks clamped to the sequence
])
def test_select_blocks_identical(s, bq, bk, keep, l1):
    q, k, _ = _qk(s, seed=s)
    (jq, tq), (jk, tk) = _both(q), _both(k)
    ji, jc = jsparge.sparge_select_blocks(jq, jk, keep_ratio=keep, l1=jnp.float32(l1) if isinstance(l1, np.floating)
                                          else l1, block_q=bq, block_k=bk)
    ti, tc = tsparge.sparge_select_blocks(tq, tk, keep_ratio=keep, l1=float(l1), block_q=bq, block_k=bk)
    assert ti.dtype == tc.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.min()) >= 1
    if bq == 128:  # at 128-token blocks some rows stop before nnz
        assert (tc.numpy() < ti.shape[-1]).any()


def test_select_blocks_diagonal_tie_order():
    """Both diagonal key superblocks of a q superblock are bumped to exactly
    1e9 (fp32) and come first, lower index first, as lax.top_k orders ties."""
    q, k, _ = _qk(1000, seed=7)
    ti, tc = tsparge.sparge_select_blocks(torch.from_numpy(q).to(torch.bfloat16),
                                          torch.from_numpy(k).to(torch.bfloat16), keep_ratio=0.5, l1=0.0,
                                          block_q=512, block_k=256)
    assert ti.shape[1:] == (2, 2)
    np.testing.assert_array_equal(ti[:, 0, :2].numpy(), np.tile([0, 1], (2, 1)))
    np.testing.assert_array_equal(ti[:, 1, :2].numpy(), np.tile([2, 3], (2, 1)))
    assert (tc >= 2).all()


def _tables(bn, nq, nk, nnz, seed):
    """Random out-of-order block lists with counts below nnz; the last key
    block (which straddles the sequence end) appears at varying j."""
    rng = np.random.default_rng(seed)
    def row(pos):  # a permutation of the key blocks, the last one at pos
        p = list(rng.permutation(nk - 1))
        p.insert(pos, nk - 1)
        return p[:nnz]

    idx = np.array([[row(int(rng.integers(0, nk))) for _ in range(nq)] for _ in range(bn)], np.int32)
    idx[0, 0], idx[1, -1] = row(0), row(1)
    cnt = rng.integers(1, nnz + 1, (bn, nq)).astype(np.int32)
    cnt[0, 0], cnt[1, -1] = 2, nnz
    return idx, cnt


@pytest.mark.parametrize("s,bq,bk,nnz", [(600, 128, 128, 3), (600, 256, 128, 4), (700, 256, 256, 2),
                                          (600, 128, 192, 3)])
def test_block_sparse_plain_matches_pallas(s, bq, bk, nnz):
    q, k, v = _qk(s, seed=s + bq, structure=0.5)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    nq, nk = -(-s // bq), -(-s // bk)
    idx, cnt = _tables(2, nq, nk, nnz, seed=s)
    ref = jbs.block_sparse_attention(jq, jk, jv, jnp.asarray(idx), jnp.asarray(cnt), interpret=True, bq=bq, bk=bk)
    out = tbs.block_sparse_attention(tq, tk, tv, torch.from_numpy(idx), torch.from_numpy(cnt), bq=bq, bk=bk)
    assert out.shape == (1, s, 2, 128) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **TOL)


def test_sparge_attention_matches_pallas():
    q, k, v = _qk(500, seed=3)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    kw = dict(keep_ratio=0.5, l1=0.1, block_q=128, block_k=128)
    ref = jsparge.sparge_attention(jq, jk, jv, interpret=True, **kw)
    out = tsparge.sparge_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **TOL)
    torch.testing.assert_close(tsparge.sparge_attention_plain(tq, tk, tv, **kw), out, rtol=0, atol=0)


def test_jax_cpu_sparge_is_dense_masked_fp32():
    """Pinned difference (not a fault): on the CPU the JAX package's sparge
    dispatch runs ``sparge_attention_xla`` (dense mask, fp32 softmax, q not
    re-rounded to bf16); the port runs the TPU kernel's arithmetic. Same
    selection; the outputs differ at bf16 noise, measured 3.1e-3 relative L2
    here; bar 1e-2."""
    from lightx2v_tpu.ops.attention import attention as jattention

    q, k, v = _qk(500, seed=5)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    kw = dict(keep_ratio=0.5, l1=0.1, block_q=128, block_k=128)
    jx = np.asarray(jattention("sparge", jq, jk, jv, **kw), np.float32)
    np.testing.assert_array_equal(jx, np.asarray(jsparge.sparge_attention_xla(jq, jk, jv, **kw), np.float32))
    out = tsparge.sparge_attention(tq, tk, tv, **kw).float().numpy()
    rel = np.linalg.norm(out - jx) / np.linalg.norm(jx)
    assert 0 < rel < 1e-2, rel
