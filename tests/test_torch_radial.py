"""Port radial attention vs the JAX package: the host-side masks and plans
exactly; the shared-mask block-sparse plain version vs the Pallas kernel in
interpret mode; ``radial_attention`` vs the JAX CPU path at 128 x 128 blocks;
``radial_two_pass`` vs dense attention under ``two_pass_token_mask``; the
partials and their merge; and the distill runner with ``radial_attn`` in
both executions vs the JAX runner.

Bars: attention outputs 1e-2 absolute + 1e-2 relative (bf16 outputs; the
port's plain versions round q*scale*log2e and P to bf16 as the kernels do,
the JAX CPU paths round P after the division; summation order differs). The
runner's latents: relative L2 2e-2 over two steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.ops import radial as jradial
from lightx2v_tpu.ops.pallas import block_sparse_attention as jbsa
from lightx2v_tpu.parallel import ring as jring
from lightx2v_tpu_torch.ops import radial as tradial
from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as tbsa
from lightx2v_tpu_torch.parallel import ring as tring

TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b, s, n=2, d=128, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, n, d)).astype(np.float32) for _ in range(3))


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


def _masked_dense(q, k, v, tok_mask):
    logits = torch.einsum("bqnd,bknd->bnqk", q.double(), k.double()) / np.sqrt(q.shape[-1])
    logits = logits.masked_fill(~torch.from_numpy(tok_mask)[None, None], float("-inf"))
    return torch.einsum("bnqk,bknd->bqnd", torch.softmax(logits, -1), v.double()).float()


# ---------------------------------------------------------------------------
# host-side masks and plans: equal arrays


SHAPES = [(1280, 1280, 5, 0.5, "wan"), (3072, 3072, 6, 0.5, "wan"), (1400, 1280, 5, 0.5, "wan"),
          (3600, 3600, 9, 0.5, "wan"), (3072, 3072, 6, 1.0, "wan"), (3600, 3600, 9, 1.0, "wan"),
          (3072, 3072, 6, 0.5, "hunyuan"), (1400, 1280, 5, 0.5, "hunyuan"),
          (32760, 32760, 21, 0.5, "wan")]  # the last: 480P at the runner's settings, 256 x 256 blocks


@pytest.mark.parametrize("seq,video,frames,decay,model", SHAPES)
def test_block_mask_equals_jax(seq, video, frames, decay, model):
    ref = jradial.radial_block_mask(seq, video, frames, decay, model)
    out = tradial.radial_block_mask(seq, video, frames, decay, model)
    np.testing.assert_array_equal(out, ref)
    assert tradial.MaskMap(video, frames).query_mask(seq, decay, model).shape == ref.shape
    for fq, fk in [(1, 1), (2, 1), (16, 8), (3, 5)]:
        cj, ct = jradial.coarsen_block_mask(ref, fq, fk), tradial.coarsen_block_mask(out, fq, fk)
        np.testing.assert_array_equal(ct, cj)
        for a, b in zip(tradial.mask_to_indices(ct), jradial.mask_to_indices(cj)):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_480p_mask_facts():
    """At 480P (32,760 tokens, 21 frames) the 128 x 128 mask has density
    0.433 and the 2048 x 1024 coarsening is fully dense."""
    mask = tradial.radial_block_mask(32760, 32760, 21, 0.5, "wan")
    assert mask.shape == (256, 256) and abs(mask.mean() - 0.433) < 1e-3
    assert tradial.coarsen_block_mask(mask, 16, 8).all()


@pytest.mark.parametrize("seq,video,frames,block_q", [(32760, 32760, 21, 256), (3072, 3072, 6, 256), (3072, 3072, 6, 128),
                                                      (1400, 1280, 5, 256), (1280, 1280, 4, 256), (600, 600, 6, 256),
                                                      (3600, 3600, 9, 200)])
def test_two_pass_plan_equals_jax(seq, video, frames, block_q):
    ref = jradial._two_pass_plan(seq, video, frames, 0.5, "wan", block_q)
    out = tradial._two_pass_plan(seq, video, frames, 0.5, "wan", block_q)
    assert (ref is None) == (out is None)
    if ref is None:
        return
    assert out[:2] == ref[:2]
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_array_equal(out[3], ref[3])
    if seq <= 4096:
        np.testing.assert_array_equal(tradial.two_pass_token_mask(seq, video, frames, block_q=block_q),
                                      jradial.two_pass_token_mask(seq, video, frames, block_q=block_q))


def test_480p_plan_facts():
    tpf, bq, near, far = tradial._two_pass_plan(32760, 32760, 21, 0.5, "wan", 256)
    assert (tpf, bq, near.shape, far.shape) == (1560, 195, (21, 4), (21, 8, 59))


# ---------------------------------------------------------------------------
# the shared-mask block-sparse form


@pytest.mark.parametrize("s,bq,bk", [(512, 128, 128), (600, 128, 128), (1000, 256, 128)])
def test_shared_block_sparse_vs_pallas(s, bq, bk):
    """2-D tables whose rows' tails repeat the last block; ragged S; B = 2."""
    q, k, v = _qkv(2, s, seed=s)
    nq, nk = -(-s // bq), -(-s // bk)
    mask = np.random.default_rng(s).random((nq, nk)) < 0.4
    mask[np.arange(nq), np.minimum(np.arange(nq) * bq // bk, nk - 1)] = True  # diagonal: a valid first block
    idx, cnt = tradial.mask_to_indices(mask)
    assert idx.shape[1] > cnt.min() and (idx[cnt.argmin(), cnt.min():] == idx[cnt.argmin(), cnt.min() - 1]).all()
    ref = jbsa.block_sparse_attention(_j(q), _j(k), _j(v), jnp.asarray(idx), jnp.asarray(cnt), interpret=True,
                                      bq=bq, bk=bk)
    out = tbsa.block_sparse_attention(_t(q), _t(k), _t(v), torch.from_numpy(idx), torch.from_numpy(cnt),
                                      bq=bq, bk=bk)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)
    # the same function as the per-head form on the table repeated per head
    per_head = tbsa.block_sparse_attention(_t(q), _t(k), _t(v), torch.from_numpy(idx)[None].repeat(4, 1, 1),
                                           torch.from_numpy(cnt)[None].repeat(4, 1), bq=bq, bk=bk)
    assert torch.equal(out, per_head)


def test_shared_tables_are_validated():
    q = torch.empty((1, 300, 2, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):  # too few rows for 300 tokens
        tbsa.block_sparse_attention(q, q, q, torch.empty((2, 3), dtype=torch.int32, device="meta"),
                                    torch.empty((2,), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):  # counts must match the table's leading axes
        tbsa.block_sparse_attention(q, q, q, torch.empty((3, 3), dtype=torch.int32, device="meta"),
                                    torch.empty((2, 3), dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# partials and their merge


def test_partial_attention_and_merge_vs_jax():
    q, k, v = _qkv(2, 200, seed=1)
    jo, jl = jring._partial_attn_jnp(_j(q), _j(k), _j(v), kv_len=170)
    to, tl = tring._partial_attn(_t(q), _t(k), _t(v), kv_len=170)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    ko, kl = tring.partial_attention(_t(q), _t(k), _t(v), kv_len=170)  # the kernel's plain version
    np.testing.assert_allclose(_np(ko), _np(jo), **TOL)
    np.testing.assert_allclose(kl.numpy(), np.asarray(jl), rtol=0, atol=2e-2)

    rng = np.random.default_rng(2)
    oa, ob = _qkv(2, 50, seed=3)[:2]
    la, lb = (rng.standard_normal((2, 50, 2)).astype(np.float32) * 3 for _ in range(2))
    jm, jml = jring.merge_partials(_j(oa), jnp.asarray(la), _j(ob), jnp.asarray(lb))
    tm, tml = tring.merge_partials(_t(oa), torch.from_numpy(la), _t(ob), torch.from_numpy(lb))
    assert tm.dtype == torch.bfloat16
    # bar: fp32 sigmoid/logaddexp from two libraries, then one bf16 rounding
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(tml.numpy(), np.asarray(jml), rtol=1e-6, atol=1e-6)


def test_merged_halves_equal_one_dense_call():
    q, k, v = (_t(a) for a in _qkv(1, 300, seed=4))
    oa, la = tring.partial_attention(q, k[:, :130], v[:, :130])
    ob, lb = tring.partial_attention(q, k[:, 130:], v[:, 130:])
    out, lse = tring.merge_partials(oa, la, ob, lb)
    ref, ref_lse = tring.partial_attention(q, k, v)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# radial_attention, both executions


F_, TPF = 6, 512
S = F_ * TPF


def test_radial_attention_vs_jax_cpu_path():
    """At 128 x 128 blocks the block-sparse execution applies exactly the
    mask of the JAX CPU path."""
    q, k, v = _qkv(1, S, seed=5)
    ref = jradial.radial_attention(_j(q), _j(k), _j(v), jradial.MaskMap(S, F_), decay_factor=0.5)
    mm = tradial.MaskMap(S, F_)
    for kind in ("radial", "bsr"):
        out = tradial.radial_attention(_t(q), _t(k), _t(v), mm, sparsity_type=kind, decay_factor=0.5,
                                       block_q=128, block_k=128)
        np.testing.assert_allclose(_np(out), _np(ref), **TOL)
    assert len(mm._tables) == 1  # one table for all calls
    mask = np.repeat(np.repeat(mm.query_mask(S), 128, 0), 128, 1)
    np.testing.assert_allclose(_np(out), _np(_masked_dense(_t(q), _t(k), _t(v), mask)), **TOL)


def test_radial_coarse_blocks_are_a_superset():
    """Default superblocks (2048 x 1024) union-pool the mask: at this shape
    fully dense, i.e. dense attention."""
    from lightx2v_tpu_torch.ops.attention import attention

    q, k, v = (_t(a) for a in _qkv(1, S, seed=6))
    mm = tradial.MaskMap(S, F_)
    assert tradial.coarsen_block_mask(mm.query_mask(S), 16, 8).all()
    out = attention("radial_attn", q, k, v, mask_map=mm, decay_factor=0.5)
    np.testing.assert_allclose(_np(out), _np(attention("flash_attn3", q, k, v)), **TOL)
    # and without a mask map radial is dense flash
    assert torch.equal(attention("radial_attn", q[:, :256], k[:, :256], v[:, :256]),
                       attention("flash_attn3", q[:, :256], k[:, :256], v[:, :256]))


@pytest.mark.parametrize("text", [0, 100])
def test_two_pass_vs_token_mask_oracle_and_jax(text):
    s = S + text
    q, k, v = _qkv(1, s, seed=7 + text)
    mm = tradial.MaskMap(S, F_)
    out = tradial.radial_two_pass(_t(q), _t(k), _t(v), mm)
    assert out.shape == (1, s, 2, 128) and out.dtype == torch.bfloat16
    oracle = _masked_dense(_t(q), _t(k), _t(v), tradial.two_pass_token_mask(s, S, F_))
    np.testing.assert_allclose(_np(out), _np(oracle), **TOL)
    ref = jradial.radial_two_pass(_j(q), _j(k), _j(v), jradial.MaskMap(S, F_))
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)
    # radial_attention plans with min(block_q, 256) query rows per tile
    same = tradial.radial_attention(_t(q), _t(k), _t(v), mm, sparsity_type="two_pass", block_q=2048, block_k=128)
    assert torch.equal(same, out)


def test_two_pass_falls_to_block_sparse_without_a_plan():
    s, f = 1024, 4  # fewer than 5 frames: no plan
    q, k, v = (_t(a) for a in _qkv(1, s, seed=9))
    mm = tradial.MaskMap(s, f)
    assert tradial.radial_two_pass(q, k, v, mm) is None
    out = tradial.radial_attention(q, k, v, mm, sparsity_type="two_pass", block_q=128, block_k=128)
    assert torch.equal(out, tradial.radial_attention(q, k, v, mm, block_q=128, block_k=128))


# ---------------------------------------------------------------------------
# through the runner


CFG = dict(model_cls="wan2.1_distill", task="t2v", synthetic_weights=True, prompt="a red panda climbing",
           seed=42, enable_cfg=False, target_video_length=17, target_height=256, target_width=256,
           sample_shift=5, rope_fused=True, latent_init="torch", denoising_step_list=[1000, 500],
           dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256, text_len=64,
           self_attn_1_type="radial_attn", cross_attn_1_type="flash_attn3", sparse_block_q=128, sparse_block_k=128)


@pytest.fixture(scope="module")
def jax_latents():
    from lightx2v_tpu.runners.wan_runner import WanDistillRunner as JRunner
    from lightx2v_tpu.utils.config import set_config as jset

    jr = JRunner(jset(dict(CFG)))
    return np.asarray(jr.run_dit(jr.run_input_encoder()))


@pytest.mark.parametrize("kind", [None, "bsr", "two_pass"])
def test_runner_radial_vs_jax(jax_latents, kind):
    """5 latent frames of 256 tokens: 1280 tokens, 10 x 10 blocks. The JAX
    runner passes no sparsity_type (on the CPU: the 128-block token mask);
    the port's two_pass attends a superset of that mask, so its bar is
    looser (relative L2 5e-2)."""
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    cfg = dict(CFG, device="cpu")
    if kind:
        cfg["radial_sparsity_type"] = kind
    tr = tinfer.init_runner(tset(cfg))
    shape = tuple(tr.set_target_shape())
    assert shape == (16, 5, 32, 32)
    assert tradial._two_pass_plan(1280, 1280, 5, 0.5, "wan", 256) is not None
    rng, noises = jax.random.PRNGKey(CFG["seed"] + 1), []
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        noises.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    lat = tr.run_dit(tr.run_input_encoder(), noises=noises).numpy()
    rel = np.linalg.norm(lat - jax_latents) / np.linalg.norm(jax_latents)
    assert np.isfinite(lat).all() and rel < (5e-2 if kind == "two_pass" else 2e-2), rel
