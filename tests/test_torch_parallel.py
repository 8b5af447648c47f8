"""The port's multi-GPU layer on the CPU: gloo worlds of 4 ranks
(``torch.multiprocessing.spawn``, a ``file://`` rendezvous under the test's
tmp dir; the ranks import no JAX, ``tests/_torch_dist_ranks.py``) against
the JAX package's ``shard_map`` forms on the 8 virtual CPU devices of
``tests/conftest.py``, with the same mesh shapes. One world per mesh shape,
spawned once per module, each running several checks:

- ``{"dp": 2, "sp": 2}``: the Ulysses swaps (bit for bit), ``ulysses_attention``
  against dense attention (rtol 2e-4, atol 2e-5: ``tests/test_parallel.py``'s
  bar, fp32), the sharded Wan forward against ``wan_forward_sharded``;
- ``{"sp": 4}``: ring with a pad tail (18 tokens padded to 20; V = 1e4 on the
  pad rows of the primitive, which must not leak) against dense attention on
  the true keys, and the sharded forward (ring and Ulysses) against the JAX
  ring forward and the single-device forward;
- ``{"sp": 2, "tp": 2}``: ``wan_block_tp`` in bf16 and under the int8 mm_type
  against the JAX TP block (whose row-parallel linears quantize each token
  over the local K shard only, as the port's do), and the sharded forward.

Arches of ``tests/test_parallel.py``: dim 64, 4 heads, 2 layers. Whole
forwards and blocks are bf16: relative L2 1e-2, the whole-model bar of
ROADMAP.md Queue 3 a (the JAX CPU attention is an fp32 softmax, the port's
plain one rounds P to bf16); measured 4.7e-3 to 5.0e-3 on the forwards and
2.9e-3 on the TP blocks. The ring primitive: 2.0e-3 against its bar 8.6e-3.
The file takes ~25 s on one worker (three spawns of 4 ranks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist_ranks as R
from lightx2v_tpu.models.wan.config import WanArch
from lightx2v_tpu.models.wan.model import wan_forward
from lightx2v_tpu.models.wan.pipeline import rope_for_shape
from lightx2v_tpu.models.wan.sharded import _expand_quant_specs, wan_forward_sharded
from lightx2v_tpu.models.wan.weights import init_random_weight_dict, load_wan_params
from lightx2v_tpu.ops.attention import attn_xla
from lightx2v_tpu.ops.linear import resolve_mm
from lightx2v_tpu.ops.rope import build_wan_rope_grid
from lightx2v_tpu.parallel.mesh import build_mesh
from lightx2v_tpu.parallel.tensor_parallel import tp_block_specs, wan_block_tp
from lightx2v_tpu.tools.convert import quantize_model

FWD_BAR = 1e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def jwan():
    arch = WanArch(**R.WAN)
    return arch, init_random_weight_dict(arch, seed=0, scale=0.05)


def _jforward(jwan, mesh_shape=None, f=2, h=4, w=8, seed=1, seq_len=None, algo="ulysses"):
    arch, wd = jwan
    params = load_wan_params(wd, arch)
    lat, t, ctx = (jnp.asarray(a) for a in R.wan_inputs(f, h, w, seed))
    if seq_len is None:
        cos, sin = (jnp.asarray(a) for a in build_wan_rope_grid(arch.head_dim, f, h // 2, w // 2))
    else:
        cos, sin, _ = rope_for_shape(arch, (4, f, h, w), sp_pad=4)
    kw = dict(self_attn_type="xla", cross_attn_type="xla", seq_len=seq_len)
    if mesh_shape is None:
        fwd = jax.jit(lambda p, la, c: wan_forward(p, la, t, c, cos, sin, arch, **kw))
    else:
        mesh = build_mesh(mesh_shape)
        fwd = jax.jit(lambda p, la, c: wan_forward_sharded(p, la, t, c, cos, sin, arch, mesh,
                                                           parallel_attn_type=algo, **kw))
    return np.asarray(fwd(params, lat, ctx), np.float32)


@pytest.fixture(scope="module")
def dp2_sp2(tmp_path_factory):
    return R.spawn(R.world_dp2_sp2, 4, tmp_path_factory.mktemp("dp2_sp2"))


@pytest.fixture(scope="module")
def sp4(tmp_path_factory):
    return R.spawn(R.world_sp4, 4, tmp_path_factory.mktemp("sp4"))


@pytest.fixture(scope="module")
def sp2_tp2(tmp_path_factory):
    return R.spawn(R.world_sp2_tp2, 4, tmp_path_factory.mktemp("sp2_tp2"))


def test_ulysses_swaps_round_trip(dp2_sp2):
    """seq2head gives each rank its head slice of the whole sequence (the
    sp chunks concatenated in rank order) and head2seq undoes it, bit for
    bit, on every rank of {"dp": 2, "sp": 2} (ranks laid out row-major:
    rank 2 * dp + sp)."""
    for r in dp2_sp2:
        assert r["roundtrip_equal"] and r["heads_equal"]


def test_mesh_layout(dp2_sp2):
    """Ranks laid out row-major in (dp, sp, tp) order, as the JAX
    ``build_mesh`` reshapes its devices: rank r sits at (r // 2, r % 2, 0),
    its sp group holds its dp row; a mesh over ``mesh_devices`` [2, 3] leaves
    ranks 0 and 1 idle (outside the mesh)."""
    for r, res in enumerate(dp2_sp2):
        assert list(res["coords"]) == [r // 2, r % 2, 0]
        assert list(res["sp_ranks"]) == [2 * (r // 2), 2 * (r // 2) + 1]
        assert bool(res["sub_member"]) == (r >= 2)


def test_ulysses_attention_vs_dense(dp2_sp2):
    q, k, v = (jnp.asarray(a) for a in R.qkv())
    ref = np.asarray(attn_xla(q, k, v))
    for r in dp2_sp2:
        np.testing.assert_allclose(r["ulysses"], ref, rtol=2e-4, atol=2e-5)


def test_sharded_forward_dp2_sp2_vs_jax(jwan, dp2_sp2):
    """The sharded Wan forward (CFG's batch of 2 over dp, 16 tokens over
    sp) against the JAX ``wan_forward_sharded`` on the same mesh shape and
    against its single-device forward; every rank returns the same output."""
    ref = _jforward(jwan, {"dp": 2, "sp": 2})
    single = _jforward(jwan)
    out = dp2_sp2[0]["forward"]
    assert out.shape == ref.shape == (2, 4, 2, 4, 8)
    assert _rel(out, ref) < FWD_BAR and _rel(out, single) < FWD_BAR, (_rel(out, ref), _rel(out, single))
    for r in dp2_sp2[1:]:
        np.testing.assert_array_equal(r["forward"], out)


def test_ring_masks_pad_tail(sp4):
    """ring_attention over 4 ranks (bf16 q/k/v; its partials are the flash
    kernel's with LSE, row 5) with the last 2 of 20 keys padding (V = 1e4
    there) equals dense fp32 attention over the 18 true keys, at the flash
    rows' bar, 2e-2 * max |ref| + 1e-3 (q and P rounded to bf16); a leaked
    pad key would add ~1e4 * its weight."""
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in R.qkv(s=20, seed=2))
    ref = np.asarray(attn_xla(jnp.asarray(q), jnp.asarray(k[:, :18]), jnp.asarray(v[:, :18])))
    err = np.abs(sp4[0]["ring"] - ref).max()
    assert err <= 2e-2 * np.abs(ref).max() + 1e-3, err


@pytest.mark.parametrize("algo", ["ring", "ulysses"])
def test_sharded_forward_pad_tail_vs_jax(jwan, sp4, algo):
    """18 tokens (grid 2 x 3 x 3) padded to 20 on {"sp": 4}: the pad rows'
    K are not zero (the modulation shifts them), so only the masking makes
    the sharded forward agree with the JAX one of the same algorithm and with
    the single-device forward."""
    assert int(sp4[0]["seq_len"]) == 20
    ref = _jforward(jwan, {"sp": 4}, 2, 6, 6, 3, seq_len=20, algo=algo)
    single = _jforward(jwan, None, 2, 6, 6, 3, seq_len=20)
    out = sp4[0][f"forward_{algo}"]
    assert _rel(out, ref) < FWD_BAR and _rel(out, single) < FWD_BAR, (_rel(out, ref), _rel(out, single))


def _jax_tp_block(jwan, quant: bool):
    arch, wd = jwan
    mm_type = R.INT8 if quant else "Default"
    params = load_wan_params(quantize_model(wd, "int8") if quant else wd, arch)
    specs = _expand_quant_specs(params["blocks"], tp_block_specs(), 2)
    drop_l = lambda s: P(*tuple(s)[1:]) if isinstance(s, P) else s  # noqa: E731
    specs1 = jax.tree_util.tree_map(drop_l, specs, is_leaf=lambda s: isinstance(s, P))
    blk0 = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    x, e0, ctx = R.block_inputs()
    cos, sin = (jnp.asarray(a) for a in build_wan_rope_grid(arch.head_dim, 2, 2, 4))
    mm = resolve_mm(mm_type)

    def f(blk, xx, ee, cc):
        return wan_block_tp(blk, xx, ee, cc, None, cos, sin, arch, mm, attn_xla)

    sm = jax.shard_map(f, mesh=build_mesh({"sp": 2, "tp": 2}), in_specs=(specs1, P(), P(), P()), out_specs=P(),
                       check_vma=False)
    out = jax.jit(sm)(blk0, jnp.asarray(x, jnp.bfloat16), jnp.asarray(e0), jnp.asarray(ctx, jnp.bfloat16))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_tp_block_vs_jax(jwan, sp2_tp2, quant):
    """wan_block_tp on this rank's tp shard (``tp_shard_block``: q/k/v and
    ffn.0 split on their outputs, o and ffn.2 on their inputs, the int8
    per-channel scales with their outputs) with all-reduced QK-norm
    statistics and row-parallel products, against the JAX TP block on the
    same {"sp": 2, "tp": 2} mesh; every rank returns the same block output."""
    ref = _jax_tp_block(jwan, quant)
    name = "block_int8" if quant else "block_bf16"
    out = sp2_tp2[0][name]
    assert out.shape == ref.shape == (1, 16, 64)
    assert _rel(out, ref) < FWD_BAR, _rel(out, ref)
    for r in sp2_tp2[1:]:
        np.testing.assert_array_equal(r[name], out)


def test_tp_forward_vs_jax(jwan, sp2_tp2):
    """The sharded forward with heads and FFN over tp and tokens over sp."""
    ref = _jforward(jwan, {"sp": 2, "tp": 2})
    out = sp2_tp2[0]["forward"]
    assert _rel(out, ref) < FWD_BAR, _rel(out, ref)


def test_mesh_in_one_process():
    """Without a process group a mesh of 1 builds (no groups, every
    collective the identity) and a larger one raises ValueError, as the JAX
    ``build_mesh`` does for a mesh larger than its devices."""
    from lightx2v_tpu_torch.parallel import mesh as tmesh

    m = tmesh.build_mesh({"dp": 1, "sp": 1})
    assert m.member and m.ranks == [0] and not m.groups and m.coords == {"dp": 0, "sp": 0, "tp": 0}
    x = torch.arange(6.0).reshape(2, 3)
    assert tmesh.all_gather_cat(x, m, "sp", 1) is x and tmesh.shard(x, m, "dp", 0) is x
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.build_mesh({"sp": 2})

