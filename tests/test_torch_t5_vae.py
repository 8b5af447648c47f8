"""Port T5 encoder and Wan VAE decoder vs the JAX package on its CPU path,
from one numpy state dict each (the synthetic-runner configs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.encoders import t5 as jt5
from lightx2v_tpu.vae import wan_vae as jvae
from lightx2v_tpu_torch.encoders import t5 as tt5
from lightx2v_tpu_torch.vae import wan_vae as tvae


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def test_t5_encode_matches_jax():
    """Synthetic-runner T5 (dim 256, 2 layers, 8 heads); bf16 linears with
    fp32 accumulation and fp32 softmax on both sides. Bar: relative L2 1e-2
    (bf16 rounding of every block output)."""
    cfg_kw = dict(vocab_size=4096, dim=256, dim_attn=256, dim_ffn=512, num_heads=8, num_layers=2)
    sd = jt5.init_random_t5_state_dict(jt5.T5Config(**cfg_kw), seed=1)
    tsd = tt5.init_random_t5_state_dict(tt5.T5Config(**cfg_kw), seed=1)
    np.testing.assert_array_equal(sd["blocks.1.ffn.fc2.weight"], tsd["blocks.1.ffn.fc2.weight"])
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 4096, (2, 64)).astype(np.int32)
    mask = np.zeros((2, 64), np.int32)
    mask[0, :20], mask[1, :45] = 1, 1
    ref = jt5.t5_encode(jt5.load_t5_params(sd, jt5.T5Config(**cfg_kw)), jnp.asarray(ids), jnp.asarray(mask),
                        jt5.T5Config(**cfg_kw))
    out = tt5.t5_encode(tt5.load_t5_params(tsd, tt5.T5Config(**cfg_kw)), torch.from_numpy(ids),
                        torch.from_numpy(mask), tt5.T5Config(**cfg_kw))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 64, 256)
    assert float(out[0, 20:].abs().max()) == 0.0
    assert _rel(out.float().numpy(), np.asarray(ref, np.float32)) < 1e-2


def test_relative_position_buckets_identical():
    np.testing.assert_array_equal(jt5.relative_position_buckets(512, 512), tt5.relative_position_buckets(512, 512))


SMALL = dict(dim=16, z_dim=16, dim_mult=(1, 2, 2, 2), num_res_blocks=1)


@pytest.fixture(scope="module")
def vae_sd():
    sd = jvae.init_random_vae_state_dict(jvae.WanVAEConfig(**SMALL), seed=2)
    tsd = tvae.init_random_vae_state_dict(tvae.WanVAEConfig(**SMALL), seed=2)
    np.testing.assert_array_equal(sd["decoder.head.2.weight"], tsd["decoder.head.2.weight"])
    return sd


def _jax_decode(fn, params, z, cfg, **kw):
    """One jitted program for the JAX decode (eager dispatch of every conv
    is ~5x slower on the CPU); string layer tags stay static."""
    import jax

    flat, treedef = jax.tree_util.tree_flatten(params, is_leaf=lambda x: isinstance(x, str))
    idx = [i for i, leaf in enumerate(flat) if hasattr(leaf, "shape")]

    @jax.jit
    def run(z, *arrs):
        leaves = list(flat)
        for i, a in zip(idx, arrs):
            leaves[i] = a
        return fn(jax.tree_util.tree_unflatten(treedef, leaves), z, cfg, **kw)

    return run(z, *[flat[i] for i in idx])


def _decode_pair(sd, z, tiled, **kw):
    jp = jvae.load_wan_vae_params(sd, jvae.WanVAEConfig(**SMALL))
    tp = tvae.load_wan_vae_params(sd, tvae.WanVAEConfig(**SMALL))
    jf = jvae.vae_decode_tiled if tiled else jvae.vae_decode
    tf = tvae.vae_decode_tiled if tiled else tvae.vae_decode
    ref = np.asarray(_jax_decode(jf, jp, jnp.asarray(z), jvae.WanVAEConfig(**SMALL), **kw), np.float32)
    out = tf(tp, torch.from_numpy(z), tvae.WanVAEConfig(**SMALL), **kw).numpy()
    return ref, out


@pytest.mark.parametrize("t,chunk", [(1, 4), (4, 4), (5, 2)])
def test_vae_decode_matches_jax(vae_sd, t, chunk):
    """Causal-cache stream over 1, 3 and 4 later latent frames (chunks of
    3, 2): fp32 convolutions on both sides. Bar: relative L2 1e-4 (fp32
    summation order in the convolutions)."""
    z = np.random.default_rng(t).standard_normal((1, t, 6, 8, 16)).astype(np.float32)
    ref, out = _decode_pair(vae_sd, z, False, chunk=chunk)
    assert out.shape == ref.shape == (1, (t - 1) * 4 + 1, 48, 64, 3)
    assert _rel(out, ref) < 1e-4, _rel(out, ref)


def test_vae_decode_tiled_matches_jax(vae_sd):
    """Two tile rows and columns with blended overlaps (tile 8, stride 6
    latents); same bar as the untiled decode."""
    z = np.random.default_rng(9).standard_normal((1, 2, 12, 10, 16)).astype(np.float32)
    ref, out = _decode_pair(vae_sd, z, True, tile_latent=8, stride_latent=6, scale=False)
    assert out.shape == ref.shape == (1, 5, 96, 80, 3)
    assert _rel(out, ref) < 1e-4, _rel(out, ref)
