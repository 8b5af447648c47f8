"""Port Wan VAE encoder (the i2v conditioning) vs the JAX package on its
CPU path: the synthetic runner's small VAE (dim 16, one res block a stage)
from one numpy state dict, fp32 convolutions on both sides. Bar: relative
L2 1e-4 (fp32 summation order), as the decoder's (``test_torch_t5_vae.py``;
measured 4.5e-8 untiled, 2.5e-7 tiled); chunks of 1, 2 and 4 latent frames
agree (measured: identical)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.vae import wan_vae as jvae
from lightx2v_tpu_torch.vae import wan_vae as tvae

SMALL_VAE = dict(dim=16, z_dim=16, dim_mult=(1, 2, 2, 2), num_res_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def jit_vae(fn, params, x, cfg, **kw):
    """One jitted program for a JAX VAE call (eager, it dispatches every
    conv on its own); string layer tags stay static."""
    flat, treedef = jax.tree_util.tree_flatten(params, is_leaf=lambda x: isinstance(x, str))
    idx = [i for i, leaf in enumerate(flat) if hasattr(leaf, "shape")]

    @jax.jit
    def run(x, *arrs):
        leaves = list(flat)
        for i, a in zip(idx, arrs):
            leaves[i] = a
        return fn(jax.tree_util.tree_unflatten(treedef, leaves), x, cfg, **kw)

    return np.asarray(run(x, *[flat[i] for i in idx]), np.float32)


@pytest.fixture(scope="module")
def vae_pair():
    sd = jvae.init_random_vae_state_dict(jvae.WanVAEConfig(**SMALL_VAE), seed=2)
    return (jvae.load_wan_vae_params(sd, jvae.WanVAEConfig(**SMALL_VAE)),
            tvae.load_wan_vae_params(sd, tvae.WanVAEConfig(**SMALL_VAE)))


def test_vae_encode_matches_jax(vae_pair):
    """17 frames of 64x96 at chunks of 1, 2 and 4 latent frames."""
    jp, tp = vae_pair
    x = np.random.default_rng(0).uniform(-1, 1, (1, 17, 64, 96, 3)).astype(np.float32)
    ref = jit_vae(jvae.vae_encode, jp, jnp.asarray(x), jvae.WanVAEConfig(**SMALL_VAE))
    outs = [tvae.vae_encode(tp, torch.from_numpy(x), tvae.WanVAEConfig(**SMALL_VAE), chunk=c).numpy()
            for c in (1, 2, 4)]
    for out in outs:
        assert out.shape == ref.shape == (1, 5, 8, 12, 16) and out.dtype == np.float32
        assert _rel(out, ref) < 1e-4, _rel(out, ref)
    assert _rel(outs[0], outs[2]) < 1e-5
    with pytest.raises(ValueError, match="4n \\+ 1"):
        tvae.vae_encode(tp, torch.from_numpy(x[:, :3]), tvae.WanVAEConfig(**SMALL_VAE))


def test_vae_encode_tiled_matches_jax(vae_pair):
    """Two tile rows and columns with blended overlaps (64 px tiles at a 48
    px stride), unscaled; the same bar."""
    jp, tp = vae_pair
    x = np.random.default_rng(1).uniform(-1, 1, (1, 5, 96, 80, 3)).astype(np.float32)
    kw = dict(tile_px=64, stride_px=48, scale=False)
    ref = jit_vae(jvae.vae_encode_tiled, jp, jnp.asarray(x), jvae.WanVAEConfig(**SMALL_VAE), **kw)
    out = tvae.vae_encode_tiled(tp, torch.from_numpy(x), tvae.WanVAEConfig(**SMALL_VAE), **kw).numpy()
    assert out.shape == ref.shape == (1, 2, 12, 10, 16)
    assert _rel(out, ref) < 1e-4, _rel(out, ref)
