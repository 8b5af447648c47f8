"""``vae_int8`` on the CPU, port vs JAX package: the decoder's int8
weight codes and scales (bit for bit), the int8 decode against the JAX
``quantize_vae_decoder_int8`` + ``vae_decode`` (untiled and tiled), both
within the JAX package's quality bound of the float decode, and the
runner's int8 decoder.

The small synthetic VAE (dim 16, z 16). The port sums the int8 codes'
products in fp64 on the CPU (equal to the JAX int32 sums). Bars: the codes
equal; the decodes relative L2 5e-2 (the float convolutions between the
int8 ones sum in another order, so an activation code at a rounding tie
can flip; measured 3.0e-2), and the untiled int8 decode of each package
within 15 dB SNR of its float decode (``tests/test_vae.py``'s bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.vae import wan_vae as jvae
from lightx2v_tpu_torch.vae import wan_vae as tvae

SMALL = dict(dim=16, z_dim=16, dim_mult=(1, 2, 2, 2), num_res_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vaes():
    sd = tvae.init_random_vae_state_dict(tvae.WanVAEConfig(**SMALL), seed=2)
    jp = jvae.load_wan_vae_params(sd, jvae.WanVAEConfig(**SMALL))
    tp = tvae.load_wan_vae_params(sd, tvae.WanVAEConfig(**SMALL))
    return jp, tp, jvae.quantize_vae_decoder_int8(jp), tvae.quantize_vae_decoder_int8(tp)


def _jax_decode(fn, params, z, **kw):
    """One jitted program for the JAX decode (string leaves static)."""
    flat, treedef = jax.tree_util.tree_flatten(params, is_leaf=lambda x: isinstance(x, str))
    idx = [i for i, leaf in enumerate(flat) if hasattr(leaf, "shape")]

    @jax.jit
    def run(z, *arrs):
        leaves = list(flat)
        for i, a in zip(idx, arrs):
            leaves[i] = a
        return fn(jax.tree_util.tree_unflatten(treedef, leaves), z, jvae.WanVAEConfig(**SMALL), **kw)

    return np.asarray(run(jnp.asarray(z), *[flat[i] for i in idx]), np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _snr(ref, got):
    return 20 * np.log10(np.sqrt((ref ** 2).mean()) / max(np.sqrt(((ref - got) ** 2).mean()), 1e-20))


def _convs(tree, path=""):
    if isinstance(tree, dict):
        if "w" in tree and hasattr(tree["w"], "shape") and len(tree["w"].shape) >= 4:
            yield path, tree
        for k, v in tree.items():
            yield from _convs(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _convs(v, f"{path}.{i}")


def test_quantizer_vs_jax(vaes):
    """Every decoder conv but head_conv, to_qkv and proj is int8, with the
    JAX codes and scales; the encoder and the post-quant conv stay fp32;
    quantizing twice changes nothing."""
    _, tp, jq, tq = vaes
    jc, tc = dict(_convs(jq["decoder"])), dict(_convs(tq["decoder"]))
    assert set(jc) == set(tc)
    n_int8 = 0
    for k, t in tc.items():
        j = jc[k]
        keep = k.rsplit(".", 1)[-1] in ("head_conv", "to_qkv", "proj")
        assert ("w_scale" in t) == ("w_scale" in j) == (not keep), k
        if keep:
            continue
        n_int8 += 1
        jw, tw = np.asarray(j["w"]), t["w"].numpy()
        if jw.ndim == 4:  # a 2D conv: HWIO there, (O, I, 1, kh, kw) here
            tw = tw[:, :, 0]
        assert t["w"].dtype == torch.int8 and np.array_equal(tw, np.moveaxis(jw, [-1, -2], [0, 1])), k
        assert np.array_equal(t["w_scale"].numpy(), np.asarray(j["w_scale"])), k
    assert n_int8 > 10
    assert tq["encoder"] is tp["encoder"] and tq["conv2"]["w"].dtype == torch.float32
    again = tvae.quantize_vae_decoder_int8(tq)
    assert torch.equal(again["decoder"]["conv1"]["w"], tq["decoder"]["conv1"]["w"])


@pytest.mark.parametrize("tiled", [False, True])
def test_int8_decode_vs_jax(vaes, tiled):
    jp, tp, jq, tq = vaes
    if tiled:
        z = np.random.default_rng(9).standard_normal((1, 2, 12, 10, 16)).astype(np.float32)
        kw = dict(scale=False, tile_latent=8, stride_latent=6)
        jf, tf, shape = jvae.vae_decode_tiled, tvae.vae_decode_tiled, (1, 5, 96, 80, 3)
    else:
        z = np.random.default_rng(7).standard_normal((1, 3, 8, 8, 16)).astype(np.float32)
        kw = dict(scale=False, chunk=2)
        jf, tf, shape = jvae.vae_decode, tvae.vae_decode, (1, 9, 64, 64, 3)
    ref = _jax_decode(jf, jq, z, **kw)
    out = tf(tq, torch.from_numpy(z), tvae.WanVAEConfig(**SMALL), **kw).numpy()
    assert out.shape == ref.shape == shape and np.isfinite(out).all()
    assert _rel(out, ref) < 5e-2, _rel(out, ref)
    if tiled:  # the tiles run the untiled decode; its quality is checked below
        return
    j_float = _jax_decode(jf, jp, z, **kw)
    t_float = tf(tp, torch.from_numpy(z), tvae.WanVAEConfig(**SMALL), **kw).numpy()
    assert _snr(j_float, ref) > 15.0 and _snr(t_float, out) > 15.0, (_snr(j_float, ref), _snr(t_float, out))


def test_runner_vae_int8():
    """``vae_int8`` quantizes the runner's decoder (its encoder is dropped
    for t2v) and the tiled decode runs it."""
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    cfg = dict(model_cls="wan2.1_distill", task="t2v", synthetic_weights=True, device="cpu", enable_cfg=False,
               target_video_length=9, target_height=64, target_width=96, denoising_step_list=[1000], sample_shift=5,
               prompt="a red panda", vae_int8=True, use_tiling_vae=True)
    r = tinfer.init_runner(tset(cfg))
    assert r.vae["decoder"]["conv1"]["w"].dtype == torch.int8 and "w_scale" not in r.vae["decoder"]["head_conv"]
    frames = r.run_pipeline(save_video=False)
    assert frames.shape == (9, 64, 96, 3) and np.isfinite(frames).all()
