"""The rest of the port's multi-GPU layer on the CPU, in gloo worlds
(``tests/_torch_dist_ranks.py``; the ranks import no JAX):

- the CogVideoX and HunyuanVideo t2v Ulysses forwards on {"sp": 2} against
  the JAX ``cog_forward_sharded`` / ``hunyuan_forward_sharded`` on the same
  mesh (relative L2 1e-2, the whole-model bar of ROADMAP.md Queue 3 a;
  measured 2.2e-3 and 3.8e-3);
- the parallel VAE, 1-D ({"sp": 2}) and 2-D ({"sp": 2, "tp": 2}), against the
  algorithm's definition run serially by the port (each halo chunk decoded,
  trimmed and concatenated, as ``tests/test_vae_parallel.py`` does; atol
  2e-4, rtol 1e-3, its bar), and one halo chunk's decode against the JAX
  ``vae_decode`` on the same chunk (relative L2 1e-4, fp32 convolutions);
  the JAX ``parallel_vae_decode`` itself is not run here (its own test file
  takes minutes);
- TaylorSeer, Ada and Tea denoises (UniPC, CFG at 5) on {"dp": 2, "sp": 2}
  against the port's single-device runs (rtol 2e-2, atol 2e-2, the bar of
  ``test_parallel.py::test_taylor_caching_with_mesh_matches_single_device``);
- ``lightx2v_tpu_torch.infer`` in a 2-rank world on a shrunk
  ``configs/dist_infer/wan_t2v_dist_ulysses.json`` (tiny arch, synthetic
  weights, 2 UniPC steps, {"dp": 1, "sp": 2}) against the port's
  single-device runner on the same config without ``mesh_shape`` (latents
  within relative L2 1e-2; measured 0), only rank 0 saving the video;
- the refusals that stay.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as R
from lightx2v_tpu.models.cogvideox import model as jcog
from lightx2v_tpu.models.cogvideox.sharded import cog_forward_sharded
from lightx2v_tpu.models.hunyuan import config as jhc
from lightx2v_tpu.models.hunyuan import model as jhm
from lightx2v_tpu.models.hunyuan import weights as jhw
from lightx2v_tpu.models.hunyuan.sharded import hunyuan_forward_sharded
from lightx2v_tpu.parallel.mesh import build_mesh
from lightx2v_tpu.vae import wan_vae as jvae
from lightx2v_tpu_torch.parallel.vae_parallel import halo_chunk, trim
from lightx2v_tpu_torch.vae import wan_vae as tvae

DIST_JSON = "configs/dist_infer/wan_t2v_dist_ulysses.json"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def joint(tmp_path_factory):
    return R.spawn(R.world_joint_streams, 2, tmp_path_factory.mktemp("joint"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return R.spawn(R.world_four_ranks, 4, tmp_path_factory.mktemp("four"))


def test_cog_ulysses_vs_jax(joint):
    """Ulysses over CogVideoX's joint [text; video] stream (rotated to
    [video; text] around the all-to-all), CFG's batch of 2 whole on both
    ranks."""
    arch = jcog.CogArch(**R.COG)
    params = jcog.load_cog_params(jcog.init_random_cog_state_dict(arch, seed=0, scale=0.05), arch)
    lat, t, ctx = (jnp.asarray(a) for a in R.cog_inputs())
    cos, sin = (jnp.asarray(a) for a in jcog.build_cog_rope(arch, 1, 2, 4))
    mesh = build_mesh({"sp": 2})
    fwd = jax.jit(lambda p, la: cog_forward_sharded(p, la, t, ctx, cos, sin, arch, mesh, attn_type="xla"))
    ref = np.asarray(fwd(params, lat.astype(jnp.bfloat16)), np.float32)
    for r in joint:
        assert r["cog"].shape == ref.shape == (2, 16, 2, 4, 8)
        assert _rel(r["cog"], ref) < 1e-2, _rel(r["cog"], ref)


def test_hunyuan_ulysses_vs_jax(joint):
    """Ulysses over HunyuanVideo's [image; text] stream with 7 of 12 text
    tokens valid: the joint attention masked at the global kv_len 23."""
    arch = jhc.HunyuanArch(**R.HY)
    params = jhw.load_hunyuan_params(jhw.init_random_hunyuan_state_dict(arch, seed=0, scale=0.05), arch)
    lat, t, ts, mask, ts2 = (jnp.asarray(a) for a in R.hunyuan_inputs())
    cos, sin = (jnp.asarray(a) for a in jhm.build_hunyuan_rope(arch, 2, 2, 4))
    mesh = build_mesh({"sp": 2})
    fwd = jax.jit(lambda p, la: hunyuan_forward_sharded(p, la, t, ts, mask, ts2, cos, sin, arch, mesh,
                                                        guidance=jnp.asarray([6000.0]), attn_type="xla"))
    ref = np.asarray(fwd(params, lat), np.float32)
    for r in joint:
        assert r["hunyuan"].shape == ref.shape == (1, 4, 2, 4, 8)
        assert _rel(r["hunyuan"], ref) < 1e-2, _rel(r["hunyuan"], ref)


@pytest.fixture(scope="module")
def vae():
    cfg = tvae.WanVAEConfig(**R.VAE)
    sd = tvae.init_random_vae_state_dict(cfg, seed=2)
    return cfg, sd, tvae.load_wan_vae_params(sd, cfg)


def _serial_halo_decode(params, cfg, z, n_w, n_h=1):
    """The algorithm's definition on one process: each (row, column) halo
    chunk decoded, trimmed, and the chunks concatenated."""
    rows = []
    for i_h in range(n_h):
        cols = [trim(tvae.vae_decode(params, halo_chunk(z, i_w, n_w, i_h, n_h), cfg), n_h > 1)
                for i_w in range(n_w)]
        rows.append(torch.cat(cols, dim=3))
    return torch.cat(rows, dim=2).numpy()


@pytest.mark.parametrize("two_d", [False, True], ids=["1d_sp2", "2d_sp2_tp2"])
def test_parallel_vae_vs_serial_algorithm(vae, joint, four, two_d):
    """W over sp (and H over tp where tp divides it), a 1-latent halo zero
    at the true edges, 8 pixels trimmed, all-gathered: every rank returns the
    serial run of the same chunks."""
    cfg, _, params = vae
    z = torch.from_numpy(R.vae_latents())
    want = _serial_halo_decode(params, cfg, z, 2, 2 if two_d else 1)
    for r in four if two_d else joint:
        got = r["vae_2d" if two_d else "vae_1d"]
        assert got.shape == want.shape == (1, 9, 64, 64, 3)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_vae_halo_chunk_vs_jax(vae):
    """One rank's chunk (column 1 of 2, with its halo) decoded by the port
    and by the JAX ``vae_decode``."""
    cfg, sd, params = vae
    zc = halo_chunk(torch.from_numpy(R.vae_latents()), 1, 2)
    assert zc.shape == (1, 3, 8, 6, 16)
    jcfg = jvae.WanVAEConfig(**R.VAE)
    jp = jvae.load_wan_vae_params(sd, jcfg)
    flat, treedef = jax.tree_util.tree_flatten(jp, is_leaf=lambda x: isinstance(x, str))
    idx = [i for i, leaf in enumerate(flat) if hasattr(leaf, "shape")]

    @jax.jit
    def run(z, *arrs):  # one program: eager dispatch of every conv is slow on the CPU
        leaves = list(flat)
        for i, a in zip(idx, arrs):
            leaves[i] = a
        return jvae.vae_decode(jax.tree_util.tree_unflatten(treedef, leaves), z, jcfg)

    ref = np.asarray(run(jnp.asarray(zc.numpy()), *[flat[i] for i in idx]), np.float32)
    out = tvae.vae_decode(params, zc, cfg).numpy()
    assert _rel(out, ref) < 1e-4, _rel(out, ref)


@pytest.mark.parametrize("mode", ["TaylorSeer", "Ada", "Tea"])
def test_caching_with_mesh_matches_single_device(four, mode):
    """The caching state on each rank's (dp, sp) shard (TaylorSeer's
    per-module caches, Ada's residual with its metric read from the gathered
    recording, Tea's residual with one decision for the CFG pair): the cond
    and uncond rows on different dp ranks, 16 tokens over sp, the guidance
    combined after the gather; every rank holds the same latents."""
    ref = R.cached_denoise(mode).numpy()
    for r in four:
        np.testing.assert_allclose(r[mode], ref, rtol=2e-2, atol=2e-2)


def test_infer_two_ranks_vs_single_device(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    lightx2v_tpu_torch.infer`` as its two ranks run it (torchrun's
    variables, a file rendezvous), on the dist config cut to the tiny arch,
    2 steps and {"dp": 1, "sp": 2} with its parallel VAE, against the port's
    single-device runner on the same config without ``mesh_shape``. The
    prompts are empty: the synthetic tokenizer hashes words with Python's
    per-process salted ``hash()``, so this process would tokenize a word
    otherwise than the ranks (which take rank 0's encoder outputs)."""
    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.utils.config import set_config

    tiny = dict(dim=64, ffn_dim=96, num_heads=4, num_layers=2, text_dim=256, freq_dim=32, infer_steps=2,
                target_video_length=5, target_height=64, target_width=64, text_len=16)
    cfg_path = R.write_config(tmp_path / "dist.json", DIST_JSON, mesh_shape={"dp": 1, "sp": 2}, **tiny)
    argv = ["--model_cls", "wan2.1", "--config_json", cfg_path, "--synthetic_weights", "--device", "cpu",
            "--save_video_path", str(tmp_path / "out.mp4"),
            "--save_latents_path", str(tmp_path / "dist.npy")]
    ranks = R.spawn(R.infer_rank, 2, tmp_path, argv, str(tmp_path), init=False)
    assert [int(r["saves"]) for r in ranks] == [1, 0]
    assert (tmp_path / "out.mp4.npy").exists()
    single = set_config(dict(model_cls="wan2.1", config_json=cfg_path, synthetic_weights=True, device="cpu",
                             save_latents_path=str(tmp_path / "single.npy")))
    single["mesh_shape"] = None
    infer.init_runner(single).run_pipeline(save_video=False)
    got, want = np.load(tmp_path / "dist.npy"), np.load(tmp_path / "single.npy")
    assert got.shape == want.shape == (16, 2, 8, 8)
    assert _rel(got, want) < 1e-2, _rel(got, want)


def _tiny(**kw):
    from lightx2v_tpu_torch.utils.config import set_config

    base = dict(model_cls="wan2.1_distill", synthetic_weights=True, device="cpu", target_video_length=5,
                target_height=32, target_width=32, dim=64, ffn_dim=96, num_heads=4, num_layers=2, text_dim=256,
                freq_dim=32, text_len=16)
    return set_config({**base, **kw})


@pytest.mark.parametrize("extra,err,match", [
    (dict(cpu_offload=True, mesh_shape={"sp": 1}), NotImplementedError, "difference az"),
    (dict(changing_resolution=True, mesh_shape={"sp": 1}), NotImplementedError, "difference az"),
    (dict(mesh_shape={"dp": 2, "sp": 4}), ValueError, "needs 8 devices"),
    (dict(model_cls="hunyuan", task="i2v", mesh_shape={"sp": 1}), NotImplementedError, "difference ba"),
], ids=["offload", "changing_resolution", "larger_than_world", "hunyuan_i2v"])
def test_mesh_refusals(extra, err, match):
    """What the port does not run over a mesh raises before any weight is
    made: offload and changing resolution with ``mesh_shape`` (the JAX
    runner runs them on one device; N identical runs on N ranks), a mesh
    larger than the world, HunyuanVideo i2v (token replace needs global
    token indices)."""
    from lightx2v_tpu_torch import infer

    with pytest.raises(err, match=match):
        infer.init_runner(_tiny(**extra))


def test_serving_over_a_mesh_refused(monkeypatch, tmp_path):
    """The server runs a mesh_shape only in a world of one process: with
    more, rank 0 would have to broadcast each task to its group."""
    from lightx2v_tpu_torch.server import service

    monkeypatch.setattr(service, "rank_and_world", lambda: (0, 2))
    with pytest.raises(NotImplementedError, match="serving over a mesh.*item 14"):
        service.VideoGenerationService(lambda: None, output_root=str(tmp_path),
                                       server_config={"mesh_shape": {"sp": 2}})
