"""The offload tiers on the CPU, port vs JAX package: the host-RAM tier's
streamed forward (the resident forward on a ``BlockStreamer`` over packed
host blocks) against ``make_streamed_forward`` (t2v and i2v), the disk
tier's runner against the JAX lazy runner on a blocks checkpoint that the
JAX converter wrote (int8, and bf16 with ``rope_fused``: ROADMAP difference
ab), the prefetcher's budget, the refusals of offload with TaylorWS or
changing resolution (difference ac), and small ``configs/bench/
lightx2v_6_distill.json`` and ``lightx2v_6.json`` runners (int8 from the
disk tier, the tiny VAE) against the JAX runner. Caching under offload is in
``test_torch_offload_caching.py``.

DiT: dim 256, ffn 512, 2 heads of 128, 2 layers, as the module tests.
Bars: the streamed forward equals the port's resident forward bit for bit
(the same ops on the same weights) and the JAX streamed forward at the
whole-model bar, relative L2 1e-2; the lazy runners' latents 1e-2 bf16 and
3e-2 int8 (the JAX CPU int8 path quantizes differently, difference a), as
``test_torch_checkpoint.py``; the lightx2v_6 runners' frames 1e-4 on the
same latents (the tiny VAE, as ``test_torch_tiny_vae.py``). On a CUDA device the same classes pin the
host buffers and copy on a stream of their own (``test_torch_cuda.py``)."""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.models.wan import config as jcfg
from lightx2v_tpu.models.wan import streaming as jstream
from lightx2v_tpu.models.wan import weights as jweights
from lightx2v_tpu.models.wan.pipeline import rope_for_shape as j_rope_for_shape
from lightx2v_tpu.tools import convert as jconv
from lightx2v_tpu_torch.models.wan import config as tcfg
from lightx2v_tpu_torch.models.wan import lazy_offload as tlazy
from lightx2v_tpu_torch.models.wan import model as tmodel
from lightx2v_tpu_torch.models.wan import streaming as tstream
from lightx2v_tpu_torch.models.wan import weights as tweights
from lightx2v_tpu_torch.models.wan.pipeline import rope_for_shape as t_rope_for_shape
from lightx2v_tpu_torch.tools import convert as tconv

TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)
SHAPE = (16, 2, 4, 6)
INT8 = "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops: one torch thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _resident(store):
    """Every block of an offload store as its own copy, built from the
    store's host buffers (``read_block`` for the disk tier)."""

    def host_buf(i):
        if isinstance(store, tstream.HostBlocks):
            return store.fetch(i).clone()
        buf = torch.empty(store.layout.nbytes, dtype=torch.uint8)
        store.read_block(i, buf)
        return buf

    return [store.block(i, store.layout.views(host_buf(i))) for i in range(store.num_blocks)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("task", ["t2v", "i2v"])
def test_streamed_forward_vs_jax(task):
    kw = dict(TINY, task=task, **(dict(in_dim=36) if task == "i2v" else {}))
    jarch, tarch = jcfg.WanArch(**kw), tcfg.WanArch(**kw)
    wd = jweights.init_random_weight_dict(jarch, seed=0)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, *SHAPE)).astype(np.float32)
    ctx = (rng.standard_normal((1, 16, 256)) * 0.5).astype(np.float32)
    cond = {}
    if task == "i2v":
        cond = dict(y=rng.standard_normal((1, 20, *SHAPE[1:])).astype(np.float32),
                    clip_fea=rng.standard_normal((1, 257, 1280)).astype(np.float32))
    jc, js, _ = j_rope_for_shape(jarch, SHAPE)
    tc, ts, _ = t_rope_for_shape(tarch, SHAPE)
    jfwd = jstream.make_streamed_forward(jarch)
    ref = np.asarray(jfwd(jstream.split_blocks_to_host(jweights.load_wan_params(wd, jarch)), jnp.asarray(lat),
                          jnp.asarray([750.0]), jnp.asarray(ctx, jnp.bfloat16), jc, js,
                          **{k: jnp.asarray(v) for k, v in cond.items()}))
    tp = tweights.load_wan_params(wd, tarch)
    targs = (torch.from_numpy(lat), torch.tensor([750.0]), torch.from_numpy(ctx).to(torch.bfloat16), tc, ts)
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    resident = tmodel.wan_forward(tp, *targs, tarch, **tcond)
    host = tstream.HostBlocks(tp["blocks"], pin=False)
    out = tmodel.wan_forward(dict(tp, blocks=tstream.BlockStreamer(host, "cpu")), *targs, tarch, **tcond)
    assert torch.equal(out, resident)
    assert out.shape == ref.shape == (1, 16, *SHAPE[1:]) and _rel(out.numpy(), ref) < 1e-2, _rel(out.numpy(), ref)


def test_host_blocks_layout_and_streamer_counters():
    """Every tensor of a packed block starts on a 256-byte boundary of its
    one buffer; a pass copies each block once (the counters)."""
    arch = tcfg.WanArch(**TINY)
    params = tweights.load_wan_params(tconv.quantize_model(tweights.init_random_weight_dict(arch, seed=0), "int8"),
                                      arch)
    first = params["blocks"][0]
    host = tstream.HostBlocks(params["blocks"], pin=False)
    assert host.num_blocks == 2 and len(host.bufs) == 2 and all(o % tstream.ALIGN == 0 for o in host.layout.offsets)
    views = host.layout.views(host.bufs[0])
    assert views["ffn.0.w"].dtype == torch.int8 and torch.equal(host.block(0, views)["ffn"]["0"]["w"],
                                                               first["ffn"]["0"]["w"])
    streamer = tstream.BlockStreamer(host, "cpu")
    for blk, want in zip(streamer, _resident(host)):
        assert torch.equal(blk["self_attn"]["q"]["w_scale"], want["self_attn"]["q"]["w_scale"])
    stats = streamer.take_stats()
    assert stats["h2d_bytes"] == 2 * host.layout.nbytes and stats["stall_ms"] == 0
    assert streamer.take_stats()["h2d_bytes"] == 0


def test_host_blocks_pack_one_block_at_a_time():
    """Built by ``load_wan_params(iter_blocks=True)``, each block is packed
    and let go before the next is built (on a card: one block resident at
    load, never the stack), and the packed blocks equal the resident ones."""
    import weakref

    arch = tcfg.WanArch(**dict(TINY, num_layers=4))
    wd = tweights.init_random_weight_dict(arch, seed=0)
    alive = []

    def blocks():
        for blk in tweights.load_wan_params(wd, arch, iter_blocks=True)["blocks"]:
            assert not any(r() is not None for r in alive)  # the blocks packed so far are gone
            alive.append(weakref.ref(blk["ffn"]["0"]["w"]))
            yield blk
            blk = None

    host = tstream.HostBlocks(blocks(), pin=False)
    assert host.num_blocks == 4 and not any(r() is not None for r in alive)
    for got, want in zip(_resident(host), tweights.load_wan_params(wd, arch)["blocks"]):
        assert len(tstream._flatten(got)) == len(tstream._flatten(want)) > 0
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tstream._flatten(got), tstream._flatten(want)))


RUN = dict(model_cls="wan2.1_distill", task="t2v", synthetic_weights=True, prompt="a red panda", seed=42,
           enable_cfg=False, target_video_length=9, target_height=64, target_width=96, sample_shift=5,
           latent_init="torch", denoising_step_list=[1000, 500], text_len=64, self_attn_1_type="flash_attn3",
           cross_attn_1_type="flash_attn3", cpu_offload=True, lazy_load=True, num_disk_workers=2,
           max_memory=0.001, **TINY)


@pytest.fixture(scope="module")
def blocks_ckpts(tmp_path_factory):
    """The tiny DiT in the blocks layout, written by the JAX converter: bf16
    and int8."""
    root = tmp_path_factory.mktemp("blocks")
    wd = jweights.init_random_weight_dict(jcfg.WanArch(**TINY), seed=0)
    jconv.save_quantized(dict(wd), str(root / "bf16"), layout="blocks")
    jconv.save_quantized(jconv.quantize_model(wd, "int8"), str(root / "int8"), layout="blocks", scheme="int8")
    return root


@pytest.mark.parametrize("kind", ["int8", "bf16_rope_fused"])
def test_lazy_runner_vs_jax(blocks_ckpts, kind):
    """The disk tier's runner against the JAX lazy runner. With
    ``rope_fused`` the JAX runner turns fused RoPE off (its block reader
    does not permute q/k); the port permutes each block as it is read and
    keeps the fused path."""
    from lightx2v_tpu.runners.wan_runner import WanDistillRunner as JRunner
    from lightx2v_tpu.utils.config import set_config as jset
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    cfg = dict(RUN, dit_quantized_ckpt=str(blocks_ckpts / kind.split("_")[0]))
    if kind == "int8":
        cfg["mm_config"] = {"mm_type": INT8}
    else:
        cfg["rope_fused"] = True
    jr = JRunner(jset(dict(cfg)))
    tr = tinfer.init_runner(tset(dict(cfg, device="cpu")))
    assert isinstance(tr.model["blocks"], tlazy.LazyBlockStore) and tr.arch.rope_fused == (kind != "int8")
    assert jr.arch.rope_fused is False
    j_enc, t_enc = jr.run_input_encoder(), tr.run_input_encoder()
    shape = tuple(tr.set_target_shape())
    rng, noises = jax.random.PRNGKey(cfg["seed"] + 1), []
    for _ in cfg["denoising_step_list"]:
        rng, sub = jax.random.split(rng)
        noises.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    lj, lt = np.asarray(jr.run_dit(j_enc)), tr.run_dit(t_enc, noises=noises).numpy()
    assert lt.shape == lj.shape == shape and np.isfinite(lt).all()
    bar = 3e-2 if kind == "int8" else 1e-2
    assert _rel(lt, lj) < bar, _rel(lt, lj)
    steps = tr.timings["offload"]
    assert len(steps) == 2 and all(st["disk_bytes"] > 0 and st["h2d_bytes"] > 0 for st in steps)


@pytest.mark.parametrize("name", ["lightx2v_6_distill", "lightx2v_6"])
def test_lightx2v_6_runner_vs_jax(blocks_ckpts, name):
    """The bench ladder's last rows at the tiny widths: the file's keys
    (int8 W8A8, cpu_offload + lazy_load with 2 disk workers and a 4 GB pool,
    RoPE in torch, the tiny VAE under use_tiling_vae) on the int8 blocks
    checkpoint; lightx2v_6_distill its 4-entry step list without CFG,
    lightx2v_6 UniPC with CFG at 5, cut to 2 of its 40 steps."""
    import json

    from lightx2v_tpu.runners.wan_runner import WanDistillRunner, WanRunner
    from lightx2v_tpu.utils.config import set_config as jset
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    with open(os.path.join(os.path.dirname(__file__), "..", "configs", "bench", f"{name}.json")) as f:
        cfg = json.load(f)
    distill = name.endswith("distill")
    cfg.update(model_cls="wan2.1_distill" if distill else "wan2.1", task="t2v", synthetic_weights=True,
               prompt="a red panda", negative_prompt="blurry", target_video_length=9, target_height=64,
               target_width=96, latent_init="torch", text_len=64, dit_quantized_ckpt=str(blocks_ckpts / "int8"),
               **TINY)
    if not distill:
        cfg["infer_steps"] = 2
    jr = (WanDistillRunner if distill else WanRunner)(jset(dict(cfg)))
    tr = tinfer.init_runner(tset(dict(cfg, device="cpu")))
    assert isinstance(tr.model["blocks"], tlazy.LazyBlockStore) and not tr.arch.rope_fused and tr.vae_cfg is None
    shape = tuple(tr.set_target_shape())
    noises = None
    if distill:
        rng, noises = jax.random.PRNGKey(cfg["seed"] + 1), []
        for _ in cfg["denoising_step_list"]:
            rng, sub = jax.random.split(rng)
            noises.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    lj, lt = np.asarray(jr.run_dit(jr.run_input_encoder())), tr.run_dit(tr.run_input_encoder(), noises=noises)
    assert lt.shape == lj.shape == shape and _rel(lt.numpy(), lj) < 3e-2, _rel(lt.numpy(), lj)
    steps = tr.timings["offload"]
    assert len(steps) == (4 if distill else 2) and all(st["disk_bytes"] > 0 for st in steps)
    fj, ft = jr.run_vae_decoder(jnp.asarray(lj)), tr.run_vae_decoder(torch.from_numpy(lj))
    assert ft.shape == fj.shape == (9, 64, 96, 3) and _rel(ft, fj) < 1e-4, _rel(ft, fj)


@pytest.fixture(scope="module")
def port_blocks(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_blocks")
    arch = tcfg.WanArch(**dict(TINY, num_layers=5))
    wd = tweights.init_random_weight_dict(arch, seed=2)
    tconv.save_quantized(tconv.quantize_model(wd, "int8"), str(root), layout="blocks", scheme="int8")
    return str(root), arch


def test_prefetcher_budget(port_blocks):
    """The staging pool holds ``max_host_bytes`` worth of blocks, never
    fewer than ``num_workers + 1``; a slow consumer never has more buffers
    out than the pool, and each block arrives whole."""
    path, arch = port_blocks
    store = tlazy.LazyBlockStore(path, arch)
    nb = store.layout.nbytes
    want = [b["ffn"]["2"]["w"] for b in _resident(store)]
    for budget, workers, n_bufs in ((int(3.5 * nb), 1, 3), (nb // 2, 2, 3), (None, 1, 4)):
        with tlazy.BlockPrefetcher(store, num_workers=workers, max_host_bytes=budget, pin=False) as pf:
            assert pf.num_buffers == n_bufs
            if budget is not None and budget >= (workers + 1) * nb:
                assert pf.num_buffers * nb <= budget
            pf.start_pass()
            pf.start_pass()
            deadline = time.monotonic() + 30
            while pf.peak_held < n_bufs and time.monotonic() < deadline:
                time.sleep(0.005)  # the workers read ahead until the pool is out, then wait
            time.sleep(0.05)
            assert pf.peak_held == n_bufs
            for i in list(range(5)) * 2:
                buf = pf.fetch(i)
                assert torch.equal(store.block(i, store.layout.views(buf))["ffn"]["2"]["w"], want[i])
                pf.release(i, None)
            assert pf.peak_held == n_bufs
            assert pf.pass_stats()["disk_bytes"] == 10 * sum(store.layout.sizes)


def test_prefetcher_stress(port_blocks, monkeypatch):
    """As many workers as the cores allow (the pool caps them there) and a
    short switch interval: every block of three passes arrives whole and in
    order, and close() ends the workers."""
    path, arch = port_blocks
    store = tlazy.LazyBlockStore(path, arch)
    want = [b["self_attn"]["q"]["w"] for b in _resident(store)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        monkeypatch.setattr(tlazy, "FETCH_TIMEOUT_S", 30.0)
        pf = tlazy.BlockPrefetcher(store, num_workers=64, max_host_bytes=None, pin=False)
        for _ in range(3):
            pf.start_pass()
            for i in range(5):
                buf = pf.fetch(i)
                assert torch.equal(store.block(i, store.layout.views(buf))["self_attn"]["q"]["w"], want[i])
                pf.release(i, None)
        pf.close()
    finally:
        sys.setswitchinterval(interval)
    assert len(pf._workers) == min(64, os.cpu_count() or 1) and not any(w.is_alive() for w in pf._workers)


def test_offload_refusals(port_blocks):
    """Under every offload key, changing resolution (the JAX runner runs it
    with resident weights) and TaylorWS (the JAX streamed forward runs it
    uncached) raise, naming difference ac; lazy_load needs a blocks-layout
    checkpoint; mesh_shape stays refused (item 14)."""
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    base = {k: v for k, v in RUN.items() if k not in ("lazy_load", "cpu_offload")}
    for key in ("cpu_offload", "weight_streaming", "lazy_load"):
        with pytest.raises(NotImplementedError, match="resident weights.*difference ac"):
            tinfer.init_runner(tset(dict(base, device="cpu", changing_resolution=True, **{key: True})))
        with pytest.raises(NotImplementedError, match="TaylorWS.*uncached.*difference ac"):
            tinfer.init_runner(tset(dict(base, device="cpu", feature_caching="TaylorWS", **{key: True})))
    with pytest.raises(ValueError, match="blocks-layout"):
        tinfer.init_runner(tset(dict(base, device="cpu", lazy_load=True)))
    with pytest.raises(NotImplementedError, match="item 14"):
        tinfer.init_runner(tset(dict(base, device="cpu", cpu_offload=True, mesh_shape={"sp": 2})))
