"""Feature caching under offload on the CPU, port vs JAX package: the
``wan2.1`` runner with Tea, TaylorSeer, Ada and Custom on the host-RAM tier
(``cpu_offload``) and the disk tier (``lazy_load`` from a blocks checkpoint
that the JAX converter wrote) against the JAX runner's streamed path
(``make_streamed_forward`` with its ``tea`` / ``taylor`` / ``ada`` state) on
the host-RAM tier, as ``tests/test_streaming.py`` drives it on the JAX side.

Each run holds a calc and a skip step; a skipped step copies no block to the
device and reads nothing from the disk (its counters are 0) but copies the
host-staged state in; a calc step copies every block. The skip counts equal
the JAX runner's.

Tiny arch: dim 256, ffn 512, 2 heads of 128, 2 layers, bf16 linears, 9
frames of 64x96 (48 tokens), UniPC from the same CPU torch latents. Bars:
latents relative L2 1e-2 without CFG, 2e-2 with CFG at 5 (as the resident
denoise loops of ``test_torch_caching.py``); the streamed Ada against the
port's resident Ada 1e-2 with the same calc steps (the resident path adds
its bf16 residual in x's dtype, the streamed one in fp32)."""

import numpy as np
import pytest
import torch

from lightx2v_tpu.models.wan import config as jcfg
from lightx2v_tpu.models.wan import weights as jweights
from lightx2v_tpu.tools import convert as jconv

TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)
LINEAR = [[1.0, 0.0], [1.0, 0.0]]  # poly(rel) = rel
RUN = dict(model_cls="wan2.1", task="t2v", synthetic_weights=True, prompt="a red panda", negative_prompt="blurry",
           seed=42, target_video_length=9, target_height=64, target_width=96, sample_shift=5, sample_guide_scale=5,
           latent_init="torch", text_len=64, self_attn_1_type="flash_attn3", cross_attn_1_type="flash_attn3", **TINY)
# mode -> (CFG, steps, keys): each holds a calc and a skip step
MODES = {
    "Tea": (True, 5, dict(coefficients=LINEAR, teacache_thresh=2.0)),  # C s s C C, one decision for both rows
    "TaylorSeer": (False, 4, dict(taylor_pattern=2)),  # C s C s: the second skip extrapolates with f1
    "Ada": (True, 5, {}),  # C C s s C: the codebook's skips
    "Custom": (False, 5, dict(coefficients=LINEAR, teacache_thresh=1.0)),  # C s C s C
}
STATS = {"Tea": "_tea_stats", "Custom": "_taylor_stats", "TaylorSeer": "_taylor_stats", "Ada": "_ada_stats"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _cfg(mode, **over):
    cfg_on, steps, keys = MODES[mode]
    return dict(RUN, enable_cfg=cfg_on, infer_steps=steps, feature_caching=mode, **keys, **over)


@pytest.fixture(scope="module")
def bf16_blocks(tmp_path_factory):
    """The synthetic runner's DiT (seed 0) in the blocks layout."""
    root = tmp_path_factory.mktemp("blocks") / "bf16"
    jconv.save_quantized(jweights.init_random_weight_dict(jcfg.WanArch(**TINY), seed=0), str(root), layout="blocks")
    return str(root)


@pytest.fixture(scope="module")
def jax_runs():
    """mode -> (latents, skipped steps) of the JAX runner's streamed path,
    made on first use."""
    from lightx2v_tpu.runners.wan_runner import WanRunner as JRunner
    from lightx2v_tpu.utils.config import set_config as jset

    cache = {}

    def get(mode):
        if mode not in cache:
            jr = JRunner(jset(_cfg(mode, cpu_offload=True)))
            lat = np.asarray(jr.run_dit(jr.run_input_encoder()))
            cache[mode] = lat, getattr(jr, STATS[mode])["skipped"]
        return cache[mode]

    return get


def _port_run(cfg):
    from lightx2v_tpu_torch import infer as tinfer
    from lightx2v_tpu_torch.utils.config import set_config as tset

    tr = tinfer.init_runner(tset(dict(cfg, device="cpu")))
    return tr, tr.run_dit(tr.run_input_encoder()).numpy()


@pytest.mark.parametrize("tier", ["host", "lazy"])
@pytest.mark.parametrize("mode", list(MODES))
def test_streamed_caching_vs_jax(jax_runs, bf16_blocks, mode, tier):
    from lightx2v_tpu_torch.models.wan.lazy_offload import LazyBlockStore
    from lightx2v_tpu_torch.models.wan.streaming import HostBlocks

    over = dict(cpu_offload=True)
    if tier == "lazy":
        over.update(lazy_load=True, dit_quantized_ckpt=bf16_blocks, num_disk_workers=2, max_memory=0.001)
    tr, lat = _port_run(_cfg(mode, **over))
    store = tr.model["blocks"]
    assert isinstance(store, LazyBlockStore if tier == "lazy" else HostBlocks)
    j_lat, j_skipped = jax_runs(mode)
    calc = tr.timings["calc_steps"]
    assert all(isinstance(c, bool) for c in calc) and any(calc) and not all(calc), calc
    assert calc.count(False) == j_skipped
    block_bytes = store.num_blocks * store.layout.nbytes
    for c, st in zip(calc, tr.timings["offload"]):
        assert st["h2d_bytes"] == (block_bytes if c else 0), (calc, st)
        # a skip step copies the staged state in, a calc step stages its own out
        assert st["cache_d2h_bytes" if c else "cache_h2d_bytes"] > 0, (calc, st)
        if tier == "lazy":
            assert (st["disk_bytes"] > 0) == c, (calc, st)
    bar = 2e-2 if MODES[mode][0] else 1e-2
    assert lat.shape == j_lat.shape == (16, 3, 8, 12) and _rel(lat, j_lat) < bar, _rel(lat, j_lat)


def test_streamed_ada_vs_resident():
    """The streamed Ada makes the resident Ada's decisions (one codebook on
    the same middle-block metric) and lands within 1e-2 of its latents."""
    res, lat_res = _port_run(_cfg("Ada"))
    stream, lat_stream = _port_run(_cfg("Ada", weight_streaming=True))
    assert stream.timings["calc_steps"] == res.timings["calc_steps"]
    assert _rel(lat_stream, lat_res) < 1e-2, _rel(lat_stream, lat_res)


def test_streamed_taylor_first_skip_replays_f0():
    """The first calc stores f1 = 0, so the first skip step adds f0 alone:
    in an fp32 cache, the calc step's whole-stack residual exactly."""
    from lightx2v_tpu_torch.models.wan.streaming import StreamedCache

    x_in = torch.randn(1, 48, 256, generator=torch.Generator().manual_seed(0))
    x_out = x_in + 0.1 * torch.randn(1, 48, 256, generator=torch.Generator().manual_seed(1))
    sc = StreamedCache("TaylorSeer", torch.float32)
    sc.stage(x_in, x_out, 0)
    assert torch.equal(sc.host["f1"], torch.zeros_like(x_in)) and torch.equal(sc.host["f0"], x_out - x_in)
    assert torch.equal(sc.replay(x_in, 3), x_in + (x_out - x_in))
    sc.stage(x_in, x_out + 1.0, 2)  # f1 = (r2 - r0) / 2 = 0.5
    assert torch.allclose(sc.host["f1"], torch.full_like(x_in, 0.5)) and sc.last_calc == 2
    e4m3 = StreamedCache("Custom", torch.float8_e4m3fn)
    e4m3.stage(x_in, x_in + 1000.0, 0)
    assert e4m3.host["f0"].dtype == torch.float8_e4m3fn and float(e4m3.host["f0"].float().max()) == 448.0
    stats = sc.take_stats()
    assert stats["cache_d2h_bytes"] == 4 * x_in.numel() * 4 and stats["cache_h2d_bytes"] == 3 * x_in.numel() * 4
