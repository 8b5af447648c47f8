"""The offline tools on the CPU, port vs JAX package: ``tools/psnr.py``,
``tools/validate_ckpt.py`` (the three-way key report and the forward) and
``tools/tune_sparge.py`` (the per-layer l1 table).

Tiny arch: dim 256, ffn 512, 2 heads of 128, 2 layers. Bars: PSNR values
equal to 1e-9 dB (the same float64 numpy arithmetic); key reports equal;
the tune's per-candidate SNRs within 1 dB (the JAX CPU path runs Sparge
through the dense-mask XLA form, the port through the block-sparse kernel's
plain version: the same selection, attention sums in other orders,
difference f), the chosen l1 equal wherever every candidate's SNR stands
more than 1 dB from the bar."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.models.wan import config as jcfg
from lightx2v_tpu.models.wan import weights as jweights
from lightx2v_tpu.tools import psnr as jpsnr
from lightx2v_tpu.tools import tune_sparge as jtune
from lightx2v_tpu.tools import validate_ckpt as jval
from lightx2v_tpu_torch.models.wan import config as tcfg
from lightx2v_tpu_torch.models.wan import weights as tweights
from lightx2v_tpu_torch.tools import psnr as tpsnr
from lightx2v_tpu_torch.tools import tune_sparge as ttune
from lightx2v_tpu_torch.tools import validate_ckpt as tval
from lightx2v_tpu_torch.utils import safetensors_io as tst

TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_psnr_vs_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 256, (3, 16, 24, 3), dtype=np.uint8)
    got = np.clip(ref.astype(np.int16) + rng.integers(-3, 4, ref.shape), 0, 255).astype(np.uint8)
    assert abs(tpsnr.psnr(ref, got) - jpsnr.psnr(ref, got)) < 1e-9
    np.testing.assert_allclose(tpsnr.per_frame_psnr(ref, got), jpsnr.per_frame_psnr(ref, got), rtol=0, atol=1e-9)
    f = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    assert abs(tpsnr.psnr(f, f + 0.01) - jpsnr.psnr(f, f + 0.01)) < 1e-9 and tpsnr.psnr(f, f) == float("inf")
    with pytest.raises(ValueError):
        tpsnr.psnr(f, f[:1])
    np.save(tmp_path / "ref.npy", ref)
    np.savez(tmp_path / "got.npz", frames=got)
    np.testing.assert_array_equal(tpsnr.load_frames(str(tmp_path / "got.npz")), got)
    want = jpsnr.main(["--ours", str(tmp_path / "got.npz"), "--ref", str(tmp_path / "ref.npy")])
    assert tpsnr.main(["--ours", str(tmp_path / "got.npz"), "--ref", str(tmp_path / "ref.npy")]) == want == 0
    assert tpsnr.main(["--ours", str(tmp_path / "got.npz"), "--ref", str(tmp_path / "ref.npy"), "--min_db", "80"]) == 1
    monkeypatch.setitem(sys.modules, "cv2", None)  # as on the card machine
    with pytest.raises(ImportError, match="difference av"):
        tpsnr.load_frames(str(tmp_path / "clip.mp4"))


def _write_ckpt(path, wd):
    path.mkdir()
    tst.save_file({k: tst.as_tensor(np.array(v)) for k, v in wd.items()}, str(path / "model.safetensors"))


def _args(mod, ckpt, *extra):
    return mod.build_parser().parse_args(["--model_cls", "wan2.1", "--ckpt", str(ckpt), *extra])


def _three_way(rep):
    """The report without ``consumed``: the JAX tool counts every key asked
    for and not missing there, the port the keys present and read
    (difference ax)."""
    return {k: v for k, v in rep.items() if k != "consumed"}


def test_validate_ckpt_report_vs_jax(tmp_path):
    """The three-way report (consumed, missing, unused) of both tools on one
    checkpoint with a stray key, the forward at its real dims on the port
    (finite), and an advanced-PTQ int8 checkpoint with its ``config.json``:
    every ``affine_norm`` key consumed, none unused."""
    from lightx2v_tpu.tools import convert as jconv

    wd = jweights.init_random_weight_dict(jcfg.WanArch(**TINY), seed=0)
    stray = dict(wd, **{"blocks.0.stray.weight": np.ones(4, np.float32)})
    _write_ckpt(tmp_path / "ckpt", stray)
    jr = jval.validate_wan(jval.load_state_dict(str(tmp_path / "ckpt")), _args(jval, tmp_path / "ckpt", "--no-forward"))
    tr = tval.validate(_args(tval, tmp_path / "ckpt", "--device", "cpu"))
    assert _three_way(tr[0]) == _three_way(jr[0]) and tr[0]["unused"] == ["blocks.0.stray.weight"]
    assert tr[0]["consumed"] == tr[0]["total_keys"] - 1 and not tr[0]["key_coverage_ok"]
    assert tr[1]["ok"] and tr[1]["output_shape"] == [1, 16, 2, 8, 8] and tr[1]["mm_type"] == "Default"
    assert tval.main(["--model_cls", "wan2.1", "--ckpt", str(tmp_path / "ckpt"), "--no-forward", "--device",
                      "cpu"]) == 1

    stats = {f"blocks.{i}.{s}": np.full(n, 2.0, np.float32) for i in range(2)
             for s, n in (("self_attn.q", 256), ("ffn.0", 256))}
    w = dict(wd)
    jconv.apply_smooth_quant(w, stats)
    q = jconv.quantize_model(w, "int8")
    assert sum("affine_norm" in k for k in q) == 8
    jconv.save_quantized(q, str(tmp_path / "ptq"), scheme="int8", advanced_ptq=True)
    tr = tval.validate(_args(tval, tmp_path / "ptq", "--device", "cpu"))
    assert tr[0]["key_coverage_ok"] and tr[0]["total_keys"] == len(q) and not tr[0]["unused"]
    assert tr[1]["ok"] and tr[1]["mm_type"] == "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"
    assert tval.main(["--model_cls", "wan2.1", "--ckpt", str(tmp_path / "ptq"), "--device", "cpu"]) == 0


@pytest.mark.parametrize("model_cls,component", [("hunyuan", "dit"), ("cogvideox", "dit"), ("hunyuan", "vae"),
                                               ("cogvideox", "vae"), ("wan2.1", "tiny_vae")])
def test_validate_ckpt_other_models_vs_jax(tmp_path, model_cls, component):
    """The HunyuanVideo and CogVideoX DiTs' and VAEs' reports and the tiny
    VAE's (the port's Hunyuan loader reads optional keys with ``get``, which
    the recording dict counts; its VAE loaders read the encoder when asked):
    every key consumed, as in the JAX tool. Small widths: the tools infer
    the configs from the shapes."""
    extra = []
    if component == "tiny_vae":
        from test_torch_tiny_vae import _taehv_state_dict

        from lightx2v_tpu.vae.tiny_vae import init_random_tiny_vae_params

        sd = _taehv_state_dict(init_random_tiny_vae_params(seed=0))
        handler, extra = "validate_tiny_vae", ["--component", "tiny_vae"]
    elif component == "vae" and model_cls == "hunyuan":
        from lightx2v_tpu_torch.vae.hunyuan_vae import HunyuanVAEConfig, init_random_hunyuan_vae_state_dict

        sd = init_random_hunyuan_vae_state_dict(HunyuanVAEConfig(block_out_channels=(32,) * 4, layers_per_block=1,
                                                                 norm_num_groups=8), seed=0)
        handler, extra = "validate_vae", ["--component", "vae", "--vae_groups", "8"]
    elif component == "vae":
        from lightx2v_tpu_torch.vae.cogvideox_vae import CogVAEConfig, init_random_cog_vae_state_dict

        sd = init_random_cog_vae_state_dict(CogVAEConfig(block_out_channels=(32,) * 4), seed=0)
        handler, extra = "validate_vae", ["--component", "vae"]
    elif model_cls == "hunyuan":
        from lightx2v_tpu_torch.models.hunyuan.config import HunyuanArch
        from lightx2v_tpu_torch.models.hunyuan.weights import init_random_hunyuan_state_dict

        sd = init_random_hunyuan_state_dict(HunyuanArch(hidden_size=256, heads_num=2, double_blocks=1,
                                                        single_blocks=1, mlp_hidden_dim=512), seed=0)
        handler = "validate_hunyuan"
    else:
        from lightx2v_tpu_torch.models.cogvideox.config import CogArch
        from lightx2v_tpu_torch.models.cogvideox.weights import init_random_cog_state_dict

        sd = init_random_cog_state_dict(CogArch(num_layers=1, num_heads=2), seed=0)
        handler = "validate_cog"
    _write_ckpt(tmp_path / "ckpt", sd)
    argv = ["--model_cls", model_cls, "--ckpt", str(tmp_path / "ckpt"), "--no-forward", *extra]
    jr = getattr(jval, handler)(jval.load_state_dict(str(tmp_path / "ckpt")), jval.build_parser().parse_args(argv))
    tr = tval.validate(tval.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert _three_way(tr[0]) == _three_way(jr[0]) and tr[0]["key_coverage_ok"]
    assert tr[0]["consumed"] == tr[0]["total_keys"] == len(sd)


def test_validate_ckpt_missing_keys_vs_jax(tmp_path):
    """A key asked for and absent: both packages' recording dicts list it
    as missing beside the unused ones, and both loaders raise on a
    checkpoint that lacks a required key."""
    for mod in (jval, tval):
        rec = mod.RecordingDict({"a": 1, "b": 2})
        assert "c" not in rec and rec["a"] == 1
        with pytest.raises(KeyError):
            rec["d"]
        rep = mod._report_keys("x", rec)
        assert _three_way(rep) == {"component": "x", "total_keys": 2, "missing": ["d"], "unused": ["b"],
                                   "key_coverage_ok": False}
    assert tval._report_keys("x", rec)["consumed"] == 1
    wd = jweights.init_random_weight_dict(jcfg.WanArch(**TINY), seed=0)
    del wd["blocks.1.ffn.2.weight"]
    _write_ckpt(tmp_path / "ckpt", wd)
    for mod, extra in ((jval, ()), (tval, ("--device", "cpu"))):
        args = _args(mod, tmp_path / "ckpt", "--no-forward", *extra)
        with pytest.raises(KeyError, match="blocks.1.ffn.2.weight"):
            mod.validate_wan(mod.load_state_dict(str(tmp_path / "ckpt")), args)


@pytest.fixture(scope="module")
def tune_setup():
    """dim 256, 2 heads of 128, 2 layers; 4 x 32 x 32 latents (1024 tokens,
    8 selection blocks a head; keep 0.75 leaves 6 to share the mass)."""
    arch = dict(TINY, in_dim=16, out_dim=16, text_len=32)
    wd = jweights.init_random_weight_dict(jcfg.WanArch(**arch), seed=3)
    rng = np.random.default_rng(7)
    lat = (rng.standard_normal((1, 16, 4, 32, 32)) * 0.5).astype(np.float32)
    ctx = (rng.standard_normal((1, 32, 256)) * 0.1).astype(np.float32)
    return arch, wd, lat, ctx


def test_tune_sparge_vs_jax(tune_setup):
    """At bar 22.5 dB layer 0 fails (its best, the densest selection, near
    20.7 dB) and layer 1 takes l1 0.1 (near 23.8 dB; 0.3 and 0.2 near 21.1):
    every candidate stands more than 1 dB from the bar, so the tables must be
    equal; the SNRs within 1 dB."""
    arch_kw, wd, lat, ctx = tune_setup
    jarch, tarch = jcfg.WanArch(**arch_kw), tcfg.WanArch(**arch_kw)
    kw = dict(keep_ratio=0.75, l1_grid=(0.3, 0.2, 0.1, 0.05, 0.02), block_q=128, block_k=128, verbose=False)
    t = np.array([500.0], np.float32)
    jl1, jsnr, jok = jtune.tune_sparge(jweights.load_wan_params(wd, jarch), jarch, jnp.asarray(lat, jnp.bfloat16),
                                       jnp.asarray(t), jnp.asarray(ctx, jnp.bfloat16), bar_db=22.5, **kw)
    tparams = tweights.load_wan_params(wd, tarch)
    targs = (tparams, tarch, torch.from_numpy(lat).to(torch.bfloat16), torch.from_numpy(t),
             torch.from_numpy(ctx).to(torch.bfloat16))
    tl1, tsnr, tok = ttune.tune_sparge(*targs, bar_db=22.5, **kw)
    assert tl1.shape == tsnr.shape == tok.shape == (2,)
    np.testing.assert_allclose(tsnr, jsnr, rtol=0, atol=1.0)
    np.testing.assert_array_equal(tl1, jl1)
    np.testing.assert_array_equal(tok, jok)
    assert list(tok) == [False, True] and tl1[0] == 0.0 and 0.0 < tl1[1] < 0.3
    # the head-chunked evaluation is the whole tensor's; a chunk that does not divide the heads raises
    chunked = ttune.tune_sparge(*targs, bar_db=22.5, head_chunk=1, **kw)
    np.testing.assert_array_equal(chunked[0], tl1)
    np.testing.assert_allclose(chunked[1], tsnr, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="must divide"):
        ttune.tune_sparge(*targs, bar_db=22.5, head_chunk=3, **kw)
    # a looser bar never picks a smaller l1
    loose = ttune.tune_sparge(*targs, bar_db=15.0, **kw)
    assert np.all(loose[0] >= tl1) and loose[2].all()


def test_tune_sparge_cli_table_feeds_the_runner(tmp_path, capsys):
    """The CLI's ``.npz`` (tiny preset, structured synthetic weights on the
    CPU, latents from 3 points of a 3-step UniPC trajectory, heads in chunks)
    is what the runner's ``sparge_ckpt`` reads: one l1 a layer."""
    from lightx2v_tpu_torch.runners.wan_runner import WanRunner
    from lightx2v_tpu_torch.utils.config import set_config

    out = tmp_path / "table.npz"
    ttune.main(["--structured", "--preset", "tiny", "--frames", "2", "--height", "16", "--width", "16",
                "--l1_grid", "0.3,0.05", "--bar_db", "10", "--block_q", "128", "--block_k", "128",
                "--eval_head_chunk", "2", "--trajectory", "3", "--output", str(out), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["samples"] == 3
    table = np.load(out)
    assert table["l1"].shape == (4,) and table["passed"].dtype == bool and float(table["bar_db"]) == 10.0
    runner = WanRunner.__new__(WanRunner)
    runner.config = set_config(dict(sparge=True, sparge_ckpt=str(out), sparse_block_q=128, sparse_block_k=128))
    runner.arch = tcfg.WanArch(dim=256, ffn_dim=512, num_heads=4, num_layers=4)
    attn, _, kw = runner._self_attn_setup()
    assert attn == "sparge" and kw["l1_per_layer"] == [float(v) for v in table["l1"]]
