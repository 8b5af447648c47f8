"""Feature caching on the CPU, port vs JAX package: each caching function
(the Tea decisions and their host replay, the Tea transforms, TaylorSeer's
calc and skip steps, TaylorWS, AdaCache's skip length) on the same inputs,
and a short denoise loop per mode (and i2v with Tea) against the JAX
``make_denoise_fn``.

Tiny arch: dim 256, ffn 512, 2 heads of 128, 2 layers, rope_fused, bf16
linears, latents 16x3x8x8 (48 tokens, 16 a frame), one numpy weight dict
loaded by both packages. Bars:
- decisions, schedules and skip lengths: equal;
- transforms on given tensors (no block inside): equal up to one bf16 or
  e4m3 rounding of the same value (atol 0, rtol 2^-7 / 2^-3);
- block outputs and Taylor caches: relative L2 1e-2, as a forward's
  (bf16 activations summed in another order; measured <= 6.5e-3);
- denoise loops (UniPC, 6-8 steps from the same latents): relative L2
  1e-2 without CFG (measured 1.2e-3 to 1.4e-3), 2e-2 with CFG at scale 5,
  which carries 5x its rows' differences (measured 4.9e-3 to 6.4e-3).
The loops hold at least one calc and one skip step each, and Tea's and
Custom's decisions equal JAX's host replay on the JAX time embeddings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functools import partial

from lightx2v_tpu.caching import adacache as jada
from lightx2v_tpu.caching import taylorseer as jtay
from lightx2v_tpu.caching import teacache as jtea
from lightx2v_tpu.models.wan import config as jcfg
from lightx2v_tpu.models.wan import model as jmodel
from lightx2v_tpu.models.wan import pipeline as jpipe
from lightx2v_tpu.models.wan import weights as jweights
from lightx2v_tpu.ops.attention import attention as jattention
from lightx2v_tpu.schedulers import unipc as junipc
from lightx2v_tpu.utils.config import set_config as jset
from lightx2v_tpu_torch.caching import adacache as tada
from lightx2v_tpu_torch.caching import taylorseer as ttay
from lightx2v_tpu_torch.caching import teacache as ttea
from lightx2v_tpu_torch.models.wan import config as tcfg
from lightx2v_tpu_torch.models.wan import pipeline as tpipe
from lightx2v_tpu_torch.models.wan import weights as tweights
from lightx2v_tpu_torch.ops.attention import attention as tattention
from lightx2v_tpu_torch.schedulers import unipc as tunipc
from lightx2v_tpu_torch.utils.config import set_config as tset

TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=256, rope_fused=True)
SHAPE = (16, 3, 8, 8)
S = 48
# poly(rel) = rel: the accumulator sums the relative L1 steps of the embeddings
LINEAR = [[1.0, 0.0], [1.0, 0.0]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small ops: one torch thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(t, j, rtol):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def models():
    extra = {k: v for k, v in TINY.items() if k != "rope_fused"}
    wd = jweights.init_random_weight_dict(jcfg.WanArch(**extra), seed=0)
    jarch, tarch = jcfg.WanArch(**TINY), tcfg.WanArch(**TINY)
    jp = jweights.permute_qk_half(jweights.load_wan_params(wd, jarch), jarch)
    tp = tweights.permute_qk_half(tweights.load_wan_params(wd, tarch), tarch)
    return jarch, tarch, jp, tp


# ---------------------------------------------------------------- TeaCache

@pytest.mark.parametrize("use_ret", [False, True])
def test_tea_config_from_config(use_ret):
    cfg = dict(infer_steps=40, teacache_thresh=0.2, use_ret_steps=use_ret,
               coefficients=[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    j, t = jtea.TeaCacheConfig.from_config(jset(dict(cfg))), ttea.TeaCacheConfig.from_config(tset(dict(cfg)))
    assert (t.thresh, t.coefficients, t.use_ret_steps, t.ret_steps, t.cutoff_steps) == \
        (j.thresh, j.coefficients, j.use_ret_steps, j.ret_steps, j.cutoff_steps)
    assert (t.ret_steps, t.cutoff_steps) == ((5, 40) if use_ret else (1, 39))


def _embed_walk(steps=12, rows=2, seed=0):
    """A random walk of (rows, 6, 16) embeddings whose rows drift apart."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((rows, 6, 16)).astype(np.float32)
    out = []
    for i in range(steps):
        e = e + (0.02 + 0.06 * np.arange(rows)[:, None, None]) * rng.standard_normal(e.shape).astype(np.float32)
        out.append(e.copy())
    return np.stack(out)


@pytest.mark.parametrize("use_ret", [False, True])
@pytest.mark.parametrize("per_side", [False, True])
def test_tea_decisions_vs_jax(per_side, use_ret):
    """Step by step (``tea_decide`` / ``tea_decide_per_side``) on both sides
    and the port's host replay: the same decisions, accumulators and stored
    embeddings. The two rows drift at different rates, so the per-side
    decisions differ between rows."""
    series = _embed_walk()
    cfg = ttea.TeaCacheConfig(thresh=0.1, coefficients=(1.0, 0.0), use_ret_steps=use_ret,
                              ret_steps=5 if use_ret else 1, cutoff_steps=11)
    jc = jtea.TeaCacheConfig(**{k: getattr(cfg, k) for k in ("thresh", "coefficients", "use_ret_steps",
                                                             "ret_steps", "cutoff_steps")})
    mod_shape = (2, 6, 16) if use_ret else (2, 16)
    js, ts = jtea.init_tea_state((2, 4, 16), mod_shape), ttea.init_tea_state((2, 4, 16), mod_shape)
    jdec, tdec = (jtea.tea_decide_per_side, ttea.tea_decide_per_side) if per_side else \
        (jtea.tea_decide, ttea.tea_decide)
    want = []
    for i, e0 in enumerate(series):
        embed = e0[:, 0]
        jshould, js = jdec(js, jnp.asarray(embed), jnp.asarray(e0), jnp.asarray(i), jc)
        tshould, ts = tdec(ts, torch.from_numpy(embed), torch.from_numpy(e0), i, cfg)
        jshould = np.asarray(jshould)
        assert np.array_equal(np.asarray(tshould), jshould), i
        np.testing.assert_allclose(ts["accum"].numpy(), np.asarray(js["accum"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(ts["prev_mod"].numpy(), np.asarray(js["prev_mod"]))
        want.append(jshould)
    mods = series if use_ret else series[:, :, 0]
    replay = ttea.tea_decision_series(mods, cfg, per_side=per_side)
    assert np.array_equal(replay, np.array(want))
    if not per_side:
        assert np.array_equal(replay, jtea.tea_decision_series(mods, jc))
    flat = np.array(want).reshape(len(series), -1)
    assert flat.any() and not flat.all()  # calc and skip steps
    if per_side:
        assert (flat[:, 0] != flat[:, 1]).any()  # the sides decide apart


def _tea_state(rng, dtype):
    res = (rng.standard_normal((2, S, 16)) * 2).astype(np.float32)
    jstate = jtea.init_tea_state((2, S, 16), (2, 16), dtype=jnp.dtype(dtype))
    jstate["prev_residual"] = jnp.asarray(res).astype(jnp.dtype(dtype))
    tdt = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn, "float32": torch.float32}[dtype]
    tstate = ttea.init_tea_state((2, S, 16), (2, 16), dtype=tdt)
    tstate["prev_residual"] = torch.from_numpy(np.array(jstate["prev_residual"].astype(jnp.float32))).to(tdt)
    return jstate, tstate


def _x(rng, b=2):
    x = rng.standard_normal((b, S, 16)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn", "float32"])
@pytest.mark.parametrize("calc", [True, False])
def test_tea_transform_vs_jax(dtype, calc):
    """Compute (the residual x_out - x in bf16, stored in the cache dtype; the
    fp8 one clipped to +-448: the function's outputs reach +-1000) or skip
    (x + residual in x's dtype)."""
    rng = np.random.default_rng(3)
    js, ts = _tea_state(rng, dtype)
    jx, tx = _x(rng)
    jo, js = jtea.tea_transform(js, jnp.asarray(calc), jx, lambda x: x * 300.0 + 0.25)
    to, ts = ttea.tea_transform(ts, calc, tx, lambda x: x * 300.0 + 0.25)
    assert to.dtype == torch.bfloat16
    _close(to, jo, 2 ** -7)
    rtol = 2 ** -3 if dtype == "float8_e4m3fn" else 2 ** -7
    _close(ts["prev_residual"], jnp.asarray(js["prev_residual"], jnp.float32), rtol)
    if calc and dtype == "float8_e4m3fn":
        assert float(ts["prev_residual"].float().abs().max()) == 448.0


@pytest.mark.parametrize("should", [(True, True), (True, False), (False, True), (False, False)])
def test_tea_transform_per_side_vs_jax(should):
    """The four cases with forced decisions: a one-sided step runs the
    batch-1 forward of that side (a side-dependent function here) and
    replays the other side's residual."""
    rng = np.random.default_rng(4)
    js, ts = _tea_state(rng, "bfloat16")
    jx, tx = _x(rng)
    tf = lambda x: x * 1.5 + 0.25  # noqa: E731
    single = lambda x, side: x * (1.5 + side) - 0.5 * side  # noqa: E731
    jo, js = jtea.tea_transform_per_side(js, jnp.asarray(should), jx, tf, single)
    to, ts = ttea.tea_transform_per_side(ts, torch.tensor(should), tx, tf, single)
    _close(to, jo, 2 ** -7)
    _close(ts["prev_residual"], jnp.asarray(js["prev_residual"], jnp.float32), 2 ** -7)


# ------------------------------------------------------------- TaylorSeer

@pytest.mark.parametrize("n", [1, 6, 9, 50])
def test_taylor_schedule_equal(n):
    for t, j in zip(ttay.taylor_schedule(n), jtay.taylor_schedule(n)):
        np.testing.assert_array_equal(t, j)


def _block_inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, 256)).astype(np.float32)
    e0 = (rng.standard_normal((b, 6, 256)) * 0.1).astype(np.float32)
    ctx = (rng.standard_normal((b, 16, 256)) * 0.5).astype(np.float32)
    j = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(e0), jnp.asarray(ctx, jnp.bfloat16))
    t = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(e0), torch.from_numpy(ctx).to(torch.bfloat16))
    return j, t


def test_taylor_calc_skip_vs_jax(models):
    """Calc at step 0 (unprimed: f1 = 0), calc at step 4 (f1 = dy / 4), then
    skips at dt 1 and 2: every cache entry and every output."""
    jarch, tarch, jp, tp = models
    jc, js, _ = jpipe.rope_for_shape(jarch, SHAPE)
    tc, ts, _ = tpipe.rope_for_shape(tarch, SHAPE)
    jcache = jtay.init_taylor_cache(jarch, 2, S)
    tcache = ttay.init_taylor_cache(tarch, 2, S)
    jfn = dict(self_attn_fn=partial(jattention, "flash_attn3"), cross_attn_fn=partial(jattention, "flash_attn3"))
    tfn = dict(self_attn_fn=partial(tattention, "flash_attn3"), cross_attn_fn=partial(tattention, "flash_attn3"))
    for seed, diff, primed in ((0, 1.0, False), (1, 4.0, True)):
        (jx, je, jctx), (tx, te, tctx) = _block_inputs(seed)
        jo, jcache = jtay.taylor_calc_step(jp, jx, je, jctx, None, jc, js, jarch, jcache, jnp.float32(diff),
                                           primed=primed, **jfn)
        to, tcache = ttay.taylor_calc_step(tp, tx, te, tctx, None, tc, ts, tarch, tcache, diff, primed=primed,
                                           **tfn)
        assert _rel(_np(to), _np(jo)) < 1e-2
        for name in ttay.MODULES:
            for f in ("f0", "f1"):
                t, j = _np(tcache[name][f]), _np(jcache[name][f])
                if f == "f1" and not primed:
                    assert not t.any() and not j.any()
                else:
                    assert _rel(t, j) < 1e-2, (seed, name, f)
    for seed, dt in ((2, 1.0), (3, 2.0)):
        (jx, je, _), (tx, te, _) = _block_inputs(seed)
        jo = jtay.taylor_skip_step(jp, jx, je, jarch, jcache, jnp.float32(dt))
        to = ttay.taylor_skip_step(tp, tx, te, tarch, tcache, dt)
        assert to.dtype == torch.bfloat16 and _rel(_np(to), _np(jo)) < 1e-2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float8_e4m3fn"])
def test_taylor_ws_vs_jax(dtype):
    """The whole-stack pair: calc at 0 (f1 = 0), calc at 4, skips at 5 and 6
    (bf16 chain unless the cache is fp32; fp8 stores clipped)."""
    tdt = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn, "float32": torch.float32}[dtype]
    jcache = jtay.init_taylor_ws_cache(2, S, 16, dtype=jnp.dtype(dtype))
    tcache = ttay.init_taylor_ws_cache(2, S, 16, dtype=tdt)
    rng = np.random.default_rng(5)
    rtol = 2 ** -3 if dtype == "float8_e4m3fn" else 2 ** -7
    for i, scale in ((0, 50.0), (4, 80.0)):
        jx, tx = _x(rng)
        jo, jcache = jtay.taylor_ws_calc(lambda x: x * scale + 0.25, jx, jcache, jnp.asarray(i, jnp.int32))
        to, tcache = ttay.taylor_ws_calc(lambda x: x * scale + 0.25, tx, tcache, i)
        _close(to, jo, 2 ** -7)
        assert tcache["last_calc"] == int(jcache["last_calc"]) == i
        for f in ("f0", "f1"):
            _close(tcache[f], jnp.asarray(jcache[f], jnp.float32), rtol)
    for i in (5, 6):
        jx, tx = _x(rng)
        _close(ttay.taylor_ws_skip(tx, tcache, i), jtay.taylor_ws_skip(jx, jcache, jnp.asarray(i, jnp.int32)),
               2 ** -7)


# --------------------------------------------------------------- AdaCache

def test_codebook_rate():
    for m, r in ((0.0, 12.0), (0.04, 10.0), (0.0699, 8.0), (0.08, 6.0), (0.1, 4.0), (0.2, 3.0), (5.0, 3.0)):
        assert tada.codebook_rate(m) == r


def test_ada_skip_length_vs_jax():
    """A run of recordings whose changes shrink, so the codebook walks from
    short to long skips, at steps inside and outside the moreg window
    (n = 20: steps 2..18): the same rates and state. The three frames of 16
    tokens repeat one pattern under noise, so moreg is small but not 0."""
    rng = np.random.default_rng(6)
    frame = rng.standard_normal((2, 16, 32)).astype(np.float32)
    tiny = np.concatenate([frame] * 3, 1) + 0.3 * rng.standard_normal((2, S, 32)).astype(np.float32)
    js, ts = jada.init_ada_state((2, S, 32), metric_scale=0.5), tada.init_ada_state((2, S, 32), metric_scale=0.5)
    rates = []
    for i, eps in ((0, 0.0), (1, 0.3), (4, 0.1), (7, 0.04), (19, 0.01), (20, 0.005)):
        tiny = tiny + eps * rng.standard_normal(tiny.shape).astype(np.float32)
        jr, js = jada.ada_skip_length(js, jnp.asarray(tiny), jnp.asarray(i, jnp.int32), 20, 16)
        tr, ts = tada.ada_skip_length(ts, torch.from_numpy(tiny), i, 20, 16)
        assert tr == float(jr) and ts["skip_until"] == int(js["skip_until"]), i
        assert ts["skipped_len"] == float(js["skipped_len"]) and ts["has_tiny"]
        np.testing.assert_allclose(float(ts["prev_moreg"]), float(js["prev_moreg"]), rtol=1e-4)
        rates.append(tr)
    assert rates[0] == 1.0 and len(set(rates)) >= 3, rates


# ------------------------------------------------------- denoise loops

@pytest.fixture(scope="module")
def models_i2v():
    arch = dict(TINY, task="i2v", in_dim=36)
    wd = jweights.init_random_weight_dict(jcfg.WanArch(**{k: v for k, v in arch.items() if k != "rope_fused"}),
                                          seed=1)
    jarch, tarch = jcfg.WanArch(**arch), tcfg.WanArch(**arch)
    jp = jweights.permute_qk_half(jweights.load_wan_params(wd, jarch), jarch)
    tp = tweights.permute_qk_half(tweights.load_wan_params(wd, tarch), tarch)
    return jarch, tarch, jp, tp


def _loop(models, mode, steps, enable_cfg, extra=None, i2v=False):
    """(port latents, JAX latents, port calc_steps, JAX Tea replay or None)
    after ``steps`` UniPC steps from the same latents and contexts."""
    jarch, tarch, jp, tp = models
    cfg = dict(infer_steps=steps, sample_shift=5, feature_caching=mode, **(extra or {}))
    jcfg_, tcfg_ = jset(dict(cfg)), tset(dict(cfg))
    rng = np.random.default_rng(7)
    lat = rng.standard_normal(SHAPE).astype(np.float32)
    ctx, ctx_null = ((rng.standard_normal((1, 16, 256)) * 0.5).astype(np.float32) for _ in range(2))
    y = clip = None
    if i2v:
        y = rng.standard_normal((1, 20, *SHAPE[1:])).astype(np.float32)
        clip = rng.standard_normal((1, 257, jarch.clip_dim)).astype(np.float32)
    jsched, tsched = junipc.WanUniPCScheduler(jcfg_), tunipc.WanUniPCScheduler(tcfg_)
    jstate = dict(jsched.prepare(SHAPE, 0), latents=jnp.asarray(lat))
    tstate = tsched.prepare(SHAPE, torch.Generator().manual_seed(0))
    tstate["latents"] = torch.from_numpy(lat)
    kw = dict(enable_cfg=enable_cfg, guide_scale=5.0, self_attn_type="flash_attn3", cross_attn_type="flash_attn3",
              feature_caching=mode)
    jden = jpipe.make_denoise_fn(jarch, jsched, SHAPE, caching_config=jcfg_, **kw)
    tden = tpipe.make_denoise_fn(tarch, tsched, SHAPE, caching_config=tcfg_, **kw)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    jin = {} if y is None else dict(y=jnp.asarray(y), clip_fea=jnp.asarray(clip))
    tin = {} if y is None else dict(y=torch.from_numpy(y), clip_fea=torch.from_numpy(clip))
    jout = jden(jp, jstate, jb(ctx), jb(ctx_null), **jin)
    tout = tden(tp, tstate, tb(ctx), context_null=tb(ctx_null) if enable_cfg else None, **tin)
    replay = None
    if mode in ("Tea", "Custom"):
        tc = jtea.TeaCacheConfig.from_config(jcfg_)
        ts = jnp.asarray(jsched.timesteps, jnp.float32)
        embed, embed0 = jmodel.time_embeddings(jp, ts, jarch)
        replay = jtea.tea_decision_series(np.asarray(embed0 if tc.use_ret_steps else embed)[:, None], tc)
    return tout["latents"].numpy(), np.asarray(jout["latents"]), tden.calc_steps, replay


def _calc_and_skip(calc_steps):
    flat = [any(c) if isinstance(c, tuple) else c for c in calc_steps]
    return any(flat) and not all(flat)


@pytest.mark.parametrize("mode,steps,cfg,extra,bar", [
    ("Tea", 7, False, dict(coefficients=LINEAR, teacache_thresh=1.5), 1e-2),
    ("Tea", 7, True, dict(coefficients=LINEAR, teacache_thresh=1.5), 2e-2),
    ("Custom", 8, True, dict(coefficients=LINEAR, teacache_thresh=0.5, use_ret_steps=True), 2e-2),
    ("TaylorSeer", 6, True, {}, 2e-2),
    ("TaylorWS", 6, False, {}, 1e-2),
    ("Ada", 6, False, {}, 1e-2),
])
def test_denoise_loop_vs_jax(models, mode, steps, cfg, extra, bar):
    t, j, calc_steps, replay = _loop(models, mode, steps, cfg, extra)
    assert t.shape == j.shape == SHAPE and np.isfinite(t).all()
    assert _calc_and_skip(calc_steps), calc_steps
    if replay is not None:
        flat = [all(c) if isinstance(c, tuple) else c for c in calc_steps]
        assert flat == list(replay), (calc_steps, replay)
    if mode in ("TaylorSeer", "TaylorWS"):
        assert calc_steps == [i % 4 == 0 for i in range(steps)]
    assert _rel(t, j) < bar, _rel(t, j)


def test_denoise_loop_i2v_tea_vs_jax(models_i2v):
    """i2v (36 input channels, the image cross-attention over 257 CLIP
    tokens) with Tea without CFG."""
    extra = dict(coefficients=LINEAR, teacache_thresh=1.5)
    t, j, calc_steps, replay = _loop(models_i2v, "Tea", 7, False, extra, i2v=True)
    assert t.shape == j.shape == SHAPE and np.isfinite(t).all()
    assert _calc_and_skip(calc_steps) and calc_steps == list(replay), (calc_steps, replay)
    assert _rel(t, j) < 1e-2, _rel(t, j)
