"""Port UniPC scheduler vs the JAX package's, step by step on injected
latents and model outputs (made with numpy from a seed), and vs the JAX
package's float64 oracle ``reference_unipc_numpy``.

Bars: both sides compute the scalar coefficients in fp32 and the latent
updates in fp32, but log/expm1 (and the 3x3 solve of order 3) come from
different libraries and may differ by an ulp, which the divisions by
h ~ 0.1-1 amplify: per-step 2e-5 relative to max|x| for orders 1-2, 2e-4 for
order 3; against the float64 oracle 1e-4 (fp32 coefficients)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightx2v_tpu.schedulers import unipc as junipc
from lightx2v_tpu.utils.config import set_config as jset
from lightx2v_tpu_torch.schedulers import unipc as tunipc
from lightx2v_tpu_torch.utils.config import set_config as tset

SHAPE = (4, 3, 6, 6)


def _pair(steps, order, shift=5.0):
    cfg = dict(infer_steps=steps, sample_shift=shift, solver_order=order)
    return junipc.WanUniPCScheduler(jset(dict(cfg))), tunipc.WanUniPCScheduler(tset(dict(cfg)))


def _inputs(steps, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE).astype(np.float32),
            rng.standard_normal((steps, *SHAPE)).astype(np.float32))


def _rel(a, b):
    """max |a - b| relative to max |b| (absolute where b is all zero)."""
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(np.abs(b).max(), 1e-30))


def test_flow_sigmas_and_tables_equal():
    np.testing.assert_array_equal(tunipc.flow_sigmas(1000, 3.0), junipc.flow_sigmas(1000, 3.0))
    for steps, order, start in [(3, 2, 0), (8, 3, 0), (6, 2, 3), (1, 2, 0)]:
        js, ts = _pair(steps, order)
        js.prepare(SHAPE, 0, start_step=start)
        ts.prepare(SHAPE, torch.Generator().manual_seed(0), start_step=start, shift=None)
        np.testing.assert_array_equal(ts.sigmas, js.sigmas)
        np.testing.assert_array_equal(ts.timesteps, js.timesteps)
        np.testing.assert_array_equal(ts.pred_order, js.pred_order)
        np.testing.assert_array_equal(ts.corr_order, js.corr_order)


@pytest.mark.parametrize("steps,order,shift", [(3, 2, 5.0), (6, 2, 5.0), (5, 1, 3.0), (6, 3, 5.0), (4, 3, 8.0)])
def test_step_by_step_vs_jax(steps, order, shift):
    """Every state entry after every step, with the port's state re-seeded
    from the JAX state each step so one step's arithmetic is compared."""
    js, ts = _pair(steps, order, shift)
    x0, eps = _inputs(steps, seed=steps + order)
    jstate = js.prepare(SHAPE, 0)
    ts.prepare(SHAPE, torch.Generator().manual_seed(0))
    jstate = dict(jstate, latents=jnp.asarray(x0))
    tol = 2e-4 if order == 3 else 2e-5
    keys = ("latents", "m_prev", "m_prev2", "m_prev3", "last_sample")
    for i in range(steps):
        tstate = {k: torch.from_numpy(np.array(jstate[k])) for k in keys}
        tstate["step_index"] = i
        jstate = js.step_post(jstate, jnp.asarray(eps[i]))
        tstate = ts.step_post(tstate, torch.from_numpy(eps[i]))
        assert tstate["step_index"] == i + 1 == int(jstate["step_index"])
        for k in keys:
            assert tstate[k].dtype == torch.float32
            assert _rel(tstate[k].numpy(), np.asarray(jstate[k])) < tol, (i, k)
    assert np.isfinite(tstate["latents"].numpy()).all()


@pytest.mark.parametrize("steps", [3, 10])
def test_full_run_vs_float64_oracle(steps):
    _, ts = _pair(steps, 2)
    x0, eps = _inputs(steps, seed=7)
    state = ts.prepare(SHAPE, torch.Generator().manual_seed(0))
    state["latents"] = torch.from_numpy(x0)
    for i in range(steps):
        lat, t = ts.step_pre(state)
        assert lat.dtype == torch.bfloat16 and float(t[0]) == ts.timesteps[i]
        state = ts.step_post(state, torch.from_numpy(eps[i]))
    ref = junipc.reference_unipc_numpy({"x0": x0, "eps": eps}, ts.sigmas.astype(np.float64), solver_order=2)
    assert _rel(state["latents"].numpy(), ref) < 1e-4


def test_three_steps_run_every_order():
    """3 steps are the fewest that run the order-1 and order-2 predictors
    and both corrector orders."""
    _, ts = _pair(3, 2)
    ts.prepare(SHAPE, torch.Generator().manual_seed(0))
    assert ts.pred_order.tolist() == [1, 2, 1] and ts.corr_order.tolist() == [0, 1, 2]


def test_prepare_draws_from_the_generator_and_registers():
    from lightx2v_tpu_torch.utils.registry import SCHEDULER_REGISTER

    assert SCHEDULER_REGISTER["unipc"] is SCHEDULER_REGISTER["wan"] is tunipc.WanUniPCScheduler
    _, ts = _pair(3, 2)
    a = ts.prepare(SHAPE, torch.Generator().manual_seed(5))["latents"]
    b = ts.prepare(SHAPE, torch.Generator().manual_seed(5))["latents"]
    assert a.shape == SHAPE and a.dtype == torch.float32 and torch.equal(a, b)
    with pytest.raises(ValueError):
        tunipc.WanUniPCScheduler(tset(dict(infer_steps=3, sample_shift=5, solver_order=4)))
