"""UniPC multistep scheduler for Wan flow matching (counterpart of
``lightx2v_tpu.schedulers.unipc``).

Predictor/corrector of the bh2 variant (B(h) = expm1(-h)), in closed form for
solver orders 1 and 2 and through the general R @ rhos = b solve for order 3.
Flow-matching parameterization: alpha_t = 1 - sigma_t, x0-prediction
``x0 = sample - sigma * flow_pred``.

Order bookkeeping: at step i the corrector runs with the order chosen at step
i-1; the predictor order is min(solver_order, n_steps - i,
lower_order_nums + 1). Both depend only on the step index and are
precomputed in ``prepare``.

The scalar coefficients are computed in fp32 (0-d CPU tensors; Python floats
would be fp64), so they round where the JAX package's do, and reach the
latents as Python floats that hold those fp32 values.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.registry import SCHEDULER_REGISTER
from .base import SchedulerBase, State


def flow_sigmas(num_train_timesteps: int = 1000, shift: float = 1.0) -> np.ndarray:
    """Training sigma grid with shift warp."""
    alphas = np.linspace(1, 1 / num_train_timesteps, num_train_timesteps)[::-1].copy()
    sigmas = 1.0 - alphas
    return shift * sigmas / (1 + (shift - 1) * sigmas)


def _lam(sigma: torch.Tensor) -> torch.Tensor:
    return torch.log(1.0 - sigma) - torch.log(sigma)


def _lam_to(sigma_t: torch.Tensor) -> torch.Tensor:
    """lambda of a step's target sigma; the last one is 0 -> +inf."""
    if float(sigma_t) > 0:
        return _lam(torch.clamp_min(sigma_t, 1e-20))
    return torch.tensor(float("inf"), dtype=torch.float32)


def _nz(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, torch.ones_like(x), x)


@SCHEDULER_REGISTER.register(["unipc", "wan"])
class WanUniPCScheduler(SchedulerBase):
    solver_order = 2
    num_train_timesteps = 1000

    def __init__(self, config):
        super().__init__(config)
        self.sample_shift = float(config.sample_shift)
        self.solver_order = int(config.get("solver_order", 2))
        if not 1 <= self.solver_order <= 3:
            raise ValueError(f"solver_order {self.solver_order} unsupported (1-3)")

    def prepare(self, target_shape, generator: torch.Generator, device=None, shift: Optional[float] = None,
                start_step: int = 0) -> State:
        base = flow_sigmas(self.num_train_timesteps, shift=1.0)
        sigma_max, sigma_min = float(base[0]), float(base[-1])
        sig = np.linspace(sigma_max, sigma_min, self.infer_steps + 1).copy()[:-1]
        sh = self.sample_shift if shift is None else shift
        sig = sh * sig / (1 + (sh - 1) * sig)
        # model-input timesteps are truncated to integers; the sigma table
        # keeps full precision
        self.timesteps = np.trunc(sig * self.num_train_timesteps).astype(np.float32)
        self.sigmas = np.concatenate([sig, [0.0]]).astype(np.float32)

        n = self.infer_steps
        # ``start_step`` restarts the multistep warm-up mid-schedule
        pred_order = np.zeros(n, np.int32)
        corr_order = np.zeros(n, np.int32)  # order used by the corrector at step i; 0 = none
        lower = 0
        prev_this_order = 0
        for i in range(start_step, n):
            corr_order[i] = prev_this_order if i > start_step else 0
            this_order = min(self.solver_order, n - i, lower + 1)
            pred_order[i] = this_order
            prev_this_order = this_order
            if lower < self.solver_order:
                lower += 1
        self.pred_order = pred_order
        self.corr_order = corr_order

        latents = self.init_latents(target_shape, generator, device)
        zeros = torch.zeros_like(latents)
        # m_prev* hold the last converted (x0) model outputs, newest first
        return {"latents": latents, "step_index": 0, "m_prev": zeros, "m_prev2": zeros, "m_prev3": zeros,
                "last_sample": zeros}

    def _sigma(self, i: int) -> torch.Tensor:
        return torch.tensor(float(self.sigmas[max(i, 0)]), dtype=torch.float32)

    # -- closed-form bh2 updates (orders 1 and 2) ----------------------------
    def step_post(self, state: State, noise_pred: torch.Tensor, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> State:
        if self.solver_order >= 3:
            return self._step_post_general(state, noise_pred)
        i = int(state["step_index"])
        pred_order, corr_order = int(self.pred_order[i]), int(self.corr_order[i])
        sample = state["latents"].float()
        m_convert = sample - float(self._sigma(i)) * noise_pred.float()  # x0 prediction

        if corr_order > 0:  # corrector, sigma[i-1] -> sigma[i]
            sigma_t, sigma_s0 = self._sigma(i), self._sigma(i - 1)
            lam_s0 = _lam(sigma_s0)
            h = _lam(sigma_t) - lam_s0
            hh = -h
            h_phi_1 = torch.expm1(hh)
            B_h = h_phi_1
            b0 = (h_phi_1 / hh - 1.0) / B_h
            b1 = ((h_phi_1 / hh - 1.0) / hh - 0.5) * 2.0 / B_h
            m0 = state["m_prev"]
            d1t = m_convert - m0
            alpha_t = 1.0 - sigma_t
            x_t = float(sigma_t / sigma_s0) * state["last_sample"] - float(alpha_t * h_phi_1) * m0
            if corr_order == 2:
                r0 = (_lam(self._sigma(i - 2)) - lam_s0) / h
                rho0 = (b1 - b0) / (r0 - 1.0)  # solve [[1, 1], [r0, 1]] rhos = [b0, b1]
                rho1 = b0 - rho0
                d1s = (state["m_prev2"] - m0) / float(_nz(r0))
                corr = float(rho0) * d1s + float(rho1) * d1t
            else:
                corr = 0.5 * d1t
            sample = x_t - float(alpha_t * B_h) * corr

        # predictor, sigma[i] -> sigma[i+1]
        sigma_t, sigma_s0 = self._sigma(i + 1), self._sigma(i)
        alpha_t = 1.0 - sigma_t
        lam_s0 = _lam(sigma_s0)
        h = _lam_to(sigma_t) - lam_s0
        h_phi_1 = torch.expm1(-h)
        B_h = h_phi_1
        ratio = float(sigma_t / sigma_s0) if float(sigma_s0) > 0 else 0.0
        x_t = ratio * sample - float(alpha_t * h_phi_1) * m_convert
        if pred_order == 2:
            r0 = (_lam(self._sigma(i - 1)) - lam_s0) / _nz(h)
            d1s = (state["m_prev"] - m_convert) / float(_nz(r0))
            x_t = x_t - float(alpha_t * B_h * 0.5) * d1s

        return {"latents": x_t, "step_index": i + 1, "m_prev": m_convert, "m_prev2": state["m_prev"],
                "m_prev3": state["m_prev2"], "last_sample": sample}

    # -- general-order (<= 3) solve ------------------------------------------
    def _step_post_general(self, state: State, noise_pred: torch.Tensor) -> State:
        """UniPC bh2 with per-step order in {1, 2, 3}: the R @ rhos = b solve
        as a fixed 3x3 system whose inactive rows are identity rows, so the
        trailing rhos are exactly 0."""
        i = int(state["step_index"])
        pred_order, corr_order = int(self.pred_order[i]), int(self.corr_order[i])
        sample = state["latents"].float()
        m_convert = sample - float(self._sigma(i)) * noise_pred.float()
        f32 = torch.float32

        def bvec(h):
            """b_k = h_phi_k * k! / B_h for k = 1..3."""
            hh = -h
            h_phi_1 = torch.expm1(hh)
            B_h = h_phi_1
            h_phi_k = h_phi_1 / hh - 1.0
            b1 = h_phi_k / B_h
            h_phi_k = h_phi_k / hh - 0.5
            b2 = h_phi_k * 2.0 / B_h
            h_phi_k = h_phi_k / hh - 1.0 / 6.0
            b3 = h_phi_k * 6.0 / B_h
            return h_phi_1, B_h, torch.stack([b1, b2, b3])

        def masked_solve(rks, b, size):
            jj = torch.arange(3)
            active = (jj[:, None] < size) & (jj[None, :] < size)
            powers = rks[None, :] ** jj[:, None].to(f32)
            A = torch.where(active, powers, torch.eye(3, dtype=f32))
            rhs = torch.where(jj < size, b, torch.zeros(3, dtype=f32))
            return torch.linalg.solve(A, rhs)

        one = torch.tensor(1.0, dtype=f32)
        if corr_order > 0:  # corrector, sigma[i-1] -> sigma[i]
            o = corr_order
            sigma_t, sigma_s0 = self._sigma(i), self._sigma(i - 1)
            lam_s0 = _lam(sigma_s0)
            h = _lam(sigma_t) - lam_s0
            h_phi_1, B_h, b = bvec(h)
            m0 = state["m_prev"]
            rk = torch.stack([(_lam(self._sigma(i - 1 - j)) - lam_s0) / h for j in (1, 2)])
            rk_safe = _nz(rk)
            d1_1 = (state["m_prev2"] - m0) / float(rk_safe[0])
            d1_2 = (state["m_prev3"] - m0) / float(rk_safe[1])
            rks = torch.stack([rk[0], rk[1], one]) if o >= 3 else torch.stack([rk[0], one, one])
            rhos = masked_solve(rks, b, o)
            if o == 1:
                rhos = torch.tensor([0.5, 0.0, 0.0], dtype=f32)
            d1t_coef = float(rhos[max(o - 1, 0)])
            c1 = float(rhos[0]) if o >= 2 else 0.0
            c2 = float(rhos[1]) if o >= 3 else 0.0
            d1_t = m_convert - m0
            alpha_t = 1.0 - sigma_t
            x_t = float(sigma_t / sigma_s0) * state["last_sample"] - float(alpha_t * h_phi_1) * m0
            sample = x_t - float(alpha_t * B_h) * (c1 * d1_1 + c2 * d1_2 + d1t_coef * d1_t)

        # predictor, sigma[i] -> sigma[i+1]
        o = pred_order
        sigma_t, sigma_s0 = self._sigma(i + 1), self._sigma(i)
        alpha_t = 1.0 - sigma_t
        lam_s0 = _lam(sigma_s0)
        h = _lam_to(sigma_t) - lam_s0
        h_phi_1, B_h, b = bvec(h)
        m0 = m_convert
        rk = torch.stack([(_lam(self._sigma(i - j)) - lam_s0) / _nz(h) for j in (1, 2)])
        rk_safe = _nz(rk)
        d1_1 = (state["m_prev"] - m0) / float(rk_safe[0])
        d1_2 = (state["m_prev2"] - m0) / float(rk_safe[1])
        # the predictor solves the leading (o - 1)-sized system
        rhos_p = masked_solve(torch.stack([rk[0], rk[1], one]), b, max(o - 1, 0))
        if o == 2:
            rhos_p = torch.tensor([0.5, 0.0, 0.0], dtype=f32)
        p1 = float(rhos_p[0]) if o >= 2 else 0.0
        p2 = float(rhos_p[1]) if o >= 3 else 0.0
        ratio = float(sigma_t / sigma_s0) if float(sigma_s0) > 0 else 0.0
        x_t = ratio * sample - float(alpha_t * h_phi_1) * m0
        x_t = x_t - float(alpha_t * B_h) * (p1 * d1_1 + p2 * d1_2)

        return {"latents": x_t, "step_index": i + 1, "m_prev": m_convert, "m_prev2": state["m_prev"],
                "m_prev3": state["m_prev2"], "last_sample": sample}
