"""CogVideoX XDPM scheduler (counterpart of
``lightx2v_tpu.schedulers.cogvideox``): betas (``scheduler_beta_start`` /
``_end``, ``scheduler_beta_schedule`` "scaled_linear" or linear), the SNR
shift (``scheduler_snr_shift_scale``), the zero-terminal-SNR rescale
(``scheduler_rescale_betas_zero_snr``), ``timestep_spacing`` "trailing",
"leading" (with ``steps_offset``) or "linspace", ``scheduler_prediction_type``
"v_prediction", "epsilon" or "sample", ``scheduler_set_alpha_to_one``, and a
DPM-solver++(2M)-SDE update whose second order corrects with the previous
x0 prediction. The defaults are CogVideoX1.5-5B's.

The alphas stay float64 on the host and are cast to fp32 as in the JAX
package; each step's scalar coefficients are computed in fp32 (0-d CPU
tensors, so log(0) and exp(-inf) behave as they do there) and reach the
latents as Python floats that hold those fp32 values. The step index lives
on the host, so only the branch the step takes is computed."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.registry import SCHEDULER_REGISTER
from .base import SchedulerBase, State

PREDICTION_TYPES = ("v_prediction", "epsilon", "sample")


def rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """arXiv:2305.08891 Algorithm 1, on alphas_cumprod."""
    s = np.sqrt(alphas_cumprod)
    s0, sT = s[0].copy(), s[-1].copy()
    s = (s - sT) * (s0 / (s0 - sT))
    return s ** 2


@SCHEDULER_REGISTER.register("cogvideox_xdpm")
class CogvideoxXDPMScheduler(SchedulerBase):
    num_train_timesteps = 1000

    def __init__(self, config):
        config.setdefault("infer_steps", config.get("num_inference_steps", 50))
        super().__init__(config)
        c, n_train = config, self.num_train_timesteps
        beta_start = float(c.get("scheduler_beta_start", 0.00085))
        beta_end = float(c.get("scheduler_beta_end", 0.012))
        snr_shift = float(c.get("scheduler_snr_shift_scale", 1.0))
        if c.get("scheduler_beta_schedule", "scaled_linear") == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n_train, dtype=np.float64) ** 2
        else:
            betas = np.linspace(beta_start, beta_end, n_train, dtype=np.float64)
        ac = np.cumprod(1.0 - betas)
        ac = ac / (snr_shift + (1 - snr_shift) * ac)
        if c.get("scheduler_rescale_betas_zero_snr", True):
            ac = rescale_zero_terminal_snr(ac)
        self.alphas_cumprod = ac
        self.final_alpha_cumprod = 1.0 if c.get("scheduler_set_alpha_to_one", True) else float(ac[0])
        self.prediction_type = c.get("scheduler_prediction_type", "v_prediction")
        if self.prediction_type not in PREDICTION_TYPES:
            raise ValueError(f"scheduler_prediction_type must be one of {PREDICTION_TYPES}, "
                             f"got {self.prediction_type!r}")
        spacing, n = c.get("timestep_spacing", "trailing"), self.infer_steps
        if spacing == "linspace":
            ts = np.linspace(0, n_train - 1, n).round()[::-1].astype(np.int64)
        elif spacing == "leading":
            ts = (np.arange(n) * (n_train // n)).round()[::-1].astype(np.int64) + int(c.get("steps_offset", 0))
        else:  # trailing
            ts = np.round(np.arange(n_train, 0, -n_train / n)).astype(np.int64) - 1
        self.timesteps = ts.astype(np.float32)
        self._ts_int = ts

    def prepare(self, target_shape, generator: torch.Generator, device=None) -> State:
        latents = self.init_latents(target_shape, generator, device)
        return {"latents": latents, "step_index": 0, "old_pred_x0": None}

    def _coefficients(self, i: int):
        """The step's fp32 scalars: (sqrt(a_t), sqrt(1 - a_t), mult1, mult2,
        mult3, mult4, mult_noise, use_first)."""
        ac = torch.from_numpy(self.alphas_cumprod.astype(np.float32))
        t = int(self._ts_int[i])
        prev_t = t - self.num_train_timesteps // self.infer_steps
        a_t = ac[t]
        a_prev = ac[prev_t] if prev_t >= 0 else torch.tensor(self.final_alpha_cumprod, dtype=torch.float32)
        a_back = ac[int(self._ts_int[max(i - 1, 0)])]
        lamb = torch.log(torch.sqrt(a_t / (1 - a_t)))
        lamb_next = torch.log(torch.sqrt(a_prev / (1 - a_prev)))
        h = lamb_next - lamb
        lamb_prev = torch.log(torch.sqrt(a_back / (1 - a_back)))
        r = (lamb - lamb_prev) / h if i > 0 else torch.tensor(1.0)
        mult1 = torch.sqrt((1 - a_prev) / (1 - a_t)) * torch.exp(-h)
        mult2 = torch.expm1(-2 * h) * torch.sqrt(a_prev)
        mult3 = 1 + 1 / (2 * r)
        mult4 = 1 / (2 * r)
        mult_noise = torch.sqrt(1 - a_prev) * torch.sqrt(1 - torch.exp(-2 * h))
        use_first = i == 0 or prev_t < 0
        return (float(torch.sqrt(a_t)), float(torch.sqrt(1 - a_t)), float(mult1), float(mult2), float(mult3),
                float(mult4), float(mult_noise), use_first)

    def step_post(self, state: State, noise_pred: torch.Tensor, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> State:
        """``noise`` replaces the generator's draw (tests inject the JAX
        package's ``jax.random`` draws)."""
        i = state["step_index"]
        sqrt_a, sqrt_b, mult1, mult2, mult3, mult4, mult_noise, use_first = self._coefficients(i)
        sample, pred = state["latents"].float(), noise_pred.float()
        if self.prediction_type == "epsilon":
            x0 = (sample - sqrt_b * pred) / sqrt_a
        elif self.prediction_type == "sample":
            x0 = pred
        else:  # v-prediction
            x0 = sqrt_a * sample - sqrt_b * pred
        if noise is None:
            noise = torch.randn(sample.shape, generator=generator, dtype=torch.float32, device=generator.device)
        noise = noise.to(device=sample.device, dtype=torch.float32)
        if use_first:
            latents = mult1 * sample - mult2 * x0 + mult_noise * noise
        else:
            denoised_d = mult3 * x0 - mult4 * state["old_pred_x0"]
            latents = mult1 * sample - mult2 * denoised_d + mult_noise * noise
        return {"latents": latents, "step_index": i + 1, "old_pred_x0": x0}
