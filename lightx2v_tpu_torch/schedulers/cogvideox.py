"""CogVideoX XDPM scheduler (counterpart of
``lightx2v_tpu.schedulers.cogvideox``): scaled-linear betas, the
zero-terminal-SNR rescale, trailing timestep spacing, v-prediction, and a
DPM-solver++(2M)-SDE update whose second order corrects with the previous
x0 prediction. The schedule is CogVideoX1.5-5B's, fixed: the JAX
scheduler's other betas, SNR shifts, beta schedules, spacings, prediction
types and final alphas, which no config in the repo selects, raise.

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

BETA_START, BETA_END = 0.00085, 0.012
# the one value of each schedule key that is ported (CogVideoX1.5-5B's); any other raises
_FIXED = (("scheduler_beta_start", BETA_START), ("scheduler_beta_end", BETA_END),
          ("scheduler_snr_shift_scale", 1.0), ("scheduler_beta_schedule", "scaled_linear"),
          ("timestep_spacing", "trailing"), ("scheduler_prediction_type", "v_prediction"),
          ("scheduler_rescale_betas_zero_snr", True), ("scheduler_set_alpha_to_one", True))


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
        for key, value in _FIXED:
            if config.get(key, value) != value:
                raise NotImplementedError(f"XDPM {key}={config[key]!r} is not ported yet (ROADMAP.md, Queue 1 item 17)")
        betas = np.linspace(BETA_START ** 0.5, BETA_END ** 0.5, self.num_train_timesteps, dtype=np.float64) ** 2
        self.alphas_cumprod = rescale_zero_terminal_snr(np.cumprod(1.0 - betas))
        self.final_alpha_cumprod = 1.0
        ratio = self.num_train_timesteps / self.infer_steps
        ts = np.round(np.arange(self.num_train_timesteps, 0, -ratio)).astype(np.int64) - 1  # trailing
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
        sample = state["latents"].float()
        x0 = sqrt_a * sample - sqrt_b * noise_pred.float()  # v-prediction
        if noise is None:
            noise = torch.randn(sample.shape, generator=generator, dtype=torch.float32, device=generator.device)
        noise = noise.to(device=sample.device, dtype=torch.float32)
        if use_first:
            latents = mult1 * sample - mult2 * x0 + mult_noise * noise
        else:
            denoised_d = mult3 * x0 - mult4 * state["old_pred_x0"]
            latents = mult1 * sample - mult2 * denoised_d + mult_noise * noise
        return {"latents": latents, "step_index": i + 1, "old_pred_x0": x0}
