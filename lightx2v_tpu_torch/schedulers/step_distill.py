"""LCM-style step-distilled scheduler, 4 steps, CFG-free (counterpart of
``lightx2v_tpu.schedulers.step_distill``). A fixed ``denoising_step_list``
indexes the shifted 1000-point sigma grid; each step predicts x0 from the
flow prediction and re-noises to the next sigma with fresh Gaussian noise
from an explicit ``torch.Generator`` (or noise passed in)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.registry import SCHEDULER_REGISTER
from .base import SchedulerBase, State


@SCHEDULER_REGISTER.register(["step_distill", "lcm"])
class WanStepDistillScheduler(SchedulerBase):
    num_train_timesteps = 1000

    def __init__(self, config):
        super().__init__(config)
        self.denoising_step_list = list(config.denoising_step_list)
        self.infer_steps = len(self.denoising_step_list)
        self.sample_shift = float(config.sample_shift)

    def prepare(self, target_shape, generator: torch.Generator, device=None) -> State:
        sig = np.linspace(1.0, 0.0, self.num_train_timesteps + 1)[:-1]
        sig = self.sample_shift * sig / (1 + (self.sample_shift - 1) * sig)
        timesteps = sig * self.num_train_timesteps
        idx = [self.num_train_timesteps - x for x in self.denoising_step_list]
        self.timesteps = timesteps[idx].astype(np.float32)
        self.sigmas = sig[idx].astype(np.float32)
        return {"latents": self.init_latents(target_shape, generator, device), "step_index": 0}

    def step_post(self, state: State, noise_pred: torch.Tensor, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> State:
        i = state["step_index"]
        lat = state["latents"]
        x0 = lat.float() - float(self.sigmas[i]) * noise_pred.float()
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, dtype=torch.float32,
                                device=generator.device).to(x0.device)
        sigma_next = float(self.sigmas[i + 1]) if i < self.infer_steps - 1 else 0.0
        latents = (1.0 - sigma_next) * x0 + sigma_next * noise.float()
        return {"latents": latents, "step_index": i + 1}
