"""Flow-match Euler scheduler (counterpart of
``lightx2v_tpu.schedulers.euler``), HunyuanVideo's: sigmas linspace(1, 0,
n + 1) shifted to shift*s / (1 + (shift - 1)*s), timesteps sigma * 1000,
and ``latents + pred * (sigma[i+1] - sigma[i])`` in fp32."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.registry import SCHEDULER_REGISTER
from .base import SchedulerBase, State


@SCHEDULER_REGISTER.register(["euler", "flow_match_euler"])
class FlowMatchEulerScheduler(SchedulerBase):
    num_train_timesteps = 1000

    def __init__(self, config):
        super().__init__(config)
        self.sample_shift = float(config.get("sample_shift", 7.0))

    def prepare(self, target_shape, generator: torch.Generator, device=None) -> State:
        sig = np.linspace(1.0, 0.0, self.infer_steps + 1)
        sig = self.sample_shift * sig / (1 + (self.sample_shift - 1) * sig)
        self.sigmas = sig.astype(np.float32)
        self.timesteps = (sig[:-1] * self.num_train_timesteps).astype(np.float32)
        return {"latents": self.init_latents(target_shape, generator, device), "step_index": 0}

    def step_post(self, state: State, noise_pred: torch.Tensor, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> State:
        i = state["step_index"]
        dt = float(self.sigmas[i + 1] - self.sigmas[i])  # fp32 difference; negative: toward x0
        return {"latents": state["latents"].float() + noise_pred.float() * dt, "step_index": i + 1}
