"""Scheduler protocol (counterpart of ``lightx2v_tpu.schedulers.base``).

``prepare`` computes the schedule (numpy, as in the JAX package) and draws
the initial latents from an explicit ``torch.Generator``; ``step_pre`` /
``step_post`` advance a plain-dict state. Passing a CPU generator seeded
with the run seed reproduces the JAX package's ``latent_init: "torch"``
stream bit-exactly."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

State = Dict[str, Any]


class SchedulerBase:
    def __init__(self, config):
        self.config = config
        self.infer_steps = int(config.infer_steps)
        self.timesteps: Optional[np.ndarray] = None
        self.sigmas: Optional[np.ndarray] = None

    def prepare(self, target_shape, generator: torch.Generator, device=None) -> State:
        raise NotImplementedError

    def init_latents(self, target_shape, generator: torch.Generator, device=None) -> torch.Tensor:
        """Seeded initial noise, drawn on the generator's device."""
        lat = torch.randn(tuple(int(s) for s in target_shape), generator=generator,
                          dtype=torch.float32, device=generator.device)
        return lat.to(device) if device is not None else lat

    def step_pre(self, state: State) -> Tuple[torch.Tensor, torch.Tensor]:
        """(model input latents bf16, timestep (1,) fp32) for this step."""
        lat = state["latents"]
        t = torch.tensor([float(self.timesteps[state["step_index"]])], dtype=torch.float32, device=lat.device)
        return lat.to(torch.bfloat16), t

    def step_post(self, state: State, noise_pred: torch.Tensor, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> State:
        raise NotImplementedError

    def num_steps(self) -> int:
        return self.infer_steps
