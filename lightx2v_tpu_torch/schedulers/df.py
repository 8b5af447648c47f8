"""Diffusion-forcing (SkyReels-V2-DF) scheduler (counterpart of
``lightx2v_tpu.schedulers.df``).

``generate_timestep_matrix`` (numpy, the JAX package's exactly) gives the
per-frame timestep schedule: rows are denoise iterations, columns latent
frames, with an update mask and the valid windows. Every row runs the
UniPC update of one global step index over all frames at once and keeps the
new state only in the frames its mask row selects, as the JAX scheduler
does. A step index past the schedule (rows beyond ``infer_steps``, under
``ar_step``) reads the last entry of each table, as a JAX gather clamps.
Prefix frames (the previous segment's overlap) are re-noised every row by
``addnoise_condition`` / 1000 of fresh noise and fed at that timestep."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.registry import SCHEDULER_REGISTER
from .base import State
from .unipc import WanUniPCScheduler

CARRIES = ("latents", "m_prev", "m_prev2", "last_sample")


def generate_timestep_matrix(num_frames: int, base_num_frames: int, step_template: np.ndarray,
                             num_pre_ready: int = 0, casual_block_size: int = 1,
                             ar_step: int = 0) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int]]]:
    """(step_matrix (R, F) timesteps, update_mask (R, F) bool, the valid
    (start, end) frame window of each row)."""
    num_iterations = len(step_template) + 1
    nfb = num_frames // casual_block_size
    bfb = base_num_frames // casual_block_size
    if bfb < nfb and ar_step > 0:
        assert ar_step >= int(np.ceil(len(step_template) / bfb))
    tmpl = np.concatenate([[999], np.asarray(step_template, np.int64), [0]])
    pre_row = np.zeros(nfb, np.int64)
    if num_pre_ready > 0:
        pre_row[: num_pre_ready // casual_block_size] = num_iterations

    step_matrix, update_mask = [], []
    while not np.all(pre_row >= num_iterations - 1):
        new_row = np.zeros(nfb, np.int64)
        for i in range(nfb):
            if i == 0 or pre_row[i - 1] >= num_iterations - 1:
                new_row[i] = pre_row[i] + 1
            else:
                new_row[i] = new_row[i - 1] - ar_step
        new_row = np.clip(new_row, 0, num_iterations)
        update_mask.append((new_row != pre_row) & (new_row != num_iterations))
        step_matrix.append(tmpl[new_row])
        pre_row = new_row

    terminal_flag = bfb
    valid_interval = []
    for mask in update_mask:
        if terminal_flag < nfb and mask[terminal_flag]:
            terminal_flag += 1
        valid_interval.append((max(terminal_flag - bfb, 0), terminal_flag))

    sm, um = np.stack(step_matrix), np.stack(update_mask)
    if casual_block_size > 1:
        sm = np.repeat(sm, casual_block_size, axis=1)
        um = np.repeat(um, casual_block_size, axis=1)
        valid_interval = [(s * casual_block_size, e * casual_block_size) for s, e in valid_interval]
    return sm, um, valid_interval


def _clamped(table: np.ndarray, n: int) -> np.ndarray:
    """``table`` extended to length n with its last entry."""
    return np.concatenate([table, np.repeat(table[-1:], max(0, n - len(table)))])


@SCHEDULER_REGISTER.register("skyreels_v2_df")
class WanSkyreelsV2DFScheduler(WanUniPCScheduler):
    def __init__(self, config):
        super().__init__(config)
        self.addnoise_condition = float(config.get("addnoise_condition", 0))
        self.prefix_len = 0  # latent frames already decided (the overlap history)

    def prepare_df(self, target_shape, generator: torch.Generator, device=None, num_pre_ready: int = 0,
                   ar_step: int = 0, casual_block_size: int = 1, base_num_frames: Optional[int] = None,
                   prefix_latents: Optional[torch.Tensor] = None, latents: Optional[torch.Tensor] = None) -> State:
        """The segment's state: initial latents from ``generator`` (or
        ``latents``) with the first ``num_pre_ready`` frames set to
        ``prefix_latents``, zero UniPC carries, and the timestep matrix."""
        state = super().prepare(target_shape, generator, device)
        f = target_shape[1]
        self.step_matrix, self.update_mask, self.valid_interval = generate_timestep_matrix(
            f, base_num_frames or f, self.timesteps, num_pre_ready, casual_block_size, ar_step)
        self.prefix_len = num_pre_ready
        self.n_rows = self.step_matrix.shape[0]
        self.sigmas = _clamped(self.sigmas, self.n_rows + 1)
        self.pred_order = _clamped(self.pred_order, self.n_rows)
        self.corr_order = _clamped(self.corr_order, self.n_rows)
        lat = state["latents"] if latents is None else latents.to(state["latents"].device, torch.float32).clone()
        if prefix_latents is not None:
            lat[:, :num_pre_ready] = prefix_latents.to(lat.device, lat.dtype)
        zeros = torch.zeros_like(lat)
        return {"latents": lat, "step_index": 0, "m_prev": zeros, "m_prev2": zeros, "last_sample": zeros,
                "frame_step": torch.zeros(f, dtype=torch.int32, device=lat.device)}

    def df_step_pre(self, state: State, row_t, generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None):
        """(state, model latents bf16, per-frame timesteps (F,) fp32): the
        prefix frames re-noised in the state (``noise`` replaces the
        generator's draw) and fed at ``addnoise_condition``."""
        lat = state["latents"]
        t = torch.as_tensor(np.asarray(row_t), dtype=torch.float32).to(lat.device)
        p = self.prefix_len
        if self.addnoise_condition > 0 and p > 0:
            nf = 0.001 * self.addnoise_condition
            if noise is None:
                noise = torch.randn(lat[:, :p].shape, generator=generator, dtype=torch.float32,
                                    device=generator.device)
            lat = lat.clone()
            lat[:, :p] = lat[:, :p] * (1.0 - nf) + noise.to(lat.device) * nf
            state = dict(state, latents=lat)
            t[:p] = self.addnoise_condition
        return state, lat.to(torch.bfloat16), t

    def df_step_post(self, state: State, noise_pred: torch.Tensor, mask_row) -> State:
        """The UniPC update at the state's global step over every frame, kept
        where ``mask_row`` (F,) is set."""
        i = int(state["step_index"])
        new = self.step_post({k: state[k] for k in CARRIES} | {"step_index": i, "m_prev3": state["m_prev2"]},
                             noise_pred)
        mask = torch.as_tensor(np.asarray(mask_row), dtype=torch.bool).to(noise_pred.device)
        m = mask[None, :, None, None]
        out = {k: torch.where(m, new[k], state[k]) for k in CARRIES}
        out["frame_step"] = state["frame_step"] + mask.to(torch.int32)
        out["step_index"] = i + 1
        return out

    def num_steps(self) -> int:
        return self.n_rows
