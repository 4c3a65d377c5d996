"""CogVideoX diffusion schedules (DDIM and SDE-DPM-Solver++(2M)) in torch.

Port of `bindyouravatar_tpu/ops/scheduler.py`.  Tables are computed in
float64 numpy and stored as float32, as there.  The denoise loop here is a
host loop, so timesteps arrive as Python ints and each step's coefficients
are float32 scalars computed on the host with the JAX version's formulas;
the noise of a stochastic step comes in as an argument.  The training
functions (`add_noise`, `get_velocity`, `loss_weight`) take a timestep
tensor and index the table on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SchedulerConfig


def _compute_alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    else:
        raise ValueError(f"unknown beta schedule {cfg.beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    s = cfg.snr_shift_scale
    alphas_cumprod = alphas_cumprod / (s + (1.0 - s) * alphas_cumprod)
    if cfg.rescale_betas_zero_snr:
        ab_sqrt = np.sqrt(alphas_cumprod)
        a0, aT = ab_sqrt[0], ab_sqrt[-1]
        ab_sqrt = (ab_sqrt - aT) * (a0 / (a0 - aT))
        alphas_cumprod = ab_sqrt ** 2
    return alphas_cumprod


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Immutable schedule tables. `alphas_cumprod`: [num_train_timesteps] fp32."""
    config: SchedulerConfig
    alphas_cumprod: np.ndarray
    final_alpha_cumprod: float

    @classmethod
    def create(cls, config: SchedulerConfig = SchedulerConfig()) -> "Schedule":
        ac = _compute_alphas_cumprod(config)
        final = 1.0 if config.set_alpha_to_one else float(ac[0])
        return cls(config=config, alphas_cumprod=ac.astype(np.float32),
                   final_alpha_cumprod=final)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending int timestep sequence."""
        n = self.config.num_train_timesteps
        spacing = self.config.timestep_spacing
        if spacing == "trailing":
            step = n / num_inference_steps
            ts = np.arange(n, 0, -step).round().astype(np.int64) - 1
        elif spacing == "linspace":
            ts = np.linspace(0, n - 1, num_inference_steps).round().astype(np.int64)[::-1]
        elif spacing == "leading":
            step = n // num_inference_steps
            ts = (np.arange(num_inference_steps) * step).round().astype(np.int64)[::-1]
        else:
            raise ValueError(spacing)
        return ts.copy()

    def _alpha(self, t: int) -> np.float32:
        """alphas_cumprod[t]; a negative t gives final_alpha_cumprod."""
        if t < 0:
            return np.float32(self.final_alpha_cumprod)
        return self.alphas_cumprod[min(int(t), self.config.num_train_timesteps - 1)]

    # --------------------------- training ----------------------------- #
    def _alpha_t(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """alphas_cumprod[t] for an int tensor t [B] (negative: the final
        alpha), fp32 on t's device, shaped [B, 1, ...] to `ndim` dims."""
        table = torch.from_numpy(self.alphas_cumprod).to(t.device)
        a = table[t.long().clamp(0, self.config.num_train_timesteps - 1)]
        a = torch.where(t < 0, torch.full_like(a, self.final_alpha_cumprod), a)
        return a.reshape(a.shape + (1,) * (ndim - a.ndim))

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """sqrt(a_t) x + sqrt(1 - a_t) noise, in fp32, returned in x's dtype."""
        a = self._alpha_t(t, sample.ndim)
        return (torch.sqrt(a) * sample.float()
                + torch.sqrt(1.0 - a) * noise.float()).to(sample.dtype)

    def get_velocity(self, model_output_or_noise: torch.Tensor, sample: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
        """sqrt(a_t) * first - sqrt(1 - a_t) * sample, fp32 (the v-prediction
        transform; the JAX package's argument order)."""
        a = self._alpha_t(t, sample.ndim)
        return torch.sqrt(a) * model_output_or_noise.float() - torch.sqrt(1.0 - a) * sample.float()

    def loss_weight(self, t: torch.Tensor) -> torch.Tensor:
        """The SNR-style weight 1 / (1 - a_t), fp32 [B]."""
        return 1.0 / (1.0 - self._alpha_t(t, 1))

    # --------------------------- inference ---------------------------- #
    def ddim_step(self, model_output: torch.Tensor, t: int, prev_t: int,
                  sample: torch.Tensor) -> torch.Tensor:
        """CogVideoX DDIM update (a_t/b_t form, eta=0), fp32."""
        sample, model_output = sample.float(), model_output.float()
        a_t_, a_prev = self._alpha(t), self._alpha(prev_t)
        x0 = float(np.sqrt(a_t_)) * sample - float(np.sqrt(1 - a_t_)) * model_output
        a_t = np.sqrt((1 - a_prev) / (1 - a_t_))
        b_t = np.sqrt(a_prev) - np.sqrt(a_t_) * a_t
        return float(a_t) * sample + float(b_t) * x0

    def dpm_step_scan(
        self,
        model_output: torch.Tensor,
        old_pred: torch.Tensor,
        t: int,
        t_back: int,
        prev_t: int,
        sample: torch.Tensor,
        second_order: bool,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """SDE-DPM-Solver++(2M) step -> (prev_sample, pred_original_sample).

        `second_order` selects the multistep branch (False on step 0); the
        last step (prev_t < 0) is first order, as in the JAX version."""
        sample, model_output = sample.float(), model_output.float()
        a_t, a_prev = self._alpha(t), self._alpha(prev_t)
        x0 = float(np.sqrt(a_t)) * sample - float(np.sqrt(1 - a_t)) * model_output
        # the zero-terminal-SNR end of the table (alpha 0) and the final
        # alpha 1 give log(0) = -inf / log(inf); the coefficients stay finite
        with np.errstate(divide="ignore"):
            lamb = np.log(np.sqrt(a_t / (1 - a_t)))
            lamb_next = np.log(np.sqrt(a_prev / (np.float32(1) - a_prev)))
            a_back = self._alpha(t_back)
            lamb_prev = np.log(np.sqrt(a_back / (1 - a_back)))
        h = lamb_next - lamb
        mult1 = np.sqrt((1 - a_prev) / (1 - a_t)) * np.exp(-h)
        mult2 = np.expm1(-2 * h) * np.sqrt(a_prev)
        mult_noise = np.sqrt(1 - a_prev) * np.sqrt(1 - np.exp(-2 * h))
        denoised = x0
        if second_order and prev_t >= 0:
            r = (lamb - lamb_prev) / h
            denoised = (float(1 + 1 / (2 * r)) * x0
                        - float(1 / (2 * r)) * old_pred.float())
        prev = float(mult1) * sample - float(mult2) * denoised
        if noise is not None:
            prev = prev + float(mult_noise) * noise.float()
        return prev, x0
