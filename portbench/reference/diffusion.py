"""The cosine schedule of the multinomial diffusion and the scalars of one
reverse step (frozen copies of ``mars5_tts_torch/diffusion/multinomial.py:22-30``
and ``:59-86``, and of ``ops/kernels/diffusion_tail.py:130-141``), and the
steps the guidance interval gives CFG."""

from __future__ import annotations

import numpy as np
import torch

MIN_LOG_ARG = 1e-7


def cosine_alphas(timesteps: int, s: float = 0.008) -> np.ndarray:
    x = torch.linspace(0, timesteps, timesteps + 1)
    ac = torch.cos(((x / timesteps) + s) / (1 + s) * torch.pi * 0.5) ** 2
    ac = ac / ac[0]
    return torch.sqrt(torch.clamp(ac[1:] / ac[:-1], 0.001, 1.0)).numpy()


class Tables:
    """The schedule's log tables (float32) for ``num_classes`` classes."""

    def __init__(self, num_classes: int, timesteps: int):
        la = np.log(cosine_alphas(timesteps).astype(np.float64))
        lca = np.cumsum(la)
        f32 = lambda a: torch.tensor(a.astype(np.float32))
        self.log_alpha = f32(la)
        self.log_1_min_alpha = f32(np.log(np.clip(1 - np.exp(la), 1e-30, None)))
        self.log_cumprod_alpha = f32(lca)
        self.log_1_min_cumprod_alpha = f32(np.log(np.clip(1 - np.exp(lca), 1e-30, None)))
        self.log_k = float(np.log(num_classes))
        self.cold_log = float(torch.log(torch.tensor(MIN_LOG_ARG, dtype=torch.float32)))

    def scalars(self, t: int):
        """(a, b1, hot, cold) of reverse step t, as floats."""
        tm1 = max(t - 1, 0)
        a = self.log_cumprod_alpha[tm1]
        b1 = self.log_1_min_cumprod_alpha[tm1] - self.log_k
        x, y = self.log_alpha[t], self.log_1_min_alpha[t] - self.log_k
        hot = torch.logaddexp(x, y)
        cold = torch.logaddexp(self.cold_log + x, y)
        return float(a), float(b1), float(hot), float(cold)


def guided(t: int, T: int, interval) -> bool:
    """Whether reverse step t of T runs CFG under the guidance interval
    ``(lo, hi)``: ``round(lo T) <= t < round(hi T)``, every step for (0, 1)
    (``mars5_tts_torch/diffusion/engine.py:203-212``)."""
    lo, hi = (float(v) for v in interval)
    if (lo, hi) == (0.0, 1.0):
        return True
    return int(round(lo * T)) <= t < int(round(hi * T))
