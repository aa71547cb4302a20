"""Multinomial diffusion in log space
(counterpart of ``mars5_tts_tpu/diffusion/multinomial.py``).

The cosine schedule is built in float64 on the host, exactly as the JAX
package builds it, and kept as f32 tables on the device. In inference t is a
Python int (every row of a trajectory shares one t); the training half
(``q_posterior``, ``p_pred``, ``q_sample``, the variational bound
``compute_Lt`` and ``kl_prior``) takes t as a (bs,) integer tensor, one
timestep a row, and its random draws as ``uniform`` tensors, as the JAX
package does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from ..ops.sampling import MIN_LOG_ARG, gumbel_argmax


def cosine_alpha_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """sqrt of the clipped cosine alpha ratios, computed in torch f32 on the CPU
    (the JAX package computes the same table the same way)."""
    x = torch.linspace(0, timesteps, timesteps + 1)
    alphas_cumprod = torch.cos(((x / timesteps) + s) / (1 + s) * torch.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    alphas = torch.clamp(alphas_cumprod[1:] / alphas_cumprod[:-1], 0.001, 1.0)
    return torch.sqrt(alphas).numpy()


def index_to_log_onehot(x, num_classes: int, dtype=torch.float32):
    """Indices (bs, ...) -> clamped log one-hot (bs, ..., K)."""
    onehot = F.one_hot(x.long(), num_classes).to(dtype)
    return torch.log(torch.clamp(onehot, min=MIN_LOG_ARG))


def sum_except_batch(x, num_dims: int = 1):
    return x.reshape(*x.shape[:num_dims], -1).sum(-1)


def _at(table, t, ndim: int):
    """``table[t]``: a scalar for an int t, (bs, 1, ..., 1) of ``ndim`` dims
    for a (bs,) tensor t (one timestep a row)."""
    out = table[t]
    return out if isinstance(t, int) else out.reshape(out.shape[0], *([1] * (ndim - 1)))


def log_add_exp(a, b):
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def log_sample_categorical(logprobs, uniform):
    """Gumbel-max draw; ``uniform`` is shaped like ``logprobs``."""
    return gumbel_argmax(logprobs, uniform)


class MultinomialDiffusion:
    """Schedule tables and the categorical transitions of inference."""

    def __init__(self, num_classes: int, timesteps: int = 100,
                 diffusion_s: float = 0.008, device=None):
        self.num_classes = num_classes
        self.num_timesteps = timesteps
        alphas = cosine_alpha_schedule(timesteps, diffusion_s).astype(np.float64)
        log_alpha = np.log(alphas)
        log_cumprod_alpha = np.cumsum(log_alpha)
        log_1_min_alpha = np.log(np.clip(1 - np.exp(log_alpha), 1e-30, None))
        log_1_min_cumprod_alpha = np.log(np.clip(1 - np.exp(log_cumprod_alpha), 1e-30, None))

        def f32(a):
            return torch.as_tensor(a.astype(np.float32), device=device)

        self.log_alpha = f32(log_alpha)
        self.log_1_min_alpha = f32(log_1_min_alpha)
        self.log_cumprod_alpha = f32(log_cumprod_alpha)
        self.log_1_min_cumprod_alpha = f32(log_1_min_cumprod_alpha)
        self.log_num_classes = float(np.log(num_classes))
        self.cold_log = torch.log(torch.tensor(MIN_LOG_ARG, dtype=torch.float32,
                                               device=device))

    # the two log-prob values of a transition from a one-hot input
    def _hot_cold(self, a, b):
        return log_add_exp(a, b), log_add_exp(self.cold_log + a, b)

    def _two_scalar_select(self, x_idx, a, b):
        """(…, K) grid: ``hot`` at x_idx, ``cold`` elsewhere; a/b broadcast to
        x_idx.shape."""
        hot, cold = self._hot_cold(a, b)
        onehot = F.one_hot(x_idx, self.num_classes).bool()
        return torch.where(onehot, hot[..., None], cold[..., None])

    def _scaled_ab(self, seq_len: int, t: int, c: float, jump_len: int, nd: int):
        """Kevin-scaled per-position (a, b): the sigmoid front along axis 1."""
        xax = torch.arange(seq_len, dtype=torch.float32, device=self.log_alpha.device)
        aa = seq_len * (torch.tensor(c, dtype=torch.float32, device=xax.device) / jump_len)
        sig = 1.0 / (1.0 + torch.exp(-(xax - aa + 20.0) / 8.0))
        shape = (1, seq_len) + (1,) * (nd - 2)
        a = torch.clamp(torch.log(1.0 / sig).reshape(shape) + self.log_alpha[t], max=0.0)
        b = torch.log(sig).reshape(shape) + self.log_1_min_alpha[t] - self.log_num_classes
        return a, b

    def q_pred(self, log_x_start, t):
        """log q(x_t | x_0) for a dense (…, K) log x_0; t an int or (bs,)."""
        nd = log_x_start.ndim
        return log_add_exp(log_x_start + _at(self.log_cumprod_alpha, t, nd),
                           _at(self.log_1_min_cumprod_alpha, t, nd) - self.log_num_classes)

    def q_pred_one_timestep(self, log_x_t, t):
        """log q(x_t | x_{t-1}) for a dense (…, K) log x_{t-1}."""
        nd = log_x_t.ndim
        return log_add_exp(log_x_t + _at(self.log_alpha, t, nd),
                           _at(self.log_1_min_alpha, t, nd) - self.log_num_classes)

    def q_pred_indexed(self, x_idx, t: int):
        return self._two_scalar_select(
            x_idx, self.log_cumprod_alpha[t],
            self.log_1_min_cumprod_alpha[t] - self.log_num_classes)

    def q_pred_one_timestep_indexed(self, x_idx, t: int):
        return self._two_scalar_select(
            x_idx, self.log_alpha[t], self.log_1_min_alpha[t] - self.log_num_classes)

    def q_pred_one_timestep_scaled_indexed(self, x_idx, t: int, c: float, jump_len: int):
        a, b = self._scaled_ab(x_idx.shape[1], t, c, jump_len, x_idx.ndim)
        return self._two_scalar_select(x_idx, a, b)

    def q_posterior_indexed(self, log_x_start, x_t_idx, t: int, normalize: bool = True):
        """log q(x_{t-1} | x_t, x_0) with x_t as indices; ``normalize=False``
        skips the logsumexp (Gumbel-max is shift-invariant)."""
        log_ev = log_x_start if t == 0 else self.q_pred(log_x_start, t - 1)
        unnormed = log_ev + self.q_pred_one_timestep_indexed(x_t_idx, t)
        if not normalize:
            return unnormed
        return unnormed - torch.logsumexp(unnormed, dim=-1, keepdim=True)

    # Exact draws from a one-hot transition with two uniforms per position:
    # keep the current class with p_hot = 1 / (1 + (K-1) exp(cold - hot)),
    # else take one of the other K-1 classes uniformly.
    def _sample_two_value(self, x_idx, a, b, u):
        K = self.num_classes
        hot, cold = self._hot_cold(a, b)
        p_hot = 1.0 / (1.0 + (K - 1) * torch.exp(cold - hot))
        other = torch.clamp((u[..., 1] * (K - 1)).long(), max=K - 2)
        other = other + (other >= x_idx).long()
        return torch.where(u[..., 0] < p_hot, x_idx, other)

    def q_pred_indexed_sample(self, x_idx, t: int, u):
        return self._sample_two_value(
            x_idx, self.log_cumprod_alpha[t],
            self.log_1_min_cumprod_alpha[t] - self.log_num_classes, u)

    def q_pred_one_timestep_indexed_sample(self, x_idx, t: int, u):
        return self._sample_two_value(
            x_idx, self.log_alpha[t], self.log_1_min_alpha[t] - self.log_num_classes, u)

    def q_pred_one_timestep_scaled_indexed_sample(self, x_idx, t: int, c: float,
                                                  jump_len: int, u):
        a, b = self._scaled_ab(x_idx.shape[1], t, c, jump_len, x_idx.ndim)
        return self._sample_two_value(x_idx, a, b, u)

    # -- training (reference diffuser.py:238-289); t is (bs,), one a row ------
    def q_posterior(self, log_x_start, log_x_t, t):
        """log q(x_{t-1} | x_t, x_0) via Bayes, with the t = 0 one-hot
        override, normalised."""
        log_ev = self.q_pred(log_x_start, torch.clamp(t - 1, min=0))
        t_b = t.reshape(-1, *([1] * (log_x_start.ndim - 1)))
        log_ev = torch.where(t_b == 0, log_x_start, log_ev)
        unnormed = log_ev + self.q_pred_one_timestep(log_x_t, t)
        return unnormed - torch.logsumexp(unnormed, dim=-1, keepdim=True)

    def p_pred(self, log_x_t, t, log_x0_pred):
        """log p(x_{t-1} | x_t) = q_posterior with the model's x0."""
        return self.q_posterior(log_x0_pred, log_x_t, t)

    def q_sample(self, log_x_start, t, uniform):
        """x_t ~ q(x_t | x_0): a Gumbel-max draw on ``uniform`` (shaped like
        ``log_x_start``)."""
        return log_sample_categorical(self.q_pred(log_x_start, t), uniform)

    @staticmethod
    def multinomial_kl(log_prob1, log_prob2, dim: int = -1):
        return (torch.exp(log_prob1) * (log_prob1 - log_prob2)).sum(dim=dim)

    def compute_Lt(self, log_x_start, log_x_t, log_x0_pred, t, include_kl_prior: bool = True):
        """The variational bound term a row: KL (or the t = 0 decoder NLL),
        and with ``include_kl_prior`` the reference's ``kl + kl_prior``,
        which overwrites the t = 0 blend (diffuser.py:267-270), as the JAX
        package keeps it."""
        log_true_prob = self.q_posterior(log_x_start, log_x_t, t)
        log_model_prob = self.p_pred(log_x_t, t, log_x0_pred)
        kl = sum_except_batch(self.multinomial_kl(log_true_prob, log_model_prob))
        decoder_nll = sum_except_batch(-(torch.exp(log_x_start) * log_model_prob).sum(-1))
        mask = (t == 0).to(kl.dtype)
        loss = mask * decoder_nll + (1.0 - mask) * kl
        if include_kl_prior:
            loss = kl + self.kl_prior(log_x_start)
        return loss

    def kl_prior(self, log_x_start):
        """KL(q(x_T | x_0) || uniform) a row."""
        t = torch.full((log_x_start.shape[0],), self.num_timesteps - 1, dtype=torch.long,
                       device=log_x_start.device)
        log_qxT = self.q_pred(log_x_start, t)
        log_uniform = torch.full_like(log_qxT, -self.log_num_classes)
        return sum_except_batch(self.multinomial_kl(log_qxT, log_uniform))
